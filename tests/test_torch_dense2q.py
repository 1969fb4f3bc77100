"""Dense two-qubit (4x4) gates on the port's fused f32 kernel: the kind
``U4`` of ``ops/fused_sv.py`` (its plain version against
``statevec.apply_matrix``), the planner's choice of engine (the f32 pair
and flat paths take it; the df64 kernel and a sharded pass on a global
bit do not, and still match), the Qiskit plugin's qubit order for
``unitary``, a Quantum Volume circuit through ``RocQuantumBackend.run``
against the benchmark's float64 dense reference and against the JAX
package's own Qiskit backend on the same circuits, and the plan-cache and
dense-gate counters and spans. The kernel itself runs on the card only
(``tests/test_torch_gpu.py``); here the CPU runs its plain version, and
``tests/test_torch_fused_sv_layout.py`` emulates its records."""

import numpy as np
import pytest
import torch

from qiskit import QuantumCircuit

from portbench.circuits import quantum_volume
from portbench.reference import dense as ref_dense
from rocquantum_tpu.integrations import qiskit_provider as jax_qiskit
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp
from rocquantum_tpu_torch.compiler.passes import PallasBlock
from rocquantum_tpu_torch.integrations.qiskit_provider import \
    RocQuantumBackend
from rocquantum_tpu_torch.ops import fused_df64, fused_sv
from rocquantum_tpu_torch.ops import statevec as sv
from rocquantum_tpu_torch.parallel import make_mesh, sharded, state_sharding
from rocquantum_tpu_torch.simulator import QuantumSimulator
from rocquantum_tpu_torch.utils import profiling

CPU = torch.device("cpu")
AMP_TOL = 1e-5  # of max|amp|, single precision against complex128


def _haar(rng, count):
    z = rng.normal(size=(count, 4, 4)) + 1j * rng.normal(size=(count, 4, 4))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    return q * (d / np.abs(d))[:, None, :]


def _random_state(rng, n):
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return torch.from_numpy(v / np.linalg.norm(v))


def _exact(state, gates):
    """``[(u, (a, b))]`` applied in complex128 by ``statevec``."""
    for u, q in gates:
        state = sv.apply_matrix(state, torch.as_tensor(u), list(q))
    return state


def _close(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    err = float((got.to(torch.complex128) - want).abs().max())
    assert err <= AMP_TOL * float(want.abs().max()), err


def _pairs(rng, n, where, count):
    """Qubit pairs of one pass: both in the window (bits < 10), both on
    pair bits (one pair of the three high bits the complex carry takes),
    or one of each; both orders."""
    high = sorted(rng.choice(np.arange(10, n), 3, replace=False).tolist())
    out = []
    for k in range(count):
        if where == "window":
            a, b = rng.choice(10, 2, replace=False)
        elif where == "pair":
            a, b = rng.choice(high, 2, replace=False)
        else:
            a, b = int(rng.integers(10)), int(rng.choice(high))
            if k % 2:
                a, b = b, a
        out.append((int(a), int(b)))
    return out, tuple(q for q in high if any(q in p for p in out))


@pytest.mark.parametrize("where", ["window", "pair", "mixed"])
@pytest.mark.parametrize("n", [15, 16, 18])
def test_plain_dense_pass_equals_apply_matrix(n, where):
    """A pass of U4 specs among U, CNOT and D2 specs, through
    ``apply_fused_layer`` on CPU planes (its plain version), lands on
    ``statevec.apply_matrix`` gate by gate."""
    rng = np.random.default_rng(n * 3 + len(where))
    pairs, pair_bits = _pairs(rng, n, where, 6)
    us = _haar(rng, len(pairs))
    specs, gm, dm, gates = [], [], [], []
    x = np.array([[0, 1], [1, 0]], complex)
    for k, (u, (a, b)) in enumerate(zip(us, pairs)):
        specs.append(("U4", a, b))
        gm.append(np.zeros((2, 2, 2)))
        dm.append(np.stack([u.real, u.imag], -1))
        gates.append((u, (a, b)))
        # a CNOT on the pair's qubits between the dense gates
        specs.append(("CNOT", b, a))
        gm.append(np.zeros((2, 2, 2)))
        dm.append(np.zeros((4, 4, 2)))
        # index bit 0 is a, bit 1 (the kron's left factor) the control b
        gates.append((np.kron(np.diag([1, 0]), np.eye(2))
                      + np.kron(np.diag([0, 1]), x), (a, b)))
    psi = _random_state(rng, n)
    re, im = (p.to(torch.float32).contiguous() for p in (psi.real,
                                                        psi.imag))
    got_re, got_im = fused_sv.apply_fused_layer(
        re, im, specs, np.asarray(gm, np.float32), pair_bits=pair_bits,
        dense_mats=np.asarray(dm, np.float32))
    _close(torch.complex(got_re, got_im), _exact(psi, gates))


def _qv_ops(rng, n, layers):
    ops, gates = [], []
    for _ in range(layers):
        perm = rng.permutation(n)
        for u, w in zip(_haar(rng, n // 2), range(n // 2)):
            q = (int(perm[2 * w]), int(perm[2 * w + 1]))
            ops.append(GateOp("UNITARY", q, (), (), u))
            gates.append((u, q))
    return ops, gates


def _kernel_kinds(items):
    return [interpreter._classify_spec(op)[0] for it in items
            if isinstance(it, PallasBlock) for op in it.ops]


def test_flat_and_pair_paths_send_dense_gates_to_the_kernel():
    """compile_ir (the flat path of QuantumSimulator) and
    compile_pair32_ir plan every dense 4x4 of a QV circuit onto the f32
    kernel's U4 and match the exact state; the counters say so."""
    rng = np.random.default_rng(11)
    n = 16
    ops, gates = _qv_ops(rng, n, 4)
    items = interpreter.plan_items(ops, n)
    assert _kernel_kinds(items).count("U4") == len(ops)
    want = _exact(sv.init_state(n, dtype=torch.complex128, device=CPU),
                  gates)
    before = dict(profiling.COUNTERS)
    got = interpreter.compile_ir(CircuitIR(n, ops))(
        sv.init_state(n, device=CPU))
    _close(got, want)
    assert profiling.COUNTERS["dense2q_gates"] - before["dense2q_gates"] \
        == len(ops)
    assert profiling.COUNTERS["dense2q_kernel_gates"] - \
        before["dense2q_kernel_gates"] == len(ops)
    re, im = interpreter.compile_pair32_ir(CircuitIR(n, ops))(
        (None, None), None, device=CPU)
    _close(torch.complex(re, im), want)


def test_dense_gates_below_the_kernel_size_stay_plain():
    """Below the kernel's smallest state a dense gate runs in plain torch
    and still counts as a dense gate, none of them the kernel's."""
    rng = np.random.default_rng(12)
    n = 8
    ops, gates = _qv_ops(rng, n, 3)
    before = dict(profiling.COUNTERS)
    got = interpreter.compile_ir(CircuitIR(n, ops))(
        sv.init_state(n, device=CPU))
    _close(got, _exact(sv.init_state(n, dtype=torch.complex128,
                                     device=CPU), gates))
    assert profiling.COUNTERS["dense2q_gates"] - before["dense2q_gates"] \
        == len(ops)
    assert profiling.COUNTERS["dense2q_kernel_gates"] == \
        before["dense2q_kernel_gates"]


def test_df64_keeps_dense_gates_off_its_kernel():
    """The df64 engine's plan has no U4 in its kernel blocks, and its
    state matches the exact complex128 one."""
    rng = np.random.default_rng(13)
    n = 15
    ops, gates = _qv_ops(rng, n, 2)
    ry = [GateOp("RY", (q,), (), (0.3 + 0.1 * q,)) for q in range(n)]
    assert "U4" not in _kernel_kinds(
        interpreter.plan_items(ry + ops, n, kernel=fused_df64))
    assert "U4" in _kernel_kinds(interpreter.plan_items(ry + ops, n))
    re, im = interpreter.compile_df64_fused_ir(CircuitIR(n, ry + ops))(
        (interpreter.init_real64(n, CPU), None), None)
    want = interpreter.run_ops_exact(
        sv.init_state(n, dtype=torch.complex128, device=CPU), ry + ops)
    assert float((torch.complex(re, im) - want).abs().max()) < 1e-12


def test_sharded_global_bits_keep_dense_gates_off_the_kernel():
    """On 4 virtual shards (2 global bits) a dense gate on local bits
    rides the kernel of each shard's rows; one on a global bit is
    relabelled in and out by the sharded engine; the gathered state
    matches the exact one."""
    rng = np.random.default_rng(14)
    n = 17
    mesh = make_mesh(4, devices=[CPU] * 4)
    n_loc = n - 2
    ops, gates = _qv_ops(rng, n, 2)
    assert any(max(op.targets) >= n_loc for op in ops)
    local_items = interpreter.plan_items(
        [op for op in ops if max(op.targets) < n_loc], n_loc)
    assert "U4" in _kernel_kinds(local_items)
    psi = sv.init_state(n, device=CPU)
    out = interpreter.compile_ir(CircuitIR(n, ops),
                                 sharding=state_sharding(mesh))(
        sharded.shard_state(psi, mesh))
    (got,) = sharded.gather(out)
    _close(got, _exact(sv.init_state(n, dtype=torch.complex128,
                                     device=CPU), gates))


@pytest.mark.parametrize("n", [4, 16])
def test_qiskit_unitary_takes_its_first_qubit_as_the_low_bit(n):
    """``qc.unitary(U, [a, b])`` of a U that is not symmetric under the
    swap of its qubits: the backend's state is U on (a, b) with a the low
    bit of U's index (Qiskit's order), not on (b, a); below and on the
    kernel path."""
    rng = np.random.default_rng(15)
    u = _haar(rng, 1)[0]
    p = [0, 2, 1, 3]
    assert np.abs(u - u[np.ix_(p, p)]).max() > 0.1
    a, b = 1, n - 1
    qc = QuantumCircuit(n, n)
    for q in range(n):
        qc.ry(0.2 + 0.15 * q, q)
    qc.unitary(u, [a, b])
    backend = RocQuantumBackend(device="cpu")
    backend.run(qc, shots=8)
    got = backend.get_statevector()
    start = sv.init_state(n, dtype=torch.complex128, device=CPU)
    for q in range(n):
        c, s = np.cos((0.2 + 0.15 * q) / 2), np.sin((0.2 + 0.15 * q) / 2)
        start = sv.apply_matrix(start, torch.tensor([[c, -s], [s, c]],
                                                    dtype=torch.complex128),
                                [q])
    _close(got, _exact(start, [(u, (a, b))]))
    swapped = _exact(start, [(u, (b, a))])
    assert float((torch.as_tensor(got) - swapped).abs().max()) > 1e-3


def test_quantum_volume_through_the_backend_matches_the_dense_reference():
    """A QV circuit at n = 16 (the benchmark's generator, its SU(4)s
    from seeded draws) through ``RocQuantumBackend.run`` agrees with
    ``portbench/reference/dense.py`` in float64; every dense gate on the
    kernel."""
    n = 16
    config = {"num_qubits": n, "depth": 6, "structure_seed": 7}
    gates = quantum_volume.gates(config)
    theta = np.random.default_rng(16).uniform(0, 2 * np.pi, len(gates))
    qc = QuantumCircuit(n, n)
    for _, pair, k in gates:
        qc.unitary(ref_dense.matrix(theta[k]), list(pair))
    qc.measure(list(range(n)), list(range(n)))
    backend = RocQuantumBackend(device="cpu")
    before = dict(profiling.COUNTERS)
    counts = backend.run(qc, shots=256).get_counts()
    assert sum(counts.values()) == 256
    assert profiling.COUNTERS["dense2q_kernel_gates"] - \
        before["dense2q_kernel_gates"] == len(gates)
    want = ref_dense.simulate(n, gates, theta, torch.float64, [CPU])
    re, im = want.blocks[0]
    _close(backend.get_statevector(), torch.complex(re, im))


def _cross_check_circuit(n, where, seed):
    """A seeded circuit of dense gates for the JAX cross-check: ``qv`` is
    the benchmark's generator (four layers); the others pair qubits both
    in the window (bits < 10), both above it, or one of each, in both
    orders, between RY layers."""
    rng = np.random.default_rng(seed)
    qc = QuantumCircuit(n, n)
    if where == "qv":
        gates = quantum_volume.gates({"num_qubits": n, "depth": 4,
                                      "structure_seed": seed})
        theta = rng.uniform(0, 2 * np.pi, len(gates))
        for _, pair, k in gates:
            qc.unitary(ref_dense.matrix(theta[k]), list(pair))
        return qc, len(gates)
    for q in range(n):
        qc.ry(float(rng.uniform(0, np.pi)), q)
    if where == "high":
        pairs = [(int(a), int(b)) for a, b in
                 (rng.choice(np.arange(10, n), 2, replace=False)
                  for _ in range(8))]
    else:
        pairs, _ = _pairs(rng, n, where, 8)
    pairs += [(b, a) for a, b in pairs]
    for u, pair in zip(_haar(rng, len(pairs)), pairs):
        qc.unitary(u, list(pair))
    return qc, len(pairs)


@pytest.mark.parametrize("where", ["window", "high", "mixed", "qv"])
def test_dense_gates_on_the_kernel_match_the_jax_backend(where):
    """The same seeded circuits of dense gates at n = 16, above the
    kernel's smallest state, through the JAX package's
    ``RocQuantumBackend`` and the port's: every dense gate on the port's
    kernel path, and the two statevectors agree within AMP_TOL."""
    n = 16
    qc, count = _cross_check_circuit(n, where, 19 + len(where))
    jax_b = jax_qiskit.RocQuantumBackend()
    port_b = RocQuantumBackend(device="cpu")
    jax_b.run(qc, shots=16)
    before = profiling.COUNTERS["dense2q_kernel_gates"]
    port_b.run(qc, shots=16)
    assert profiling.COUNTERS["dense2q_kernel_gates"] - before == count
    want = np.asarray(jax_b.get_statevector())
    got = np.asarray(port_b.get_statevector())
    assert got.shape == want.shape == (1 << n,)
    assert np.max(np.abs(got - want)) <= AMP_TOL * np.max(np.abs(want))


def test_every_layer_of_the_generator_pairs_a_permutation():
    config = {"num_qubits": 30, "depth": 30, "structure_seed": 1811}
    gates = quantum_volume.gates(config)
    assert len(gates) == 450
    assert [k for *_, k in gates] == list(range(450))
    for layer in range(30):
        qubits = [q for _, pair, _ in gates[15 * layer:15 * layer + 15]
                  for q in pair]
        assert sorted(qubits) == list(range(30))
    assert gates == quantum_volume.gates(dict(config))


def test_plan_misses_count_fresh_unitaries_not_fresh_angles():
    """A flush of fresh SU(4)s misses the plan cache once (the matrices
    are in the plan's key); a ring of RY angles misses once, then never,
    however its angles change."""
    rng = np.random.default_rng(17)
    n = 15
    sim = QuantumSimulator(n, device="cpu")

    def misses(fill):
        before = profiling.COUNTERS["plan_misses"]
        sim.reset()
        fill()
        sim.get_probabilities([0])
        return profiling.COUNTERS["plan_misses"] - before

    def qv():
        for u, (a, b) in zip(_haar(rng, 7), [(2 * k, 2 * k + 1)
                                             for k in range(7)]):
            sim.apply_matrix(u, [a, b])

    def ring():
        for q in range(n):
            sim.apply_gate("RY", [q], [float(rng.uniform(0, 6.28))])
        for q in range(n):
            sim.apply_gate("CNOT", [q, (q + 1) % n])

    assert [misses(qv) for _ in range(3)] == [1, 1, 1]
    assert misses(ring) == 1
    assert [misses(ring) for _ in range(3)] == [0, 0, 0]


def test_a_traced_qiskit_job_is_one_request_of_its_spans():
    """Under a profiler, each circuit of a ``run`` is one request:
    ``rq.qiskit.translate``, then ``rq.run`` (with ``rq.plan`` inside on
    a miss) and ``rq.sample``; untraced, nothing is recorded."""
    n = 15
    rng = np.random.default_rng(18)

    def job():
        qc = QuantumCircuit(n, n)
        for q in range(n):
            qc.ry(0.1 * q, q)
        qc.unitary(_haar(rng, 1)[0], [0, 12])
        qc.measure(list(range(n)), list(range(n)))
        return qc

    backend = RocQuantumBackend(device="cpu")
    profiling.clear()
    backend.run(job(), shots=16)
    assert profiling.records() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        backend.run(job(), shots=16)
        backend.run([job(), job()], shots=16)
    requests = [r for r in profiling.records() if r.id is not None]
    assert len(requests) == 3
    for r in requests:
        names = [s.name for s in r.spans]
        assert names[0] == "rq.qiskit.translate"
        assert {"rq.run", "rq.sample"} <= set(names)
        assert r.counters.get("dense2q_gates") == 1
        assert "rq.plan" in names
    profiling.clear()
