"""The port's sharded engine against the JAX package's.

``rocquantum_tpu_torch.parallel`` (meshes, the sharded state, its
exchanges and readouts), ``compiler.sharded_schedule`` and the sharded
``Circuit`` / ``compile_ir`` / ``compile_program`` against
``rocquantum_tpu``'s on its 8 virtual CPU devices, and against the port
unsharded. The port's meshes here are virtual shards on the CPU
(``devices=[cpu] * k``); inputs come from numpy seeds. Tolerances are the
JAX package's own sharded tests' (test_sharded.py:126, 227): 1e-6 of the
amplitudes in single precision, 1e-12 in double.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler import sharded_schedule as jax_sched
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.parallel import mesh as jax_mesh
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.compiler import (CircuitIR, compile_ir,
                                           execute)
from rocquantum_tpu_torch.compiler.interpreter import compile_df64_fused_ir
from rocquantum_tpu_torch.compiler import sharded_schedule as port_sched
from rocquantum_tpu_torch.ops import fused_df64, fused_sv
from rocquantum_tpu_torch.ops import statevec as sv
from rocquantum_tpu_torch.utils import profiling
from rocquantum_tpu_torch.parallel import (count_collectives, make_mesh,
                                           make_mesh_2d, make_mesh_multislice,
                                           num_global_qubits,
                                           reset_collectives, shard_state,
                                           sharded, state_sharding,
                                           swap_index_bits_sharded)

F32_TOL = 1e-6
DOUBLE_TOL = 1e-12
CPU = torch.device("cpu")


def cpu_mesh(k=8):
    return make_mesh(k, devices=[CPU] * k)


def two_part_mesh(k=8):
    """k shards on two devices, interleaved: ``cpu`` and ``cpu:0`` compare
    unequal, so each holds the rows of every other shard (the layout of
    shards over several cards)."""
    return make_mesh(k, devices=[CPU, torch.device("cpu", 0)] * (k // 2))


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


def _set(mode: str):
    jax_config.set_precision(mode)
    rq.set_precision(mode)


@pytest.fixture(autouse=True)
def restore_precision(monkeypatch):
    """Afterwards both packages' precision and JAX's x64 flag (which
    set_precision("double") turns on) are as they were."""
    monkeypatch.delenv("ROCQ_DF64", raising=False)
    monkeypatch.delenv("ROCQ_PALLAS_INTERPRET", raising=False)
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


def _sims(seed=0):
    return rocq.Simulator(seed=seed), rq.Simulator(seed=seed, device="cpu")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_checks_and_no_cpu_fallback(monkeypatch):
    mesh = cpu_mesh(8)
    assert mesh.shape["sv"] == 8 and mesh.axis_names == ("sv",)
    assert num_global_qubits(mesh) == 3
    assert num_global_qubits(make_mesh_multislice(2, 4, devices=[CPU] * 8)) \
        == num_global_qubits(jax_mesh.make_mesh_multislice(2, 4)) == 3
    two = make_mesh_2d(2, 4, devices=[CPU] * 8)
    assert two.shape == {"dp": 2, "sv": 4}
    for bad in (lambda: make_mesh(3, devices=[CPU] * 8),
                lambda: make_mesh(100, devices=[CPU] * 8),
                lambda: make_mesh_2d(4, 4, devices=[CPU] * 8),
                lambda: make_mesh_multislice(3, 2, devices=[CPU] * 8)):
        with pytest.raises(ValueError):
            bad()
    # the JAX package's checks, the same way
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(3)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(100)
    sim = rq.Simulator(device="cpu")
    with pytest.raises(ValueError, match="'sv' mesh axis"):
        rq.Circuit(4, sim, mesh=make_mesh(2, "x", devices=[CPU] * 2))
    with pytest.raises(TypeError):
        rq.Circuit(4, sim, mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for no_devices in (make_mesh, rq.parallel.default_mesh,
                       lambda: make_mesh_2d(1, 1),
                       lambda: rq.Circuit(4, sim, multi_gpu=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            no_devices()


# ---------------------------------------------------------------------------
# the locality scheduler: the same op lists as the JAX package's
# ---------------------------------------------------------------------------

def _op_tuple(op):
    params = tuple(getattr(p, "index", p) for p in op.params)
    mat = None if op.matrix is None else np.asarray(op.matrix).tobytes()
    return (op.name, tuple(op.targets), tuple(op.controls), params, mat,
            bool(op.is_adjoint))


def _random_ir(rng, n, depth):
    ir = JaxIR(n)
    for _ in range(depth):
        kind = int(rng.integers(0, 9))
        q = int(rng.integers(0, n))
        q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
        if kind == 0:
            ir.add(str(rng.choice(["H", "X", "Y", "S", "T", "Z"])), [q])
        elif kind == 1:
            ir.add("RY", [q], params=[float(rng.normal())])
        elif kind == 2:
            ir.add("CNOT", [q2], controls=[q])
        elif kind == 3:
            ir.add("CZ", [q2], controls=[q])
        elif kind == 4:
            ir.add("SWAP", [q, q2])
        elif kind == 5:
            ir.add("RZZ", [q, q2], params=[float(rng.normal())])
        elif kind == 6:
            ir.add("CRZ", [q2], controls=[q], params=[float(rng.normal())])
        elif kind == 7:
            ir.add("RZ", [q], params=[float(rng.normal())])
        else:
            ir.add("CRX", [q2], controls=[q], params=[float(rng.normal())])
    return ir


def _same_schedule(jir, n, n_global, layout=None):
    jops, jlay = jax_sched.schedule_for_sharding(jir.ops, n, n_global,
                                                 layout)
    pops, play = port_sched.schedule_for_sharding(
        convert.ir_from_reference(jir).ops, n, n_global, layout)
    assert [_op_tuple(o) for o in pops] == [_op_tuple(o) for o in jops]
    assert play == jlay
    for merge in (False, True):
        assert [_op_tuple(o) for o in port_sched.unpermute_ops(play, merge)] \
            == [_op_tuple(o) for o in jax_sched.unpermute_ops(jlay, merge)]
    return pops


@pytest.mark.parametrize("seed", range(30))
def test_schedule_matches_jax_on_random_circuits(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5, 15))
    n_global = int(rng.integers(1, min(4, n - 2) + 1))
    layout = [int(v) for v in rng.permutation(n)] if seed % 2 else None
    _same_schedule(_random_ir(rng, n, int(rng.integers(10, 60))), n,
                   n_global, layout)


def _ring(n, layers=8):
    ir = JaxIR(n)
    for layer in range(layers):
        for q in range(n):
            ir.add("RY", [q], params=[0.01 * (layer * n + q + 1)])
        for q in range(n):
            ir.add("CNOT", [(q + 1) % n], controls=[q])
    return ir


@pytest.mark.parametrize("n,n_global", [(12, 3), (16, 2), (20, 3), (26, 2),
                                        (30, 3)])
def test_schedule_matches_jax_on_the_ring(n, n_global):
    ops = _same_schedule(_ring(n), n, n_global)
    relabels = sum(op.name in ("SWAP_BITS", "PERMUTE_BITS") for op in ops)
    assert relabels > 0


def test_scheduler_batches_a_global_column_into_one_relabel():
    n = 12
    ir = JaxIR(n)
    for q in range(n):
        ir.add("RY", [q], params=[0.05 * (q + 1)])
    ops = _same_schedule(ir, n, 3)
    names = [op.name for op in ops]
    assert names.count("PERMUTE_BITS") == 1 and "SWAP_BITS" not in names
    assert len(next(op for op in ops if op.name == "PERMUTE_BITS").targets) \
        == 6


# ---------------------------------------------------------------------------
# the sharded state and its exchanges
# ---------------------------------------------------------------------------

def _random_state(rng, n):
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return torch.as_tensor((v / np.linalg.norm(v)).astype(np.complex64))


def test_sharded_init_and_every_swap_case():
    mesh = cpu_mesh(8)
    st = sharded.sharded_init_state(6, mesh)
    assert len(st.parts) == 1 and tuple(st.parts[0][0].shape) == (8, 8)
    np.testing.assert_array_equal(sharded.gather(st)[0].numpy(),
                                  np.eye(64)[0])
    v = _random_state(np.random.default_rng(0), 6)
    # local-local, local-global (the all-to-all), global-global (a
    # collective-permute of whole shards)
    for (q1, q2), kind in (((0, 1), None), ((1, 5), "all-to-all"),
                           ((4, 5), "collective-permute")):
        reset_collectives()
        out = swap_index_bits_sharded(shard_state(v, mesh), q1, q2, mesh)
        np.testing.assert_array_equal(sharded.gather(out)[0].numpy(),
                                      sv.swap_index_bits(v, q1, q2).numpy())
        counts = count_collectives()
        for name, c in counts.items():
            assert c == (name in (kind, "all-gather")), (q1, q2, counts)


@pytest.mark.parametrize("seed", range(4))
def test_permute_bits_matches_the_flat_relabel(seed):
    rng = np.random.default_rng(seed)
    n = 9
    v = _random_state(rng, n)
    mesh = (cpu_mesh(4), make_mesh_multislice(2, 4, devices=[CPU] * 8),
            two_part_mesh(8), two_part_mesh(4))[seed]
    perm = [int(p) for p in rng.permutation(n)]
    srcs = tuple(perm)
    dsts = tuple(range(n))
    out = sharded.permute_bits(shard_state(v, mesh), dsts, srcs)
    np.testing.assert_array_equal(sharded.gather(out)[0].numpy(),
                                  sv.permute_index_bits(v, dsts,
                                                        srcs).numpy())


# ---------------------------------------------------------------------------
# sharded circuits against the JAX package's sharded circuits
# ---------------------------------------------------------------------------

def _drive_fixed(c, n):
    """Gates on local and global qubits, diagonals on global ones, a SWAP
    across the boundary, a flush in between."""
    for q in range(n):
        c.ry(0.1 + 0.07 * q, q)
    for q in range(n):
        c.cx(q, (q + 1) % n)
    c.h(n - 1)
    c.cx(n - 1, 0)
    c.rz(0.4, n - 1)
    c.rzz(0.9, n - 1, n - 2)
    c.flush()
    c.cz(n - 2, 1)
    c.swap(0, n - 1)
    c.crz(0.3, 2, n - 2)
    c.rx(0.5, n - 3)
    c.crx(0.25, n - 1, 3)
    c.s(n - 1)
    c.t(0)
    c.y(n - 2)
    return c


def _drive_short(c, n):
    """JAX test_sharded.py:507's df64 drive (the JAX package's sharded df64
    program compiles for seconds an op on the CPU), a SWAP and an RX."""
    c.h(n - 1)
    c.cx(n - 1, 0)
    c.rz(0.4, n - 1)
    c.ry(0.7, n - 2)
    c.cz(n - 2, 1)
    c.swap(0, n - 1)
    c.rx(0.3, n - 3)
    c.flush()
    return c


@pytest.mark.parametrize("mode", ["single", "double", "df64"])
def test_sharded_circuit_matches_jax_and_unsharded(mode):
    """n = 10: the JAX package's sharded Circuit on its 8 devices, the
    port's on 8 and on 4 shards and unsharded."""
    _set(mode)
    n = 10
    tol = F32_TOL if mode == "single" else DOUBLE_TOL
    drive = _drive_short if mode == "df64" else _drive_fixed
    jc = drive(rocq.Circuit(n, rocq.Simulator(seed=3),
                            mesh=jax_mesh.make_mesh(8)), n)
    pu = drive(rq.Circuit(n, rq.Simulator(seed=3, device="cpu")), n)
    h = {"Z0 Z1": 0.5, f"X{n - 1}": -0.7, f"Y{n - 2} X0": 0.3, "I": 0.1}
    want = jc.get_statevector()
    for shards in (8, 4):
        pc = drive(rq.Circuit(n, rq.Simulator(seed=3, device="cpu"),
                              mesh=cpu_mesh(shards)), n)
        for ref, op in ((jc, rocq.PauliOperator(h)),
                        (pu, rq.PauliOperator(h))):
            assert abs(pc.expval(rq.PauliOperator(h)) - ref.expval(op)) < tol
            np.testing.assert_allclose(pc.get_probabilities([0, n - 1, 3]),
                                       ref.get_probabilities([0, n - 1, 3]),
                                       atol=tol)
        psi = pc.get_statevector()
        np.testing.assert_allclose(psi, want, atol=tol)
        np.testing.assert_allclose(psi, pu.get_statevector(), atol=tol)
        np.testing.assert_allclose(pc.get_statevector_slice(5, 300),
                                   psi[5:305], atol=0)


GATES_1Q = ["H", "X", "Y", "Z", "S", "T"]


def _drive_random(c, rng, n, depth):
    """JAX test_sharded.py's fuzz: gates, flushes and measurements; the
    same host draws on both sides give the same outcomes."""
    readouts = []
    for step in range(depth):
        kind = rng.integers(0, 8)
        q = int(rng.integers(0, n))
        q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
        if kind == 0:
            getattr(c, str(rng.choice(GATES_1Q)).lower())(q)
        elif kind == 1:
            c.ry(float(rng.normal()), q)
        elif kind == 2:
            c.cx(q, q2)
        elif kind == 3:
            c.cz(q, q2)
        elif kind == 4:
            c.swap(q, q2)
        elif kind == 5:
            c.rzz(float(rng.normal()), q, q2)
        elif kind == 6:
            c.flush()
        else:
            out, p = c.measure(q)
            readouts.append((step, out, p))
    return readouts


@pytest.mark.parametrize("mode,seed,n,mesh", [
    ("single", 0, 8, 8), ("single", 1, 12, 4), ("single", 2, 10, 8),
    ("single", 3, 9, "two parts"), ("double", 10, 8, 8),
    ("double", 12, 11, 4), ("double", 14, 9, "two parts"),
    ("df64", 11, 8, 8), ("df64", 13, 12, 4)])
def test_random_sharded_circuits_match_unsharded(mode, seed, n, mesh):
    _set(mode)
    tol = 2e-5 if mode == "single" else DOUBLE_TOL
    ra, rb = (np.random.default_rng(seed) for _ in range(2))
    mesh = two_part_mesh() if mesh == "two parts" else cpu_mesh(mesh)
    ca = rq.Circuit(n, rq.Simulator(seed=seed, device="cpu"), mesh=mesh)
    cb = rq.Circuit(n, rq.Simulator(seed=seed, device="cpu"))
    xa = _drive_random(ca, ra, n, 25)
    xb = _drive_random(cb, rb, n, 25)
    assert [x[:2] for x in xa] == [x[:2] for x in xb]
    for (_, _, pa), (_, _, pb) in zip(xa, xb):
        assert abs(pa - pb) < tol
    np.testing.assert_allclose(ca.get_statevector(), cb.get_statevector(),
                               atol=tol)


def test_random_sharded_circuit_matches_jax_sharded():
    n, seed = 8, 2
    ra, rb = (np.random.default_rng(seed) for _ in range(2))
    jc = rocq.Circuit(n, rocq.Simulator(seed=seed),
                      mesh=jax_mesh.make_mesh(8))
    pc = rq.Circuit(n, rq.Simulator(seed=seed, device="cpu"),
                    mesh=cpu_mesh(8))
    xj = _drive_random(jc, ra, n, 25)
    xp = _drive_random(pc, rb, n, 25)
    assert [x[:2] for x in xj] == [x[:2] for x in xp]
    for (_, _, pj), (_, _, pp) in zip(xj, xp):
        assert abs(pj - pp) < 1e-5
    np.testing.assert_allclose(pc.get_statevector(), jc.get_statevector(),
                               atol=2e-5)


def test_measure_sample_and_get_expval_through_the_layout():
    """JAX test_sharded.py:240 and :251: a measurement of a global qubit,
    samples that address logical qubits and get_expval through the layout
    the scheduler leaves."""
    jsim, psim = _sims(1)
    jc = rocq.Circuit(6, jsim, mesh=jax_mesh.make_mesh(8))
    pc = rq.Circuit(6, psim, mesh=cpu_mesh(8))
    for c in (jc, pc):
        c.h(5)
        c.cx(5, 0)
    mj, pj = jc.measure(5)
    mp, pp = pc.measure(5)
    assert (mj, pj) == pytest.approx((mp, pp), abs=1e-6)
    assert abs(pp - 0.5) < 1e-6
    assert set(np.unique(pc.sample([0, 5], 100))) == ({0} if mp == 0
                                                      else {3})

    @rq.kernel
    def k(q):
        q.h(6)  # a global qubit: forces a relabel
        q.cx(6, 0)

    c = rq.Circuit(7, rq.Simulator(seed=2, device="cpu"), mesh=cpu_mesh(8))
    k(c)
    c.flush()
    assert c._layout != list(range(7))
    prog = rq.QuantumProgram("t", 7)
    prog.circuit_ref = c
    ref = rocq.Circuit(7, rocq.Simulator())
    ref.h(6)
    ref.cx(6, 0)
    for term in ("Z0 Z6", "X0 X6", "Z6", "Y0 Y6"):
        assert abs(rq.get_expval(prog, rq.PauliOperator(term))
                   - ref.expval(rocq.PauliOperator(term))) < 1e-6
    counts = np.bincount(c.sample(list(range(7)), 300), minlength=128)
    assert counts[0] + counts[65] == 300


def test_multislice_and_2d_meshes_match_jax():
    # multislice: the amplitude index spans (dcn, sv)
    n = 6
    jc = rocq.Circuit(n, rocq.Simulator(),
                      mesh=jax_mesh.make_mesh_multislice(2, 4))
    pc = rq.Circuit(n, rq.Simulator(device="cpu"),
                    mesh=make_mesh_multislice(2, 4, devices=[CPU] * 8))
    for c in (jc, pc):
        c.h(0)
        for q in range(n - 1):
            c.cx(q, q + 1)
        c.ry(0.7, n - 1)  # a gate on a slice-selecting qubit
        c.h(n - 2)
    np.testing.assert_allclose(pc.get_statevector(), jc.get_statevector(),
                               atol=F32_TOL)
    # batched over (dp, sv): per-element draws in element order
    jsim, psim = _sims(4)
    jc = rocq.Circuit(n, jsim, batch_size=4,
                      mesh=jax_mesh.make_mesh_2d(2, 4))
    pc = rq.Circuit(n, psim, batch_size=4,
                    mesh=make_mesh_2d(2, 4, devices=[CPU] * 8))
    st = pc.state
    assert st.sharding.blocks == 2 and st.rows_per_cell == 2
    for c in (jc, pc):
        c.h(5)
        c.cx(5, 0)
        c.ry(0.3, 4)
    oj, prj = jc.measure(5)
    op_, prp = pc.measure(5)
    np.testing.assert_array_equal(oj, op_)
    np.testing.assert_allclose(prj, prp, atol=1e-6)
    for c in (jc, pc):
        c.rx(0.2, 3)
        c.cz(5, 1)
    np.testing.assert_allclose(pc.get_statevector(), jc.get_statevector(),
                               atol=F32_TOL)
    np.testing.assert_allclose(pc.expval(rq.PauliOperator("X3 Z0")),
                               jc.expval(rocq.PauliOperator("X3 Z0")),
                               atol=F32_TOL)
    np.testing.assert_allclose(pc.get_probabilities([5, 3]),
                               jc.get_probabilities([5, 3]), atol=F32_TOL)
    assert pc.sample([0, 5], 7).shape == (4, 7)


def test_compile_program_with_a_mesh_matches_jax():
    n = 8
    jir = _ring(n, 1)
    jir.add("RZ", [n - 1], params=[0.3])
    ir = convert.ir_from_reference(jir)
    obs = {"Z0 Z1": -1.0, f"X{n - 1}": 0.5, "Y3 Y7": 0.25}
    jprog = rocq.compile_program(jir, rocq.Simulator(),
                                 observable=rocq.PauliOperator(obs),
                                 mesh=jax_mesh.make_mesh(8))
    pprog = rq.compile_program(ir, rq.Simulator(device="cpu"),
                               observable=rq.PauliOperator(obs),
                               mesh=cpu_mesh(8))
    assert pprog.num_params == jprog.num_params
    assert abs(pprog.run() - jprog.run()) < 1e-5
    theta = np.random.default_rng(5).normal(size=pprog.num_params)
    for sweep in (theta, -theta):
        assert abs(pprog.run(sweep) - jprog.run(sweep)) < 1e-5
    handle = rq.compile_program(ir, rq.Simulator(device="cpu"),
                                mesh=cpu_mesh(4)).run()
    flat = rq.compile_program(ir, rq.Simulator(device="cpu")).run()
    np.testing.assert_allclose(handle.get_statevector(),
                               flat.get_statevector(), atol=F32_TOL)


# ---------------------------------------------------------------------------
# the exchange budget, pinned (JAX test_sharded.py:586)
# ---------------------------------------------------------------------------

def _counts(build, n=12):
    c = rq.Circuit(n, rq.Simulator(device="cpu"), mesh=cpu_mesh(8))
    build(c, n)
    c.state  # the fill is no collective
    reset_collectives()
    c.flush()
    counts = count_collectives()
    return c, counts


def test_exchange_budget_is_pinned():
    def canonical(c, n):
        c.h(n - 1)
        c.cx(n - 1, 0)
        c.ry(0.3, n - 2)

    def diagonals(c, n):
        c.cz(0, n - 1)
        c.rz(0.4, n - 1)

    def ansatz(c, n):
        for q in range(n):
            c.ry(0.1 * (q + 1), q)
        for q in range(n):
            c.cx(q, (q + 1) % n)

    zero = dict.fromkeys(count_collectives(), 0)
    c, counts = _counts(canonical)
    assert counts == {**zero, "all-to-all": 1}
    c, counts = _counts(diagonals)
    assert counts == zero
    c, counts = _counts(ansatz)
    assert counts == {**zero, "all-to-all": 2}
    # no all-gather before a full read-back, exactly one with it
    c.expval(rq.PauliOperator("Z0 Z11"))
    c.get_probabilities([0, 11])
    c.measure(3)
    assert count_collectives()["all-gather"] == 0
    c.get_statevector()
    assert count_collectives()["all-gather"] == 1


def test_global_diagonals_move_nothing():
    """JAX test_sharded.py:386-432: diagonals on global qubits are
    scheduled on their physical bits (no relabel) and run shard by shard
    with no collective."""
    n = 12
    jir = JaxIR(n)
    jir.add("CZ", [0], controls=[n - 1])
    jir.add("RZZ", [n - 1, n - 2], params=[0.7])
    jir.add("RZ", [n - 3], params=[0.4])
    jir.add("CRZ", [n - 2], controls=[2], params=[0.3])
    ops = _same_schedule(jir, n, 3)
    assert not any(op.name in ("SWAP_BITS", "PERMUTE_BITS") for op in ops)
    v = _random_state(np.random.default_rng(3), n)
    mesh = cpu_mesh(8)
    reset_collectives()
    out = compile_ir(CircuitIR(n, ops), sharding=state_sharding(mesh))(
        shard_state(v, mesh))
    assert not any(count_collectives().values())
    np.testing.assert_allclose(sharded.gather(out)[0].numpy(),
                               compile_ir(CircuitIR(n, ops))(v).numpy(),
                               atol=F32_TOL)
    n = 7
    ref = rq.Circuit(n, rq.Simulator(seed=5, device="cpu"))
    shd = rq.Circuit(n, rq.Simulator(seed=5, device="cpu"), mesh=cpu_mesh(8))
    for c in (ref, shd):
        for q in range(n):
            c.h(q)
        c.cz(n - 1, 0)
        c.rzz(0.9, n - 1, n - 2)
        c.rz(0.4, n - 3)
        c.crz(0.3, 2, n - 2)
        c.ry(0.5, 1)
    np.testing.assert_allclose(shd.get_statevector(), ref.get_statevector(),
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# diagonals on global bits: one in-place factor a cell
# ---------------------------------------------------------------------------

def one_cell_mesh():
    """Two shards, each on a device of its own (``cpu`` and ``cpu:0``
    compare unequal): one cell a device, as on the cards."""
    return make_mesh(2, devices=[CPU, torch.device("cpu", 0)])


_DIAG_N = 8
_TOP = _DIAG_N - 1  # global on every mesh below
# (name, targets, controls, params): each touches the top qubit, so no
# member is local-only and no run of local items reaches a matmul
_DIAG_CASES = {
    "Z": [("Z", [_TOP], [], [])],
    "S": [("S", [_TOP], [], [])],
    "T": [("T", [_TOP], [], [])],
    "RZ": [("RZ", [_TOP], [], [0.37])],
    "P": [("P", [_TOP], [], [1.1])],
    "block": [("Z", [_TOP], [], []), ("S", [_TOP], [], []),
              ("T", [_TOP], [], []), ("RZ", [_TOP], [], [0.4]),
              ("P", [_TOP], [], [0.9])],
    "CZ": [("CZ", [0], [_TOP], [])],
    "CRZ": [("CRZ", [2], [_TOP], [0.6])],
    "RZZ": [("RZZ", [3, _TOP], [], [0.8])],
}
_DIAG_BATCH = 3


def _diag_ir(case):
    jir = JaxIR(_DIAG_N)
    for name, targets, controls, params in _DIAG_CASES[case]:
        jir.add(name, targets, controls=controls, params=params)
    return jir


def _diag_states(dtype):
    """A batch of random states; element 0 is the unbatched input."""
    rng = np.random.default_rng(11)
    shape = (_DIAG_BATCH, 1 << _DIAG_N)
    v = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.complex64 if dtype == "c64" else np.complex128)


@functools.lru_cache(maxsize=None)
def _jax_diag(case, dtype):
    """The JAX package's sharded run of ``case`` on each element of
    :func:`_diag_states` over its 8 virtual devices."""
    import jax.numpy as jnp
    from rocquantum_tpu.compiler import compile_ir as jax_compile_ir
    from rocquantum_tpu.parallel import sharded as jax_sharded
    _set("single" if dtype == "c64" else "double")
    mesh = jax_mesh.make_mesh(8)
    fn = jax_compile_ir(_diag_ir(case),
                        sharding=jax_sharded.state_sharding(mesh),
                        donate=False)
    zero = jnp.zeros((0,), jnp.float32)
    return np.stack([np.asarray(fn(jax_sharded.shard_state(jnp.asarray(x),
                                                            mesh), zero))
                     for x in _diag_states(dtype)])


@pytest.mark.parametrize("mesh_kind", ["cells", "devices"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", ["c64", "c128"])
@pytest.mark.parametrize("case", list(_DIAG_CASES))
def test_global_diagonals_scale_each_cell_in_place(monkeypatch, case, dtype,
                                                   batched, mesh_kind):
    """A diagonal on global bits, alone, in a block, or across the
    local/global boundary, on complex64 (planned: one DiagBlock) and
    complex128 (op by op) parts, unbatched and batched, on a mesh of
    several cells a device and one of one cell a device: the port's run
    matches its unsharded run and the JAX package's sharded run, reaches
    no matmul, updates every part in place and counts each diagonal item
    once a run."""
    jax_ref = _jax_diag(case, dtype)
    _set("single")
    ir = convert.ir_from_reference(_diag_ir(case))
    v = torch.as_tensor(_diag_states(dtype))
    if not batched:
        v, jax_ref = v[0], jax_ref[0]
    mesh = cpu_mesh(8) if mesh_kind == "cells" else one_cell_mesh()
    state = shard_state(v, mesh)
    ptrs = [p[0].data_ptr() for p in state.parts]
    run = compile_ir(ir, batched=batched,
                     sharding=state_sharding(mesh, batch=batched))
    items = 1 if dtype == "c64" else len(ir.ops)

    calls = []
    matmul = sv.apply_matrix
    monkeypatch.setattr(sv, "apply_matrix", lambda *a: calls.append(a)
                        or matmul(*a))
    for _ in range(2):
        before = dict(profiling.COUNTERS)
        out = run(state)
        assert profiling.COUNTERS["shard_diagonals"] \
            - before["shard_diagonals"] == items
        assert profiling.COUNTERS["shard_diagonals_in_place"] \
            - before["shard_diagonals_in_place"] == items
    assert not calls
    assert [p[0].data_ptr() for p in out.parts] == ptrs
    monkeypatch.setattr(sv, "apply_matrix", matmul)

    # two runs on the sharded state, so the references apply it twice
    flat = compile_ir(ir, batched=batched)
    want = flat(flat(v))
    tol = F32_TOL if dtype == "c64" else DOUBLE_TOL
    got = sharded.gather(out)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol)
    jflat = compile_ir(ir, batched=batched)(torch.as_tensor(jax_ref))
    np.testing.assert_allclose(got.numpy(), jflat.numpy(), atol=tol)


def test_df64_parts_keep_the_per_shard_diagonal():
    """The df64 engine's hi/lo planes are not one complex tensor: a global
    diagonal still runs shard by shard on them (its scalar needs the hi/lo
    arithmetic), counted as a global diagonal, not as one scaled in place,
    and the result is the unsharded engine's."""
    _set("df64")
    ir = convert.ir_from_reference(_diag_ir("block"))
    ir.add("CRZ", [2], controls=[_TOP], params=[0.6])
    v = torch.as_tensor(_diag_states("c128")[0])
    pair = (v.real.contiguous(), v.imag.contiguous())
    mesh = cpu_mesh(8)
    before = dict(profiling.COUNTERS)
    out = compile_df64_fused_ir(ir, sharding=state_sharding(mesh))(
        shard_state(pair, mesh), None)
    assert profiling.COUNTERS["shard_diagonals"] \
        - before["shard_diagonals"] == 1
    assert profiling.COUNTERS["shard_diagonals_in_place"] \
        == before["shard_diagonals_in_place"]
    re, im = sharded.gather(out)
    want = compile_df64_fused_ir(ir)(pair, None)
    np.testing.assert_allclose(re.numpy(), want[0].numpy(), atol=DOUBLE_TOL)
    np.testing.assert_allclose(im.numpy(), want[1].numpy(), atol=DOUBLE_TOL)


def test_the_four_card_cells_circuit_has_no_matmul():
    """The four-card cell's circuit (EfficientSU2, ry/rz, circular, reps
    8) at n = 17 over 4 shards: the plan's diagonals are 9 DiagBlocks of
    RZ on the two global bits, whatever the low block's width, with no
    FusedBlock; a request scales each cell in place 9 times and reaches
    no matmul (the per-shard diagonal made 72 a request, 18 x 4 shards),
    and its state is the unsharded program's."""
    from portbench.circuits import efficient_su2
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.compiler.passes import DiagBlock, FusedBlock
    n, n_global = 17, 2
    gates = efficient_su2.gates({"num_qubits": n, "reps": 8,
                                 "su2_gates": ["ry", "rz"],
                                 "entanglement": "circular"})

    def kernel(q, *theta):
        for name, qubits, param in gates:
            getattr(q, name.lower())(
                *(() if param is None else (theta[param],)), *qubits)

    theta = np.random.default_rng(3).uniform(
        0, 2 * np.pi, 1 + max(p for *_, p in gates if p is not None))
    ir = rq.trace_kernel(kernel, n, *theta)
    ops, _ = port_sched.schedule_for_sharding(list(ir.ops), n, n_global)
    plans = [interpreter.plan_items(ops, n - n_global, True, 2,
                                    use_kernel=True, low_width=w)
             for w in (interpreter.default_widths(n, sharded=True)[0], 0)]
    assert [_op_tuple(o) for p in plans[0] if isinstance(p, DiagBlock)
            for o in p.ops] == [_op_tuple(o) for p in plans[1]
                                if isinstance(p, DiagBlock) for o in p.ops]
    assert len(plans[0]) == len(plans[1])
    diags = [p for p in plans[0] if isinstance(p, DiagBlock)]
    assert len(diags) == 9
    assert all(op.name == "RZ" and op.targets[0] >= n - n_global
               for p in diags for op in p.ops)
    assert {tuple(p.qubits) for p in diags} == {(n - 2, n - 1)}
    assert not any(isinstance(p, FusedBlock) for p in plans[0])

    prog = rq.compile_program(ir, rq.Simulator(device="cpu"),
                              mesh=cpu_mesh(4))
    prog.run(theta)
    calls = []
    matmul = sv.apply_matrix
    try:
        sv.apply_matrix = lambda *a: calls.append(a) or matmul(*a)
        before = dict(profiling.COUNTERS)
        handle = prog.run(theta)
    finally:
        sv.apply_matrix = matmul
    assert not calls
    assert profiling.COUNTERS["shard_diagonals"] \
        - before["shard_diagonals"] == 9
    assert profiling.COUNTERS["shard_diagonals_in_place"] \
        - before["shard_diagonals_in_place"] == 9
    flat = rq.compile_program(ir, rq.Simulator(device="cpu")).run(theta)
    np.testing.assert_allclose(handle.get_statevector(),
                               flat.get_statevector(), atol=F32_TOL)


def test_sharding_arguments_name_the_state_layout():
    """compile_ir and execute take the state's own sharding or none;
    batch_sharding is the same argument as sharding (the port's
    descriptor carries the batch), so two different ones are refused, as
    are another kind of descriptor and a state of another layout."""
    n = 8
    ir = CircuitIR(n)
    ir.add("H", [n - 1])
    ir.add("CNOT", [0], controls=[n - 1])
    mesh8, mesh4 = cpu_mesh(8), cpu_mesh(4)
    s8, s4 = state_sharding(mesh8), state_sharding(mesh4)
    ops = list(ir.ops)
    want = sharded.gather(compile_ir(ir, sharding=s8)(
        sharded.sharded_init_state(n, mesh8)))[0]
    got = sharded.gather(compile_ir(ir, batch_sharding=s8)(
        sharded.sharded_init_state(n, mesh8)))[0]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="differ"):
        compile_ir(ir, sharding=s8, batch_sharding=s4)
    with pytest.raises(TypeError, match="state_sharding"):
        compile_ir(ir, sharding=object())
    with pytest.raises(ValueError, match="not sharded as"):
        compile_ir(ir, sharding=s8)(sharded.sharded_init_state(n, mesh4))
    with pytest.raises(ValueError, match="not sharded as"):
        execute(sharded.sharded_init_state(n, mesh4), ops, sharding=s8)
    with pytest.raises(ValueError, match="not sharded as"):
        execute(sv.init_state(n, device=CPU), ops, sharding=s8)
    got = sharded.gather(execute(sharded.sharded_init_state(n, mesh8), ops,
                                 sharding=s8))[0]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# kernel blocks on local bits: one batched launch a pass per device
# ---------------------------------------------------------------------------

def test_sharded_kernel_blocks_run_batched_per_device(monkeypatch):
    """At n_loc = 15 the plan has kernel blocks; each pass reaches the
    fused layer once, with the rows of all 8 shards (its plain version on
    the CPU), and the result is the unsharded flat run's."""
    calls = []
    layer = fused_sv.apply_fused_layer

    def counted(re, im, *args, **kwargs):
        calls.append(tuple(re.shape))
        return layer(re, im, *args, **kwargs)

    monkeypatch.setattr(fused_sv, "apply_fused_layer", counted)
    n = 18
    ir = CircuitIR(n)
    for q in range(12):
        ir.add("RY", [q], params=[0.1 + 0.1 * q])
    for q in range(11):
        ir.add("CNOT", [q + 1], controls=[q])
    mesh = cpu_mesh(8)
    out = compile_ir(ir, sharding=state_sharding(mesh))(
        sharded.sharded_init_state(n, mesh))
    assert calls and set(calls) == {(8, 1 << 15)}
    ref = compile_ir(ir)(sv.init_state(n, device=CPU))
    np.testing.assert_allclose(sharded.gather(out)[0].numpy(), ref.numpy(),
                               atol=1e-5)


def test_sharded_df64_kernel_blocks_run_per_shard(monkeypatch):
    _set("df64")
    calls = []
    layer = fused_df64.apply_fused_layer_df64

    def counted(rh, *args, **kwargs):
        calls.append(tuple(rh.shape))
        return layer(rh, *args, **kwargs)

    monkeypatch.setattr(fused_df64, "apply_fused_layer_df64", counted)
    n = 17
    drive = []
    for c in (rq.Circuit(n, rq.Simulator(device="cpu"), mesh=cpu_mesh(4)),
              rq.Circuit(n, rq.Simulator(device="cpu"))):
        for q in range(n):
            c.ry(0.1 + 0.03 * q, q)
        for q in range(0, n - 1, 2):
            c.cx(q, q + 1)
        c.rz(0.21, n - 1)
        c.flush()
        drive.append(c)
    assert calls and (1 << 15,) in calls
    assert drive[0].state.parts[0][1] is not None
    np.testing.assert_allclose(drive[0].get_statevector(),
                               drive[1].get_statevector(), atol=DOUBLE_TOL)


# ---------------------------------------------------------------------------
# the positional signatures of both packages
# ---------------------------------------------------------------------------

def test_positional_circuit_and_density_circuit_signatures():
    jsim, psim = _sims(7)
    jc = rocq.Circuit(3, jsim, False, 4)
    pc = rq.Circuit(3, psim, False, 4)
    assert jc.batch_size == pc.batch_size == 4
    assert jc.mesh is None and pc.mesh is None and not pc.is_multi_gpu
    for c in (jc, pc):
        c.h(0)
        c.cx(0, 2)
    np.testing.assert_allclose(pc.get_statevector(), jc.get_statevector(),
                               atol=F32_TOL)
    from rocquantum_tpu.density_circuit import DensityCircuit as JaxDC
    jmesh, pmesh = jax_mesh.make_mesh(4), cpu_mesh(4)
    jd = JaxDC(3, jsim, None, jmesh)
    pd = rq.DensityCircuit(3, psim, None, pmesh)
    assert pd.mesh is pmesh and jd.mesh is jmesh and pd.noise_model is None
    for d in (jd, pd):
        d.h(2)
        d.cx(2, 0)
        d.apply_channel("depolarizing", 0.1, [2])
    np.testing.assert_allclose(pd.get_density_matrix(),
                               jd.get_density_matrix(), atol=1e-5)
