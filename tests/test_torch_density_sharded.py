"""The port's sharded density engine against the JAX package's.

The cases of the JAX package's tests/test_density_sharded.py on the port:
rho's 2n-bit view sharded over virtual CPU shards
(``make_mesh(8, devices=[cpu] * 8)``), its row and column bits relabelled
by the locality scheduler so gates and channels touch local bits. Held
against the JAX package's DensityCircuit (unsharded, and sharded on its 8
virtual devices for the fixed workload) and against the port unsharded:
atol 1e-5 in single precision, 1e-12 on the exact double engine (the JAX
tests' tolerances), 1e-12 for df64 against the exact engine.
"""

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu import density_circuit as jax_dc
from rocquantum_tpu.parallel import mesh as jax_mesh
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import api
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch.compiler import CircuitIR, compile_ir, interpreter
from rocquantum_tpu_torch.compiler.ir import GateOp
from rocquantum_tpu_torch.compiler.sharded_schedule import \
    schedule_for_sharding
from rocquantum_tpu_torch.ops import density as port_density
from rocquantum_tpu_torch.parallel import (count_collectives, make_mesh,
                                           num_global_qubits,
                                           reset_collectives, sharded,
                                           state_sharding)

F32_TOL = 1e-5
DOUBLE_TOL = 1e-12
CPU = torch.device("cpu")


def cpu_mesh(k=8):
    return make_mesh(k, devices=[CPU] * k)


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


def _set(mode: str):
    jax_config.set_precision(mode)
    rq.set_precision(mode)


@pytest.fixture(autouse=True)
def restore_precision(monkeypatch):
    monkeypatch.delenv("ROCQ_DF64", raising=False)
    monkeypatch.delenv("ROCQ_PALLAS_INTERPRET", raising=False)
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


def _port(n, mesh=None, seed=5):
    return rq.DensityCircuit(n, rq.Simulator(seed=seed, device="cpu"),
                             mesh=mesh)


def _drive(c, n):
    """Gates spanning local and shard-selecting bits and noise channels
    (JAX test_density_sharded.py:24)."""
    c.h(0)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.ry(0.37, n - 1)  # the high row bit selects the shard
    c.apply_channel("depolarizing", 0.05, [n - 1])
    c.rz(0.21, n - 2)
    c.apply_channel("amplitude_damping", 0.1, [0])
    c.apply_kraus([np.sqrt(0.9) * np.eye(2),
                   np.sqrt(0.1) * np.array([[0, 1], [1, 0]])], [n - 1])
    c.crx(0.5, 0, n - 1)


def test_sharded_matches_jax_and_single_device():
    n = 6
    jref = jax_dc.DensityCircuit(n, rocq.Simulator(seed=5))
    jshd = jax_dc.DensityCircuit(n, rocq.Simulator(seed=5),
                                 mesh=jax_mesh.make_mesh(8))
    pref = _port(n)
    c = _port(n, cpu_mesh(8))
    for d in (jref, jshd, pref, c):
        _drive(d, n)
    assert isinstance(c.state, sharded.ShardedState)
    assert len(c.state.parts) == 1 and c.state.parts[0][0].shape[0] == 8
    rho = c.get_density_matrix()
    for ref in (jref, jshd, pref):
        np.testing.assert_allclose(rho, ref.get_density_matrix(),
                                   atol=F32_TOL)


def test_sharded_expectations_and_purity():
    n = 6
    ref = jax_dc.DensityCircuit(n, rocq.Simulator(seed=5))
    c = _port(n, cpu_mesh(8))
    _drive(ref, n)
    _drive(c, n)
    h = {f"Z0 Z{n - 1}": 1.0, "X1": 0.5, f"Y{n - 1} X0": -0.25, "I": 0.1}
    assert abs(c.expval(rq.PauliOperator(h))
               - ref.expval(rocq.PauliOperator(h))) < F32_TOL
    # the JAX package's f32 purity sums Re(rho_ij^2) (ROADMAP Queue 3):
    # hold the port's to Tr(rho^2) of the JAX rho and to the port unsharded
    rho = ref.get_density_matrix()
    assert abs(c.purity() - np.trace(rho @ rho).real) < F32_TOL
    flat = _port(n)
    _drive(flat, n)
    assert abs(c.purity() - flat.purity()) < F32_TOL


def test_sharded_measure_collapse_and_sample():
    n = 6
    c = _port(n, cpu_mesh(8))
    c.x(n - 1)  # deterministic |1> on the top qubit
    outcome, prob = c.measure(n - 1)
    assert outcome == 1 and abs(prob - 1.0) < 1e-6
    c.h(0)
    out = c.sample([0, n - 1], 200)
    assert set(np.unique(out)) <= {2, 3}
    assert abs(float(np.trace(c.get_density_matrix()).real) - 1.0) < 1e-6


def test_parameterized_segments_share_a_plan():
    """Two flushes with different angles and the same structure share the
    schedule and the plan."""
    n = 6
    c = _port(n, cpu_mesh(8))
    c.ry(0.3, n - 1)
    c.flush()
    sizes = (len(api._SCHEDULE_CACHE), len(interpreter._PLAN_CACHE))
    c2 = _port(n, cpu_mesh(8))
    c2.ry(0.9, n - 1)
    c2.flush()
    assert (len(api._SCHEDULE_CACHE), len(interpreter._PLAN_CACHE)) == sizes
    np.testing.assert_allclose(np.diag(c2.get_density_matrix()).real.reshape(
        2, -1).sum(axis=1), [np.cos(0.45) ** 2, np.sin(0.45) ** 2],
        atol=1e-6)


def _run_scheduled(ops, n, mesh):
    sched, _ = schedule_for_sharding(ops, 2 * n, num_global_qubits(mesh))
    rho = api._zero_sharded(2 * n, state_sharding(mesh), "single", False, 1)
    reset_collectives()
    compile_ir(CircuitIR(2 * n, sched), sharding=state_sharding(mesh))(rho)
    return sched, count_collectives()


def test_a_global_row_gate_moves_by_all_to_all_only():
    n = 6
    ops = [GateOp("RY", (2 * n - 1,), (), (0.3,)),
           GateOp("RY", (n - 1,), (), (0.3,))]
    _, counts = _run_scheduled(ops, n, cpu_mesh(8))
    assert counts["all-to-all"] > 0 and counts["all-gather"] == 0


def test_factored_phase_flip_is_comm_free_on_a_global_qubit():
    n = 6
    s = port_density.kraus_superoperator(port_density.phase_flip_kraus(0.2))
    fops = port_density.superop_kernel_ops(s, n - 1, 2 * n - 1)
    assert fops is not None and [o.name for o in fops] == ["D2M"]
    sched, counts = _run_scheduled(fops, n, cpu_mesh(8))
    assert [o.name for o in sched] == ["D2M"]
    assert not any(counts.values())


def test_rho_needs_a_local_bit():
    with pytest.raises(ValueError, match="device-selecting bits"):
        _port(1, cpu_mesh(4))


def _drive_random(c, rng, n, depth):
    readouts = []
    for _ in range(depth):
        kind = rng.integers(0, 8)
        q = int(rng.integers(0, n))
        q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
        if kind == 0:
            getattr(c, str(rng.choice(["h", "x", "z", "s"])))(q)
        elif kind == 1:
            c.ry(float(rng.normal()), q)
        elif kind == 2:
            c.cx(q, q2)
        elif kind == 3:
            c.cz(q, q2)
        elif kind == 4:
            ch = str(rng.choice(["depolarizing", "phase_flip",
                                 "bit_flip", "amplitude_damping"]))
            c.apply_channel(ch, 0.02 + 0.1 * float(rng.random()), [q])
        elif kind == 5:
            c.flush()
        elif kind == 6:
            c.rz(float(rng.normal()), q)
        else:
            out, p = c.measure(q)
            readouts.append((out, p))
    return readouts


@pytest.mark.parametrize("seed", range(3))
def test_random_noisy_circuits_match_single_device(seed):
    n = 5
    ra, rb, rj = (np.random.default_rng(40 + seed) for _ in range(3))
    ca = _port(n, cpu_mesh(8), seed)
    cb = _port(n, None, seed)
    xa = _drive_random(ca, ra, n, 18)
    xb = _drive_random(cb, rb, n, 18)
    assert [x[0] for x in xa] == [x[0] for x in xb]
    for (_, pa), (_, pb) in zip(xa, xb):
        assert abs(pa - pb) < F32_TOL
    np.testing.assert_allclose(ca.get_density_matrix(),
                               cb.get_density_matrix(), atol=2e-5)
    assert abs(ca.purity() - cb.purity()) < F32_TOL
    h = {"Z0": 0.4, f"Z1 Z{n - 1}": -0.3, "X2": 0.2}
    assert abs(ca.expval(rq.PauliOperator(h))
               - cb.expval(rq.PauliOperator(h))) < F32_TOL
    if seed == 0:
        cj = jax_dc.DensityCircuit(n, rocq.Simulator(seed=seed))
        xj = _drive_random(cj, rj, n, 18)
        assert [x[0] for x in xa] == [x[0] for x in xj]
        np.testing.assert_allclose(ca.get_density_matrix(),
                                   cj.get_density_matrix(), atol=2e-5)


@pytest.mark.parametrize("mode,seed", [("double", 50), ("double", 51),
                                       ("df64", 52)])
def test_random_noisy_circuits_in_double_sharded(mode, seed):
    """The sharded exact pair and df64 engines track the unsharded exact
    engine at 1e-12."""
    _set(mode)
    n = 4
    ra, rb = (np.random.default_rng(60 + seed) for _ in range(2))
    ca = _port(n, cpu_mesh(8), seed)
    _set("double")
    cb = _port(n, None, seed)
    _set(mode)
    xa = _drive_random(ca, ra, n, 15)
    ca.flush()
    _set("double")
    xb = _drive_random(cb, rb, n, 15)
    assert ca.state.parts[0][0].dtype == torch.float64
    assert [x[0] for x in xa] == [x[0] for x in xb]
    np.testing.assert_allclose(ca.get_density_matrix(),
                               cb.get_density_matrix(), atol=DOUBLE_TOL)
    assert abs(ca.purity() - cb.purity()) < DOUBLE_TOL
