"""The port's double-precision Circuit path against the JAX package's.

``rocquantum_tpu_torch.Circuit`` against ``rocquantum_tpu.Circuit`` at
N = 15 under ``set_precision("df64")`` (the double-float engine: the JAX
Pallas df64 kernels in interpret mode, the port's df64 layer through its
plain-torch version on the CPU) and under ``set_precision("double")`` (the
exact per-op engines). The same IR and float64 parameters go to both.

Tolerances: states within 5e-13 (the df64 accuracy contract for a
normalized state after a few dozen gates, the bound tests/test_df64_fused.py
holds the JAX package to); expectations and probabilities within 1e-10.
The JAX-side df64 circuits stay at about 25 gates (30 for the one ring
layer), since the interpret-mode run grows with the gate count.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.ops import pairsim as jax_pairsim
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import api as port_api
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch import density_circuit as port_dc
from rocquantum_tpu_torch.compiler import interpreter as port_interp
from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp
from rocquantum_tpu_torch.ops import df64, fused_df64
from rocquantum_tpu_torch.parallel import make_mesh, sharded, state_sharding

N = 15
ATOL = 5e-13
READ_TOL = 1e-10
MEASURED = (0, 7, 14)

# the two-qubit H2 operator of examples/fp64_chemistry.py on qubits 3, 14
H2 = {"I": -0.4804, "Z3": 0.3435, "Z14": -0.4347, "Z3 Z14": 0.5716,
      "X3 X14": 0.0910, "Y3 Y14": 0.0910}


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


def _set(mode: str):
    jax_config.set_precision(mode)
    rq.set_precision(mode)


@pytest.fixture(autouse=True)
def restore_precision(monkeypatch):
    """Interpret-mode Pallas for the JAX side; afterwards both packages'
    precision and JAX's x64 flag (which set_precision("double") turns on)
    are as they were."""
    monkeypatch.setenv("ROCQ_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("ROCQ_DF64", raising=False)
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


@pytest.fixture
def df64_layers(monkeypatch):
    """Counts the port's calls of the df64 layer wrapper (which runs the
    plain version on CPU tensors)."""
    calls = []
    wrapper = fused_df64.apply_fused_layer_df64

    def counted(*args, **kwargs):
        calls.append(1)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(fused_df64, "apply_fused_layer_df64", counted)
    return calls


def _circuits(seed):
    return (rocq.Circuit(N, rocq.Simulator(seed=seed)),
            rq.Circuit(N, rq.Simulator(seed=seed, device="cpu")))


def _mixed(c):
    """Every kernel spec kind across low, middle and high qubits (the
    circuit of tests/test_df64_fused.py), ending in a SWAP relabel."""
    n = c.num_qubits
    c.h(0)
    for q in range(n):
        c.ry(0.1 + 0.05 * q, q)
    c.cx(0, 1)
    c.cx(n - 1, 2)          # free (out-of-window) control
    c.crx(0.37, 3, n - 2)   # CU on a high target
    c.rz(0.21, n - 1)       # 1q diagonal at the top
    c.s(4)
    c.cz(1, n - 3)
    c.rzz(0.45, 2, n - 1)
    c.t(n - 4)
    c.swap(1, 2)
    return c


def test_set_precision_semantics(monkeypatch):
    want = {"single": ("single", False), "double": ("double", False),
            "df64": ("double", True)}
    for mode, (precision, df) in want.items():
        _set(mode)
        for config in (jax_config, port_config):
            assert config.get_precision() == precision
            assert config.df64_enabled() == df
        double = precision == "double"
        assert port_config.real_dtype() == (torch.float64 if double
                                            else torch.float32)
        assert port_config.complex_dtype() == (torch.complex128 if double
                                               else torch.complex64)
        assert port_config.eps() == jax_config.eps()
        # the precision at the state's creation fixes its planes
        re, im = rq.Circuit(3, rq.Simulator(device="cpu")).state
        assert re.dtype == port_config.real_dtype()
        assert (im is None) == (not double or df)
    monkeypatch.setenv("ROCQ_DF64", "1")
    _set("double")
    assert jax_config.df64_enabled() and port_config.df64_enabled()
    _set("single")
    assert not jax_config.df64_enabled() and not port_config.df64_enabled()
    with pytest.raises(ValueError):
        rq.set_precision("quad")


def test_state_made_in_single_stays_float32():
    c = rq.Circuit(4, rq.Simulator(device="cpu"))
    c.h(0)
    c.flush()
    rq.set_precision("df64")
    c.ry(0.3, 1)
    assert c.get_statevector().shape == (16,)
    assert c.state[0].dtype == torch.float32


@pytest.mark.parametrize("mode", ["df64", "double"])
def test_mixed_circuit_matches_jax(mode, df64_layers):
    _set(mode)
    cj, ct = _circuits(seed=3)
    _mixed(cj)
    _mixed(ct)
    launches = fused_df64.LAUNCHES
    got = ct.get_statevector()
    assert ct.state[0].dtype == torch.float64
    assert ct.state[1] is not None
    assert ct._layout == list(range(N))        # the SWAP relabel undone
    np.testing.assert_allclose(got, cj.get_statevector(), rtol=0, atol=ATOL)
    # df64 routes the kernel blocks through the df64 layer, double never;
    # CPU tensors launch no kernel
    assert bool(df64_layers) == (mode == "df64")
    assert fused_df64.LAUNCHES == launches


def _ring_ir():
    """One ring-ansatz layer (15 RY + 15 CNOT) with seeded angles."""
    ir = jax_circuits.hardware_efficient_ansatz_ir(N, 1)
    theta = np.random.default_rng(5).normal(size=ir.num_params)
    bound = JaxIR(N, name=ir.name)
    for op in ir.ops:
        bound.add(op.name, op.targets, op.controls,
                  [float(theta[p.index]) for p in op.params])
    return bound


def _readout(pkg, circ, ir):
    """Flush ``ir`` and read the circuit out: carry, state, expectations,
    marginals, then mid-circuit measurements and the collapsed state."""
    for op in ir.ops:
        circ._enqueue(op.name, op.targets, op.controls, op.params)
    circ.flush()
    out = {"real": circ._state[1] is None,
           "psi": np.asarray(circ.get_statevector()),
           "tfim": circ.expval(pkg.PauliOperator(
               {**{f"Z{q} Z{(q + 1) % N}": -1.0 for q in range(N)},
                **{f"X{q}": -0.5 for q in range(N)}})),
           "h2": circ.expval(pkg.PauliOperator(H2)),
           "probs": np.asarray(circ.get_probabilities(list(MEASURED)))}
    out["measure"] = [circ.measure(q) for q in MEASURED]
    out["real_after"] = circ._state[1] is None
    out["after"] = np.asarray(circ.get_statevector())
    return out


@functools.lru_cache(maxsize=None)
def _jax_ring():
    """The JAX package's df64 ring-ansatz readout, made once."""
    jax_config.set_precision("df64")
    return _readout(rocq, _circuits(seed=8)[0], _ring_ir())


def _port_ring(mode):
    _set(mode)
    return _readout(rq, _circuits(seed=8)[1],
                    convert.ir_from_reference(_ring_ir()))


def test_ring_ansatz_keeps_real_carry():
    want = _jax_ring()
    got = _port_ring("df64")
    assert want["real"] and got["real"]
    np.testing.assert_allclose(got["psi"], want["psi"], rtol=0, atol=ATOL)
    exact = _port_ring("double")               # full pair, exact per op
    assert not exact["real"]
    np.testing.assert_allclose(exact["psi"], want["psi"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["df64", "double"])
@pytest.mark.parametrize("operator", ["tfim", "h2"])
def test_expval_matches(operator, mode):
    want = _jax_ring()
    got = _port_ring(mode)
    assert abs(got[operator] - want[operator]) <= READ_TOL


@pytest.mark.parametrize("mode", ["df64", "double"])
def test_probabilities_and_measurement_match(mode):
    want = _jax_ring()
    got = _port_ring(mode)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=READ_TOL)
    for (o_got, p_got), (o_want, p_want) in zip(got["measure"],
                                                want["measure"]):
        assert o_got == o_want                 # same seed, same draws
        assert abs(p_got - p_want) <= READ_TOL
    assert got["real_after"] == (mode == "df64")
    np.testing.assert_allclose(got["after"], want["after"], rtol=0,
                               atol=ATOL)


def test_df64_plan_replay_with_new_angles(df64_layers):
    """A structurally equal df64 flush replays the cached plan with new
    float64 angles (a 1e-9 offset that float32 parameters would lose)."""
    def build(pkg, theta, **sim):
        c = pkg.Circuit(N, pkg.Simulator(seed=2, **sim))
        for q in range(N):
            c.ry(theta + 0.01 * q, q)
        c.cx(0, N - 1)
        c.rz(theta, 9)
        return c

    rq.set_precision("df64")
    port_interp.clear_cache()
    first = build(rq, 0.3, device="cpu")
    first.flush()
    plans = len(port_interp._PLAN_CACHE._data)
    second = build(rq, 0.9 + 1e-9, device="cpu")
    got = second.get_statevector()
    assert len(port_interp._PLAN_CACHE._data) == plans
    assert df64_layers
    assert not np.allclose(got, first.get_statevector())
    jax_config.set_precision("double")
    want = build(rocq, 0.9 + 1e-9).get_statevector()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_execute_df64_matches_exact_pair_engine():
    """Random mixed ops through the port's execute_df64 against the JAX
    package's exact float64 pair engine, op by op."""
    jax_config.set_precision("double")
    rng = np.random.default_rng(11)
    ir = JaxIR(N)
    names_1q = ["H", "RY", "RZ", "RX", "S", "T", "X", "Z"]
    for _ in range(25):
        kind = rng.integers(0, 4)
        q = int(rng.integers(0, N))
        q2 = int((q + 1 + rng.integers(0, N - 1)) % N)
        if kind == 0:
            name = names_1q[rng.integers(0, len(names_1q))]
            ps = [float(rng.normal())] if name[0] == "R" else []
            ir.add(name, [q], params=ps)
        elif kind == 1:
            ir.add("CNOT", [q2], controls=[q])
        elif kind == 2:
            ir.add("CRY", [q2], controls=[q], params=[float(rng.normal())])
        else:
            ir.add("CZ", [q2], controls=[q])
    re = np.zeros(1 << N)
    re[0] = 1.0
    want_re, want_im = jax.numpy.asarray(re), jax.numpy.zeros(1 << N)
    for op in ir.ops:
        want_re, want_im = jax_pairsim.apply_op_pair(want_re, want_im, op)
    planes = df64.state_from_pair_f64(
        *convert.state_from_numpy(re, None, dtype=np.float64))
    got = df64.state_to_pair_f64(port_interp.execute_df64(
        planes, convert.ir_from_reference(ir).ops))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_re), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_im), atol=ATOL)


def test_simulator_needs_cuda_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rq.Simulator()
    c = rq.Circuit(3, rq.Simulator(device="cpu"))
    c.h(0)
    c.cx(0, 2)
    psi = c.get_statevector()
    np.testing.assert_allclose(np.abs(psi[[0, 5]]), 2 ** -0.5, atol=1e-6)


def test_convert_keeps_float64():
    v = np.random.default_rng(1).normal(size=16)
    p = convert.params_from_numpy(v, dtype=np.float64)
    assert p.dtype == torch.float64
    np.testing.assert_array_equal(p.numpy(), v)
    re, im = convert.state_from_numpy(v, v[::-1], dtype=np.float64)
    assert re.dtype == im.dtype == torch.float64
    np.testing.assert_array_equal(im.numpy(), v[::-1])
    assert convert.params_from_numpy(v).dtype == torch.float32


F32, F64, C64 = torch.float32, torch.float64, torch.complex64
# (layout, precision) -> (engine, start state): api._engine's table
ENGINES = {
    ("one", "single"): ("pair32", ("planes", (F32, None))),
    ("one", "df64"): ("df64", ("planes", (F64, None))),
    ("one", "double"): ("exact", ("planes", (F64, F64))),
    ("batch", "single"): ("flat", ("batch", (C64,))),
    ("batch", "df64"): ("exact", ("batch", (F64, F64))),
    ("batch", "double"): ("exact", ("batch", (F64, F64))),
    ("sharded", "single"): ("flat", ("sharded", (C64,))),
    ("sharded", "df64"): ("df64", ("sharded", (F64, None))),
    ("sharded", "double"): ("exact", ("sharded", (F64, F64))),
}


def _made_of(state):
    """(layout, each plane's dtype or None) of a state."""
    if isinstance(state, sharded.ShardedState):
        return "sharded", tuple(None if p is None else p.dtype
                                for p in state.parts[0])
    planes = state if isinstance(state, tuple) else (state,)
    layout = "batch" if planes[0].dim() == 2 else "planes"
    return layout, tuple(None if p is None else p.dtype for p in planes)


@pytest.mark.parametrize("precision", ["single", "df64", "double"])
@pytest.mark.parametrize("layout", ["one", "batch", "sharded"])
def test_engine_table(monkeypatch, layout, precision):
    """``api._engine`` picks the engine and the start state of its table
    (a two-device CPU mesh for the sharded row); a Circuit, a compiled
    program and (unbatched) a DensityCircuit start from that state and
    flush on that engine."""
    _set(precision)
    n, cpu = 4, torch.device("cpu")
    mesh = make_mesh(2, devices=[cpu, torch.device("cpu", 0)]) \
        if layout == "sharded" else None
    b = 4 if layout == "batch" else 1
    name, start = ENGINES[layout, precision]
    engine = port_api._engine(n, cpu, b, None if mesh is None
                              else state_sharding(mesh, batch=b > 1))
    assert engine.name == name
    assert engine.dtype == (np.float32 if precision == "single"
                            else np.float64)
    assert _made_of(engine.zero()) == start

    ran = []
    for fn, tag in (("compile_pair32_ir", "pair32"), ("compile_ir", "flat"),
                    ("compile_df64_fused_ir", "df64"),
                    ("run_ops_f64", "exact"),
                    ("run_ops_f64_sharded", "exact")):
        monkeypatch.setattr(port_api, fn, functools.partial(
            lambda f, t, *a, **k: ran.append(t) or f(*a, **k),
            getattr(port_api, fn), tag))
    monkeypatch.setattr(port_dc, "_flush_exact", functools.partial(
        lambda f, *a: ran.append("exact") or f(*a), port_dc._flush_exact))
    sim = rq.Simulator(device="cpu")

    def kept(state):
        """The layout and the first plane's dtype are the start state's
        (a real carry below the kernel's size gets a zero im plane)."""
        layout, dtypes = _made_of(state)
        return (layout, dtypes[0]) == (start[0], start[1][0])

    def flushes_on_engine(circuit, state):
        ran.clear()
        circuit.ry(0.3, 0)
        circuit.cx(0, 1)
        circuit.flush()
        return set(ran) == {name} and kept(state())

    c = rq.Circuit(n, sim, batch_size=b, mesh=mesh, device=cpu)
    assert _made_of(c.state) == start
    assert flushes_on_engine(c, lambda: c.state)
    if layout == "batch":
        return
    ir = CircuitIR(n, [GateOp("RY", (0,), (), (0.3,)),
                       GateOp("CNOT", (1,), (0,))])
    ran.clear()
    program = rq.compile_program(ir, sim, mesh=mesh)
    assert _made_of(program._init_fn()) == start
    assert kept(program.run().state) and set(ran) == {name}
    dc = rq.DensityCircuit(n, sim, mesh=mesh, device=cpu)
    assert _made_of(dc._rho if dc._rho is not None
                    else dc._init_rho()) == start
    assert flushes_on_engine(dc, lambda: dc._rho)
