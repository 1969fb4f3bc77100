"""The port's density-matrix engine against the JAX package's.

``rocquantum_tpu_torch`` DensityCircuit, DensityMatrixState, the channels,
NoiseModel and the float-plane readout against ``rocquantum_tpu``'s, with
inputs made from numpy seeds:

- the host half (superoperators, their factoring into kernel kinds, the
  2n-view conjugation rules) equal to the JAX package's to 1e-15;
- single precision at n = 8 (a 2n = 16-bit view, at or above
  KERNEL_MIN_QUBITS, so the port's flush takes its kernel path through
  the fused layer's plain version and the JAX package's runs its Pallas
  kernels in interpret mode): rho within 1e-5;
- the exact double engine at n = 4 within 1e-12 of JAX's pair engine,
  and df64 at n = 8 within 1e-11 of JAX's exact engine;
- readouts at n = 3-5: measurement outcomes for equal seeds, purity,
  Pauli expectations, samples, the density matrix.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu import density_circuit as jax_dc
from rocquantum_tpu.density_state import DensityMatrixState as JaxDMS
from rocquantum_tpu.density_state import Pauli as JaxPauli
from rocquantum_tpu.dsl import NoiseModel as JaxNoiseModel
from rocquantum_tpu.ops import density as jax_density
from rocquantum_tpu.ops import pairdm as jax_pairdm
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch import density_circuit as port_dc
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.ops import density as port_density
from rocquantum_tpu_torch.ops import fused_df64, fused_sv, pairdm

F32_TOL = 1e-5
DOUBLE_TOL = 1e-12
DF64_TOL = 1e-11
PROB_TOL = 1e-6
FRACTION_TOL = 0.03


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


def _set(mode: str):
    jax_config.set_precision(mode)
    rq.set_precision(mode)


@pytest.fixture(autouse=True)
def restore_precision(monkeypatch):
    """Interpret-mode Pallas for the JAX side; afterwards both packages'
    precision and JAX's x64 flag are as they were."""
    monkeypatch.setenv("ROCQ_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("ROCQ_DF64", raising=False)
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


@pytest.fixture
def layer_calls(monkeypatch):
    """Counts the port's calls of the two fused-layer wrappers (which run
    their plain versions on CPU tensors)."""
    calls = {"f32": 0, "df64": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fused_sv, "apply_fused_layer",
                        counted("f32", fused_sv.apply_fused_layer))
    monkeypatch.setattr(fused_df64, "apply_fused_layer_df64",
                        counted("df64", fused_df64.apply_fused_layer_df64))
    return calls


def _sims(seed=0):
    return rocq.Simulator(seed=seed), rq.Simulator(seed=seed, device="cpu")


def _circuits(n, seed=0, noise=(None, None)):
    jsim, psim = _sims(seed)
    return (jax_dc.DensityCircuit(n, jsim, noise_model=noise[0]),
            rq.DensityCircuit(n, psim, noise_model=noise[1]))


def _kraus(seed, m=1, terms=2):
    """A random trace-preserving channel on m qubits: terms K_i with
    sum K_i† K_i = I."""
    rng = np.random.default_rng(seed)
    dim = 1 << m
    ks = [rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
          for _ in range(terms)]
    w, v = np.linalg.eigh(sum(k.conj().T @ k for k in ks))
    inv = v @ np.diag(w ** -0.5) @ v.conj().T
    return [k @ inv for k in ks]


def _mixed(c):
    """The mix of tests/test_density_circuit.py's fused-run test, plus
    amplitude damping, phase flip, a generic one-qubit Kraus channel, a
    two-qubit Kraus channel and a gate with no conjugation rule (RZZ)."""
    n = c.num_qubits
    for q in range(n):
        c.ry(0.1 * (q + 1), q)
    c.s(1)
    c.t(2)
    c.y(3)
    for q in range(n - 1):
        c.cx(q, q + 1)
    c.apply_channel("depolarizing", 0.02, [0])
    c.rz(0.7, 4)
    c.rx(-0.3, 5)
    c.crz(0.4, 0, 6)
    c.apply_channel("amplitude_damping", 0.05, [2, n - 1])
    c.apply_channel("phase_flip", 0.03, [1])
    c.apply_kraus(_kraus(3), [5])
    c.apply_kraus(_kraus(4, m=2), [1, 6])
    c.rzz(0.3, 2, 6)
    c.sdg(0)
    c.apply_unitary([3], np.array([[0, 1j], [1j, 0]]) * np.exp(0.2j))
    return c


def _bench(c, angle=0.3, layers=2):
    """bench.py:485's workload: RY(angle + 0.01 q) on every qubit, then
    depolarizing(0.02) on every qubit, per layer."""
    n = c.num_qubits
    for _ in range(layers):
        for q in range(n):
            c.ry(angle + 0.01 * q, q)
        c.apply_channel("depolarizing", 0.02, list(range(n)))
    return c


# -- host half ----------------------------------------------------------------

def _assert_ops_equal(port_ops, jax_ops):
    if jax_ops is None:
        assert port_ops is None
        return
    assert port_ops is not None and len(port_ops) == len(jax_ops)
    for p, j in zip(port_ops, jax_ops):
        assert (p.name, p.targets, p.controls, p.is_adjoint) == \
            (j.name, tuple(j.targets), tuple(j.controls), j.is_adjoint)
        assert len(p.params) == len(j.params)
        np.testing.assert_allclose(p.params, [float(v) for v in j.params],
                                   atol=1e-15)
        if j.matrix is None:
            assert p.matrix is None
        else:
            np.testing.assert_allclose(p.matrix, np.asarray(j.matrix),
                                       atol=1e-15)


@pytest.mark.parametrize("p", [0.0, 0.02, 0.3, 1.0])
@pytest.mark.parametrize("channel", sorted(port_density.CHANNELS))
def test_channel_factoring_matches_reference(channel, p):
    ks_port = port_density.CHANNELS[channel](p)
    ks_jax = jax_density.CHANNELS[channel](p)
    for a, b in zip(ks_port, ks_jax):
        np.testing.assert_array_equal(a, b)
    s = port_density.kraus_superoperator(ks_port)
    np.testing.assert_allclose(
        s, jax_density.kraus_superoperator(ks_jax, xp=np), atol=1e-15)
    _assert_ops_equal(port_density.superop_kernel_ops(s, 2, 7),
                      jax_density.superop_kernel_ops(s, 2, 7))


@pytest.mark.parametrize("kind", ["generic", "unitary", "two_qubit"])
def test_kraus_factoring_matches_reference(kind):
    ks = {"generic": _kraus(11), "unitary": [np.array(
        [[np.cos(0.4), -np.sin(0.4) * 1j], [-np.sin(0.4) * 1j,
                                             np.cos(0.4)]])],
          "two_qubit": _kraus(12, m=2)}[kind]
    s = port_density.kraus_superoperator(ks)
    np.testing.assert_allclose(
        s, jax_density.kraus_superoperator(ks, xp=np), atol=1e-15)
    port_ops = port_density.superop_kernel_ops(s, 0, 3)
    _assert_ops_equal(port_ops, jax_density.superop_kernel_ops(s, 0, 3))
    if kind != "unitary":
        assert port_ops is None  # dense superoperator on both sides


_RULE_GATES = (
    [(name, (1,), (), ()) for name in ("H", "X", "Z", "I", "S", "SDG", "T",
                                       "TDG", "Y")]
    + [(name, (2,), (), (0.37,)) for name in ("RY", "RX", "RZ", "P",
                                              "PHASE")]
    + [(name, (2,), (0,), ()) for name in ("CNOT", "CX", "CZ")]
    + [(name, (2,), (0,), (-0.61,)) for name in ("CRY", "CRX", "CRZ")]
    + [("SWAP", (0, 2), (), ()), ("CSWAP", (1, 2), (0,), ()),
       ("MCX", (2,), (0, 1), ()), ("U3", (1,), (), (0.3, -0.8, 1.1)),
       ("RZZ", (0, 2), (), (0.45,)), ("U3", (1,), (), (0.3, 0.2))])


@pytest.mark.parametrize("adj", [False, True])
@pytest.mark.parametrize("gate", _RULE_GATES, ids=lambda g: g[0])
def test_gate_items_2n_match_reference(gate, adj):
    name, tgt, ctrl, vals = gate
    n = 3
    assert port_dc._slot_rule(name, vals, None) == \
        jax_dc._slot_rule(name, vals, None)
    got = port_dc._gate_items_2n(n, name, tgt, ctrl, vals, None, adj)
    want = jax_dc._gate_items_2n(n, name, tgt, ctrl, vals, None, adj)
    if want[0] is None:  # no named rule
        assert got == (None, None)
        return
    _assert_ops_equal(list(got), list(want))


def test_matrix_gate_items_2n_match_reference():
    m = np.ascontiguousarray(_kraus(5, terms=1)[0], np.complex128)
    mat_key = (m.tobytes(), m.shape)
    assert port_dc._slot_rule("UNITARY", (), mat_key) is None
    for adj in (False, True):
        _assert_ops_equal(
            list(port_dc._gate_items_2n(3, "UNITARY", (1,), (0,), (),
                                        mat_key, adj)),
            list(jax_dc._gate_items_2n(3, "UNITARY", (1,), (0,), (),
                                       mat_key, adj)))


def test_from_statevector_is_the_outer_product():
    rng = np.random.default_rng(8)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    re, im = port_density.from_statevector(torch.from_numpy(psi.real),
                                           torch.from_numpy(psi.imag))
    got = (re + 1j * im).numpy().reshape(8, 8)
    np.testing.assert_allclose(got, np.outer(psi, psi.conj()), atol=1e-15)
    re, im = port_density.from_statevector(torch.from_numpy(psi.real))
    assert im is None
    np.testing.assert_allclose(re.numpy(), np.outer(psi.real,
                                                    psi.real).ravel())


# -- the flush against the JAX package ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mixed_rho(n: int, precision: str):
    """JAX's rho of the mixed queue (interpret-mode Pallas in single
    precision), computed once per (n, precision)."""
    old = _mode(jax_config)
    jax_config.set_precision(precision)
    try:
        c = _mixed(jax_dc.DensityCircuit(n, rocq.Simulator()))
        return c.get_density_matrix()
    finally:
        jax_config.set_precision(old)


def test_f32_mixed_queue_matches_reference(layer_calls):
    n = 8
    want = _jax_mixed_rho(n, "single")
    c = _mixed(rq.DensityCircuit(n, rq.Simulator(device="cpu")))
    got = c.get_density_matrix()
    assert c.state[0].dtype == torch.float32
    assert layer_calls["f32"] > 0 and layer_calls["df64"] == 0
    np.testing.assert_allclose(got, want, atol=F32_TOL)
    assert abs(np.trace(got) - 1.0) < F32_TOL
    np.testing.assert_allclose(got, got.conj().T, atol=F32_TOL)


def test_f32_bench_workload_stays_real_and_reuses_its_plan(layer_calls):
    n = 8
    p = 0.02
    c = _bench(rq.DensityCircuit(n, rq.Simulator(device="cpu")))
    c.flush()
    assert c.state[1] is None
    items = interpreter.plan_items(c.last_ir.ops, 2 * n)
    assert all(type(it).__name__ == "PallasBlock" for it in items)
    shrink = (1 - 4 * p / 3) ** 2
    z = [np.cos(2 * (0.3 + 0.01 * q)) * shrink for q in range(n)]
    for q in range(n):
        got = c.expval(rq.PauliOperator(f"Z{q}"))
        assert abs(got - z[q]) < F32_TOL
    calls = layer_calls["f32"]
    plans = len(port_dc._DM_PLAN_CACHE)
    ir = c.last_ir
    # a second request with new angles: one plan, the closed form again
    c.reset()
    _bench(c, angle=-0.7)
    c.flush()
    assert len(port_dc._DM_PLAN_CACHE) == plans and c.last_ir is ir
    assert layer_calls["f32"] == 2 * calls and c.state[1] is None
    purity = 1.0
    for q in range(n):
        r = np.cos(2 * (-0.7 + 0.01 * q)) * shrink
        r_x = np.sin(2 * (-0.7 + 0.01 * q)) * shrink
        assert abs(c.expval(rq.PauliOperator(f"Z{q}")) - r) < F32_TOL
        assert abs(c.expval(rq.PauliOperator(f"X{q}")) - r_x) < F32_TOL
        purity *= (1 + r * r + r_x * r_x) / 2
    assert abs(c.purity() - purity) < 1e-4 * purity


def test_f32_against_reference_with_hoisted_angles():
    """Two flushes of one structure with different angles (the second
    reuses the plan, its column side's signs flipped at run time) against
    the JAX package."""
    rng = np.random.default_rng(21)
    jc, pc = _circuits(8)
    for _ in range(2):
        theta = rng.normal(size=6)
        for c in (jc, pc):
            c.rx(theta[0], 0)
            c.rz(theta[1], 7)
            c._enqueue("U3", [3], params=theta[2:5])
            c.crx(theta[5], 1, 6)
            c.h(2)
            c.cz(2, 5)
            c.apply_channel("bit_flip", 0.1, [6])
            c.flush()
    np.testing.assert_allclose(pc.get_density_matrix(),
                               jc.get_density_matrix(), atol=F32_TOL)


def test_double_matches_reference_pair_engine():
    _set("double")
    n = 4
    jc, pc = _circuits(n)
    for c in (jc, pc):
        _mixed_small(c)
    got = pc.get_density_matrix()
    assert pc.state[0].dtype == torch.float64
    np.testing.assert_allclose(got, jc.get_density_matrix(),
                               atol=DOUBLE_TOL)


def _mixed_small(c):
    """A mix for n = 4: every gate family, each channel, one- and
    two-qubit Kraus channels, an adjoint matrix gate (the JAX pair engine
    compiles a three-qubit channel for ~25 s, so that one is held to numpy
    in test_wide_kraus_accumulates_per_term)."""
    c.h(0)
    c.cx(0, 1)
    c.ry(0.7, 2)
    c.rz(-0.4, 0)
    c._enqueue("U3", [1], params=(0.3, 0.9, -0.2))
    c._enqueue("S", [2], is_adjoint=True)
    c.apply_channel("depolarizing", 0.05, [0])
    c.apply_channel("amplitude_damping", 0.1, [1, 3])
    c.apply_channel("phase_flip", 0.2, [2])
    c.apply_channel("bit_flip", 0.07, [3])
    c.cry(0.25, 1, 2)
    c.crz(0.6, 3, 0)
    c.swap(0, 3)
    c.ccx(0, 1, 3)
    c.rzz(-0.35, 1, 3)
    c.apply_kraus(_kraus(6), [2])
    c.apply_kraus(_kraus(7, m=2), [3, 0])
    c._enqueue("UNITARY", [1], matrix=_kraus(10, terms=1)[0],
               is_adjoint=True)
    c.y(3)
    return c


@pytest.mark.parametrize("mode", ["double", "df64"])
def test_wide_kraus_accumulates_per_term(mode):
    """A three-qubit channel (per Kraus term in the exact engine, one dense
    superoperator on the 2n view in df64) against sum_i K_i rho K_i† in
    numpy."""
    _set(mode)
    n = 4
    c = rq.DensityCircuit(n, rq.Simulator(device="cpu"))
    for q in range(n):
        c.h(q)
        c.rx(0.2 + 0.3 * q, q)
    c.cx(0, 3)
    rho = c.get_density_matrix()
    ks = _kraus(9, m=3, terms=3)
    tgt = [0, 2, 3]
    c.apply_kraus(ks, tgt)
    got = c.get_density_matrix()
    # K on qubits tgt (tgt[0] the least significant) as a 16x16 matrix
    want = np.zeros_like(rho)
    for k in ks:
        full = np.zeros((16, 16), complex)
        for i in range(16):
            for j in range(16):
                if (i >> 1) & 1 == (j >> 1) & 1:
                    a = sum(((i >> q) & 1) << b for b, q in enumerate(tgt))
                    b_ = sum(((j >> q) & 1) << b for b, q in enumerate(tgt))
                    full[i, j] = k[a, b_]
        want += full @ rho @ full.conj().T
    np.testing.assert_allclose(got, want, atol=DF64_TOL)


def test_pair_engine_functions_match_reference():
    """pairdm's plane functions (an op with controls and an adjoint, a
    one-qubit and a two-qubit Kraus channel, a named channel) against the
    JAX package's pair engine on the same float64 rho."""
    from rocquantum_tpu.compiler.ir import GateOp as JaxGateOp
    from rocquantum_tpu_torch.compiler.ir import GateOp
    _set("double")
    n = 3
    rng = np.random.default_rng(19)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    psi /= np.linalg.norm(psi)
    rho = np.outer(psi, psi.conj()).reshape(-1)
    jre, jim = jax.numpy.asarray(rho.real), jax.numpy.asarray(rho.imag)
    re, im = convert.density_from_reference(rho)
    steps = [
        ("op", ("RY", (2,), (0,), (0.3,), False)),
        ("op", ("S", (1,), (), (), True)),
        ("op", ("U3", (0,), (), (0.3, 0.9, -0.2), False)),
        ("kraus", (_kraus(21), [1])),
        ("kraus", (_kraus(22, m=2), [2, 0])),
        ("channel", ("depolarizing", 0.1, [0, 2])),
    ]
    for kind, args in steps:
        if kind == "op":
            name, tgt, ctrl, vals, adj = args
            re, im = pairdm.apply_op_pair_dm(
                re, im, GateOp(name, tgt, ctrl, (), None, adj), n,
                params_resolved=vals)
            jre, jim = jax_pairdm.apply_op_pair_dm(
                jre, jim, JaxGateOp(name, tgt, ctrl, (), None, adj), n,
                params_resolved=vals)
        elif kind == "kraus":
            re, im = pairdm.apply_kraus_pair_dm(re, im, *args, n)
            jre, jim = jax_pairdm.apply_kraus_pair_dm(jre, jim, *args, n)
        else:
            re, im = pairdm.apply_channel_pair_dm(re, im, *args, n)
            jre, jim = jax_pairdm.apply_channel_pair_dm(jre, jim, *args, n)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=DOUBLE_TOL)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=DOUBLE_TOL)


def test_df64_matches_reference_exact_engine(layer_calls):
    n = 8
    want = _jax_mixed_rho(n, "double")
    _set("df64")
    c = _mixed(rq.DensityCircuit(n, rq.Simulator(device="cpu")))
    got = c.get_density_matrix()
    assert c.state[0].dtype == torch.float64
    assert layer_calls["df64"] > 0 and layer_calls["f32"] == 0
    np.testing.assert_allclose(got, want, atol=DF64_TOL)


def test_df64_bench_workload_stays_real():
    _set("df64")
    c = _bench(rq.DensityCircuit(8, rq.Simulator(device="cpu")))
    c.flush()
    assert c.state[1] is None
    shrink = (1 - 4 * 0.02 / 3) ** 2
    for q in (0, 7):
        want = np.cos(2 * (0.3 + 0.01 * q)) * shrink
        assert abs(c.expval(rq.PauliOperator(f"Z{q}")) - want) < 1e-13


# -- readouts -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["single", "double"])
def test_measure_sequence_matches_reference(mode):
    _set(mode)
    n = 4
    jc, pc = _circuits(n, seed=13)
    for c in (jc, pc):
        for q in range(n):
            c.h(q)
            c.ry(0.2 * q - 0.3, q)
        c.cx(0, 2)
        c.apply_channel("depolarizing", 0.1, [1, 3])
    for q in (0, 2, 1, 3, 0):
        jo, jp = jc.measure(q)
        po, pp = pc.measure(q)
        assert po == jo and abs(pp - jp) < PROB_TOL
        for c in (jc, pc):
            c.ry(0.4, q)
    tol = F32_TOL if mode == "single" else DOUBLE_TOL
    np.testing.assert_allclose(pc.get_density_matrix(),
                               jc.get_density_matrix(), atol=tol)


_OBSERVABLE = {"I": 0.3, "Z0": 0.5, "X1": -0.25, "Y2": 0.75,
               "Z0 Z2": -1.0, "X0 Y1 Z2": 0.4, "Y0 Y1": 0.2,
               "X0 X1 X2": -0.6, "Y0 X1 Y2": 0.35, "Z1 Y2": 0.15}


@pytest.mark.parametrize("mode", ["single", "double", "df64"])
def test_readouts_match_reference(mode, monkeypatch):
    if mode == "df64":
        # JAX's df64 flush of this 6-bit view in Pallas interpret mode did
        # not end within minutes; its plain df64 path is the reference here
        monkeypatch.delenv("ROCQ_PALLAS_INTERPRET")
    _set(mode)
    n = 3
    jc, pc = _circuits(n, seed=2)
    for c in (jc, pc):
        c.h(0)
        c.rx(0.9, 1)
        c.cx(0, 2)
        c.t(2)
        c.ry(-0.5, 1)
        c.apply_channel("amplitude_damping", 0.2, [0])
        c.apply_kraus(_kraus(14), [1])
    tol = F32_TOL if mode == "single" else DOUBLE_TOL
    rho = jc.get_density_matrix()
    np.testing.assert_allclose(pc.get_density_matrix(), rho, atol=tol)
    assert abs(pc.purity() - np.trace(rho @ rho).real) < tol
    if mode != "single":
        assert abs(pc.purity() - jc.purity()) < tol
    for term, coeff in _OBSERVABLE.items():
        op = {term: coeff}
        assert abs(pc.expval(rq.PauliOperator(op))
                   - jc.expval(rocq.PauliOperator(op))) < tol, term
    assert abs(pc.expval(rq.PauliOperator(_OBSERVABLE))
               - jc.expval(rocq.PauliOperator(_OBSERVABLE))) < tol


def test_pauli_trace_reads_the_f_diagonal_of_rho():
    """Tr(P rho) from 2^n entries against the dense product, repeated
    qubits and identities included, on a random Hermitian matrix."""
    rng = np.random.default_rng(5)
    n = 3
    a = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    rho = a + a.conj().T
    re, im = convert.density_from_reference(rho.reshape(-1))
    paulis = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
              "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1, -1])}
    strings = [(("X", 0),), (("Y", 1), ("Z", 2)), (("Y", 0), ("Y", 2)),
               (("X", 1), ("Y", 1)), (("I", 2), ("Y", 0), ("X", 0)),
               (("Y", 0), ("Y", 1), ("Y", 2)), (("Z", 0), ("Z", 0))]
    for ops in strings:
        mats = {q: np.eye(2) for q in range(n)}
        for ch, q in ops:
            mats[q] = paulis[ch] @ mats[q]
        full = np.kron(np.kron(mats[2], mats[1]), mats[0])
        want = np.trace(full @ rho).real
        got = float(pairdm.expval_pauli_string_pair_dm(re, im, ops, n))
        assert abs(got - want) < 1e-12, ops


@pytest.mark.parametrize("mode", ["single", "double"])
def test_sample_draws_int32_from_the_marginal(mode):
    _set(mode)
    n = 5
    c = rq.DensityCircuit(n, rq.Simulator(seed=3, device="cpu"))
    for q in range(n):
        c.ry(0.3 * q + 0.2, q)
    c.cx(1, 3)
    c.apply_channel("bit_flip", 0.2, [0, 4])
    qubits = [4, 1, 3]
    shots = 20000
    out = c.sample(qubits, shots)
    assert out.dtype == np.int32 and out.shape == (shots,)
    probs = np.real(np.diag(c.get_density_matrix()))
    marg = np.zeros(8)
    for i, p in enumerate(probs):
        marg[sum(((i >> q) & 1) << j for j, q in enumerate(qubits))] += p
    np.testing.assert_allclose(
        pairdm.marginal_probs_pair_dm(c.state[0], qubits, n).numpy(), marg,
        atol=PROB_TOL)
    frac = np.bincount(out, minlength=8) / shots
    assert np.abs(frac - marg).max() < FRACTION_TOL
    jc = jax_dc.DensityCircuit(n, rocq.Simulator(seed=3))
    for q in range(n):
        jc.ry(0.3 * q + 0.2, q)
    jc.cx(1, 3)
    jc.apply_channel("bit_flip", 0.2, [0, 4])
    jout = jc.sample(qubits, 64)
    assert jout.dtype == out.dtype


def test_reset_and_precision_at_creation():
    c = rq.DensityCircuit(3, rq.Simulator(device="cpu"))
    c.x(0)
    c.rx(0.4, 1)
    c.flush()
    assert c.state[1] is not None
    c.reset()
    re, im = c.state
    assert im is None and re.dtype == torch.float32
    assert float(re[0]) == 1.0 and float(re.abs().sum()) == 1.0
    rq.set_precision("double")
    c.h(0)  # rho made in single stays float32
    assert c.state[0].dtype == torch.float32
    c.reset()
    assert c.state[0].dtype == torch.float64 and c.state[1] is not None
    rq.set_precision("df64")
    c.reset()
    assert c.state[0].dtype == torch.float64 and c.state[1] is None


@pytest.mark.parametrize("after_op", [None, "cnot", "ry"])
def test_noise_model_matches_reference(after_op):
    noise = []
    for cls in (JaxNoiseModel, rq.NoiseModel):
        m = cls()
        m.add_channel("depolarizing", 0.05, after_op=after_op)
        m.add_channel("phase_flip", 0.1, on_qubits=[2], after_op=after_op)
        noise.append(m)
    jc, pc = _circuits(3, noise=tuple(noise))
    for c in (jc, pc):
        c.h(0)
        c.cx(0, 1)
        c.ry(0.8, 2)
        c.cx(1, 2)
    np.testing.assert_allclose(pc.get_density_matrix(),
                               jc.get_density_matrix(), atol=F32_TOL)
    assert pc.purity() < 1.0
    with pytest.raises(ValueError):
        rq.NoiseModel().add_channel("bit_flip", 1.5)


def test_errors_and_defaults(monkeypatch):
    sim = rq.Simulator(device="cpu")
    with pytest.raises(NotImplementedError):
        rq.DensityCircuit(2, sim, mesh=object())
    with pytest.raises(ValueError):
        rq.DensityCircuit(2, sim).apply_channel("nope", 0.1, [0])
    with pytest.raises(TypeError):
        rq.DensityCircuit(2, "sim")
    with pytest.raises(ValueError):
        rq.DensityMatrixState(0, device="cpu")
    assert rq.DensityCircuit(2, sim, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        rq.DensityMatrixState(2)


# -- DensityMatrixState -------------------------------------------------------

def _state_program(st, pauli):
    """Every DensityMatrixState method, on three qubits."""
    u = _kraus(15, terms=1)[0]
    st.apply_h(0)
    st.apply_x(1)
    st.apply_y(2)
    st.apply_z(0)
    st.apply_ry(0.6, 1)
    st.apply_rz(-0.9, 2)
    st.apply_cnot(0, 2)
    st.apply_gate(u, 1)
    st.apply_gate(u, 2, adjoint=True)
    st.apply_matrix(_kraus(16, m=2, terms=1)[0], [2, 0])
    st.apply_controlled_gate(u, 1, 0)
    st.apply_bit_flip_channel(0, 0.1)
    st.apply_phase_flip_channel([1, 2], 0.2)
    st.apply_depolarizing_channel([0], 0.15)
    st.apply_amplitude_damping_channel(2, 0.3)
    out = [st.compute_expectation(p, q) for p in (pauli.I, pauli.X,
                                                  pauli.Y, pauli.Z)
           for q in range(3)]
    out += [st.compute_expectation("y", 1),
            st._compute_z_product_expectation([0, 2]),
            st._compute_z_product_expectation([0, 1, 2]),
            st.compute_pauli_string_expectation([("X", 0), ("Y", 2)]),
            st.compute_pauli_string_expectation([("Y", 0), ("Z", 1),
                                                 ("X", 2)])]
    return np.array(out), st.get_density_matrix()


@pytest.mark.parametrize("mode", ["single", "double"])
def test_density_matrix_state_matches_reference(mode):
    _set(mode)
    want_ev, want_rho = _state_program(JaxDMS(3), JaxPauli)
    got_ev, got_rho = _state_program(rq.DensityMatrixState(3, device="cpu"),
                                     rq.Pauli)
    tol = F32_TOL if mode == "single" else DOUBLE_TOL
    np.testing.assert_allclose(got_rho, want_rho, atol=tol)
    np.testing.assert_allclose(got_ev, want_ev, atol=tol)


def test_bell_state_density_matrix_example():
    """examples/bell_state_density_matrix.py's two assertions."""
    st = rq.DensityMatrixState(2, device="cpu")
    st.apply_h(0)
    st.apply_cnot(0, 1)
    psi = np.zeros(4, complex)
    psi[0] = psi[3] = 2 ** -0.5
    assert np.allclose(st.get_density_matrix(), np.outer(psi, psi.conj()),
                       atol=1e-6)
    noisy = rq.DensityMatrixState(2, device="cpu")
    noisy.apply_h(0)
    noisy.apply_cnot(0, 1)
    noisy.apply_depolarizing_channel([0, 1], 0.05)
    zz = noisy._compute_z_product_expectation([0, 1])
    assert 0.5 < zz < 1.0
    ref = JaxDMS(2)
    ref.apply_h(0)
    ref.apply_cnot(0, 1)
    ref.apply_depolarizing_channel([0, 1], 0.05)
    assert abs(zz - ref._compute_z_product_expectation([0, 1])) < PROB_TOL


# -- convert ------------------------------------------------------------------

def test_density_from_reference_round_trips():
    rng = np.random.default_rng(17)
    rho = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    for value, dtype in ((rho.astype(np.complex64), torch.float32),
                         (rho.reshape(-1), torch.float64),
                         ((rho.real.ravel(), rho.imag.ravel()),
                          torch.float64)):
        re, im = convert.density_from_reference(value)
        assert re.dtype == dtype and re.shape == (16,)
        back = (re.double() + 1j * im.double()).numpy().reshape(4, 4)
        tol = 1e-6 if dtype == torch.float32 else 0.0
        np.testing.assert_allclose(back, rho, atol=tol)
    _set("double")
    jc = jax_dc.DensityCircuit(2, rocq.Simulator())
    jc.h(0)
    jc.ry(0.3, 1)
    re, im = convert.density_from_reference(jc.state)
    np.testing.assert_array_equal(
        (re + 1j * im).numpy().reshape(4, 4), jc.get_density_matrix())


def test_pairdm_readouts_match_reference_functions():
    """The port's pairdm readout functions against the JAX package's on
    one random physical rho (float64 pairs)."""
    _set("double")
    n = 3
    jc = jax_dc.DensityCircuit(n, rocq.Simulator())
    for q in range(n):
        jc.h(q)
        jc.rx(0.3 + q, q)
    jc.cx(0, 2)
    jc.apply_channel("amplitude_damping", 0.3, [1])
    jre, jim = jc.state
    re, im = convert.density_from_reference((jre, jim))
    assert abs(float(pairdm.trace_pair_dm(re, n))
               - float(jax_pairdm.trace_pair_dm(jre, n))) < DOUBLE_TOL
    assert abs(float(pairdm.purity_pair_dm(re, im))
               - float(jax_pairdm.purity_pair_dm(jre, jim))) < DOUBLE_TOL
    np.testing.assert_allclose(pairdm.probabilities_pair_dm(re, n).numpy(),
                               jax_pairdm.probabilities_pair_dm(jre, n),
                               atol=PROB_TOL)
    for q in range(n):
        assert abs(float(pairdm.prob_one_pair_dm(re, q, n))
                   - float(jax_pairdm.prob_one_pair_dm(jre, q, n))) \
            < DOUBLE_TOL
        for outcome in (0, 1):
            got = pairdm.collapse_pair_dm(re, im, q, outcome, n)
            want = jax_pairdm.collapse_pair_dm(jre, jim, q, outcome, n)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=DOUBLE_TOL)
    for qubits in ((0,), (2, 0), (1, 2, 0)):
        np.testing.assert_allclose(
            pairdm.marginal_probs_pair_dm(re, qubits, n).numpy(),
            jax_pairdm.marginal_probs_pair_dm(jre, qubits, n),
            atol=PROB_TOL)
    assert abs(float(pairdm.expval_pauli_product_z_pair_dm(re, (0, 2), n))
               - float(jax_pairdm.expval_pauli_product_z_pair_dm(
                   jre, (0, 2), n))) < DOUBLE_TOL
    ops = (("Y", 0), ("X", 2))
    assert abs(float(pairdm.expval_pauli_string_pair_dm(re, im, ops, n))
               - float(jax_pairdm.expval_pauli_string_pair_dm(
                   jre, jim, ops, n))) < DOUBLE_TOL
    terms = ((), (("Z", 1),), (("X", 0), ("Y", 1)))
    coeffs = (0.5, -1.0, 2.0)
    assert abs(float(pairdm.expval_terms_pair_dm(re, im, terms, coeffs, n))
               - float(jax_pairdm.expval_terms_pair_dm(
                   jre, jim, terms, coeffs, n))) < DOUBLE_TOL
