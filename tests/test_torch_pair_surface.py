"""The port's float64 pair surface and the remaining small names against
the JAX package's.

- ``ops/pairsim.py``: ``init_pair``, ``gate_rows``, ``op_rows_targets``,
  ``apply_matrix_pair``, ``apply_op_pair`` and ``compile_pair_ir`` on
  seeded random IRs at n = 5 in double precision, within 1e-12;
- ``ops/pairdm.py``: ``init_density_pair``, ``rows_conj``,
  ``expval_z_pair_dm``;
- ``ops/gates.py``: the ``*_parts`` builders against JAX's and against a
  central finite difference through autograd;
- ``relabel.plan_full_1q_layer``, ``df64.split_f64``,
  ``config.complex_from_parts`` and ``api.execute``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocquantum_tpu_torch as rq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler import interpreter as jax_interpreter
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.compiler.ir import GateOp as JaxOp
from rocquantum_tpu.ops import df64 as jax_df64
from rocquantum_tpu.ops import gates as jax_gates
from rocquantum_tpu.ops import pairdm as jax_pairdm
from rocquantum_tpu.ops import pairsim as jax_pairsim
from rocquantum_tpu_torch import api, config as port_config, convert
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.ops import df64, gates, pairdm, pairsim, relabel

TOL = 1e-12
N = 5


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


@pytest.fixture(autouse=True)
def double():
    """Both packages in double precision; afterwards their precision and
    JAX's x64 flag are as they were."""
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    jax_config.set_precision("double")
    rq.set_precision("double")
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


def _random_ir(n, seed, count=30):
    """A seeded random JAX IR over every kind the pair engines take:
    fixed and parameterized gates, implicit and explicit controls, dense
    unitaries, adjoints, SWAP, CSWAP, a multi-controlled X and D2M."""
    rng = np.random.default_rng(seed)
    ops = []

    def qubits(k):
        return [int(q) for q in rng.choice(n, size=k, replace=False)]

    for _ in range(count):
        kind = int(rng.integers(0, 10))
        if kind == 0:
            ops.append(JaxOp(str(rng.choice(["H", "X", "Y", "Z", "S", "T",
                                             "SDG", "TDG"])),
                             tuple(qubits(1)), (), (),
                             is_adjoint=bool(rng.integers(0, 2))))
        elif kind == 1:
            name = str(rng.choice(["RX", "RY", "RZ", "P"]))
            ops.append(JaxOp(name, tuple(qubits(1)), (),
                             (float(rng.normal()),),
                             is_adjoint=bool(rng.integers(0, 2))))
        elif kind == 2:
            ops.append(JaxOp("U3", tuple(qubits(1)), (),
                             tuple(float(v) for v in rng.normal(size=3))))
        elif kind == 3:
            ops.append(JaxOp("RZZ", tuple(qubits(2)), (),
                             (float(rng.normal()),)))
        elif kind == 4:
            c, t = qubits(2)
            ops.append(JaxOp(str(rng.choice(["CNOT", "CZ"])), (t,), (c,)))
        elif kind == 5:
            c, t = qubits(2)
            ops.append(JaxOp(str(rng.choice(["CRX", "CRY", "CRZ"])),
                             (c, t), (), (float(rng.normal()),)))
        elif kind == 6:
            m = int(rng.integers(1, 3))
            q, _ = np.linalg.qr(rng.normal(size=(1 << m, 1 << m))
                                + 1j * rng.normal(size=(1 << m, 1 << m)))
            ops.append(JaxOp("UNITARY", tuple(qubits(m)), (), (), q,
                             is_adjoint=bool(rng.integers(0, 2))))
        elif kind == 7:
            a, b, c = qubits(3)
            ops.append(JaxOp("SWAP", (a, b)) if rng.integers(0, 2)
                       else JaxOp("CSWAP", (c, a, b)))
        elif kind == 8:
            a, b, c = qubits(3)
            ops.append(JaxOp("MCX", (c,), (a, b)))
        else:
            v = np.exp(1j * rng.normal(size=(2, 2)))
            ops.append(JaxOp("D2M", tuple(qubits(2)), (), (), v))
    return JaxIR(n, ops)


def _random_pair(n, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    z /= np.linalg.norm(z)
    return z.real.copy(), z.imag.copy()


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL, (what, err)


def _rows_array(rows, dim):
    if rows is None:
        return np.zeros((dim, dim))
    return np.array([[float(v) for v in row] for row in rows])


def _same_rows(got, want, what=""):
    dim = len(want[0])
    for g, w in zip(got, want):
        _close(_rows_array(g, dim), _rows_array(w, dim), what)


@pytest.mark.parametrize("seed", range(3))
def test_compile_pair_ir_matches_jax(seed):
    """A parametrized random IR: the port's cached program against JAX's
    on the same planes and parameter vector; a second parameter vector
    reuses the port's program."""
    jir = _random_ir(N, seed)
    jops, values = jax_interpreter.parametrize(
        [op for op in jir.ops if op.name != "D2M"])
    jir = JaxIR(N, jops)
    pir = convert.ir_from_reference(jir)
    re, im = _random_pair(N, 50 + seed)
    fn = pairsim.compile_pair_ir(pir)
    assert pairsim.compile_pair_ir(pir) is fn
    for scale in (1.0, -0.5):
        params = np.asarray(values) * scale
        want = jax.jit(jax_pairsim.compile_pair_ir(jir))(
            jnp.asarray(re), jnp.asarray(im), jnp.asarray(params))
        got = fn(torch.from_numpy(re), torch.from_numpy(im),
                 torch.from_numpy(params))
        assert got[0].dtype == torch.float64
        _close(got[0], want[0], "re")
        _close(got[1], want[1], "im")


@pytest.mark.parametrize("seed", range(3))
def test_apply_op_pair_matches_jax_op_by_op(seed):
    jir = _random_ir(N, 10 + seed, count=20)
    pir = convert.ir_from_reference(jir)
    re, im = _random_pair(N, 60 + seed)
    jre, jim = jnp.asarray(re), jnp.asarray(im)
    pre, pim = torch.from_numpy(re), torch.from_numpy(im)
    for jop, pop in zip(jir.ops, pir.ops):
        jre, jim = jax_pairsim.apply_op_pair(jre, jim, jop)
        pre, pim = pairsim.apply_op_pair(pre, pim, pop,
                                         params_resolved=pop.params)
        _close(pre, jre, jop.name)
        _close(pim, jim, jop.name)


def test_apply_op_pair_takes_resolved_parameters():
    jop = JaxOp("RX", (2,), (), (0.0,))
    pop = convert.ir_from_reference(JaxIR(N, [jop])).ops[0]
    re, im = _random_pair(N, 7)
    want = jax_pairsim.apply_op_pair(jnp.asarray(re), jnp.asarray(im), jop,
                                     params_resolved=(0.83,))
    got = pairsim.apply_op_pair(torch.from_numpy(re), torch.from_numpy(im),
                                pop, params_resolved=(0.83,))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("name,params", [
    ("H", ()), ("X", ()), ("CX", ()), ("CNOT", ()), ("Y", ()), ("S", ()),
    ("TDG", ()), ("SWAP", ()), ("RX", (0.4,)), ("RY", (-1.2,)),
    ("RZ", (2.2,)), ("P", (0.6,)), ("PHASE", (-0.3,)), ("RZZ", (0.9,)),
    ("U3", (0.1, 0.7, -2.0))])
def test_gate_rows_match_jax(name, params):
    got = pairsim.gate_rows(name, params)
    want = jax_pairsim.gate_rows(name, params)
    _same_rows(got, want, name)
    assert (got[1] is None) == (want[1] is None)
    with pytest.raises(ValueError):
        pairsim.gate_rows("NOPE")


@pytest.mark.parametrize("seed", range(2))
def test_op_rows_targets_match_jax(seed):
    jir = _random_ir(N, 20 + seed)
    pir = convert.ir_from_reference(jir)
    for jop, pop in zip(jir.ops, pir.ops):
        if jop.name == "D2M":
            continue  # its matrix holds diagonal values, not a gate
        got = pairsim.op_rows_targets(pop)
        want = jax_pairsim.op_rows_targets(jop, dtype=jnp.float64)
        assert list(got[2]) == list(want[2]), jop
        _same_rows(got[:2], want[:2], jop.name)


@pytest.mark.parametrize("targets", [[1], [4, 0], [2, 3, 1]])
def test_apply_matrix_pair_matches_jax(targets):
    rng = np.random.default_rng(len(targets))
    dim = 1 << len(targets)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim))
                        + 1j * rng.normal(size=(dim, dim)))
    m_re, m_im = q.real.tolist(), q.imag.tolist()
    re, im = _random_pair(N, 8)
    for mi in (m_im, None):
        want = jax_pairsim.apply_matrix_pair(jnp.asarray(re), jnp.asarray(im),
                                             m_re, mi, targets)
        got = pairsim.apply_matrix_pair(torch.from_numpy(re),
                                        torch.from_numpy(im), m_re, mi,
                                        targets)
        _close(got[0], want[0])
        _close(got[1], want[1])
    # a real state under a real matrix stays real
    got = pairsim.apply_matrix_pair(torch.from_numpy(re), None, m_re, None,
                                    targets)
    assert got[1] is None


def test_init_pair():
    re, im = pairsim.init_pair(N, device="cpu")
    jre, jim = jax_pairsim.init_pair(N)
    assert re.dtype == torch.float64
    _close(re, jre)
    _close(im, jim)
    re32, _ = pairsim.init_pair(N, dtype=torch.float32, device="cpu")
    assert re32.dtype == torch.float32 and float(re32[0]) == 1.0


def test_pairdm_small_names():
    n = 2
    re, im = pairdm.init_density_pair(n, device="cpu")
    jre, jim = jax_pairdm.init_density_pair(n)
    _close(re, jre)
    _close(im, jim)
    m_re, m_im = pairsim.gate_rows("U3", (0.3, 0.2, -0.4))
    _same_rows(pairdm.rows_conj(m_re, m_im),
               jax_pairdm.rows_conj(*jax_pairsim.gate_rows(
                   "U3", (0.3, 0.2, -0.4))))
    assert pairdm.rows_conj(m_re, None) == (m_re, None)
    rng = np.random.default_rng(3)
    rho = rng.normal(size=1 << (2 * n))
    for q in range(n):
        _close(pairdm.expval_z_pair_dm(torch.from_numpy(rho), q, n),
               jax_pairdm.expval_z_pair_dm(jnp.asarray(rho), q, n))


PARTS = [("rx_parts", (0.4,)), ("ry_parts", (-1.1,)), ("rz_parts", (2.3,)),
         ("phase_parts", (0.8,)), ("rzz_parts", (-0.6,)),
         ("u3_parts", (0.5, -0.2, 1.4))]


@pytest.mark.parametrize("name,params", PARTS)
def test_parts_match_jax(name, params):
    got = getattr(gates, name)(*params)
    want = getattr(jax_gates, name)(*params)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float64
            _close(g, w, name)
    assert set(gates.PARAMETERIZED_PARTS) == set(jax_gates.PARAMETERIZED_PARTS)


@pytest.mark.parametrize("name,params", PARTS)
def test_parts_gradient_matches_finite_difference(name, params):
    """d(parts)/d(angle k) through autograd against a central difference."""
    fn = getattr(gates, name)
    h = 1e-6
    for k in range(len(params)):
        args = [torch.tensor(p, dtype=torch.float64, requires_grad=True)
                for p in params]
        out = [p for p in fn(*args) if p is not None]
        weights = [torch.from_numpy(np.random.default_rng(k).normal(
            size=tuple(p.shape))) for p in out]
        total = sum(torch.sum(w * p) for w, p in zip(weights, out))
        (grad,) = torch.autograd.grad(total, args[k])

        def value(shift):
            shifted = list(params)
            shifted[k] += shift
            parts = [p for p in fn(*shifted) if p is not None]
            return float(sum(torch.sum(w * p)
                             for w, p in zip(weights, parts)))

        fd = (value(h) - value(-h)) / (2 * h)
        assert abs(float(grad) - fd) < 1e-8, (name, k, float(grad), fd)


def test_parts_follow_the_precision():
    rq.set_precision("single")
    re, im = gates.rx_parts(0.3)
    assert re.dtype == im.dtype == torch.float32


def test_plan_full_1q_layer_is_the_full_layer_of_one_qubit_gates():
    n, qubits = 12, [0, 3, 11, 7, 9, 2]
    got = relabel.plan_full_1q_layer(n, qubits, reach=7)
    assert got == relabel.plan_full_layer(n, [(q,) for q in qubits], 7)
    assert sorted(i for p in got for i in p.gate_idx) == list(range(6))


def test_split_f64():
    v = 1.0 / 3.0
    assert df64.split_f64(v) == jax_df64.split_f64(v)
    x = np.random.default_rng(1).normal(size=64)
    hi, lo = df64.split_f64(torch.from_numpy(x))
    jhi, jlo = jax_df64.split_f64(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.float32
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))


def test_complex_from_parts():
    re, im = np.arange(4.0), -np.arange(4.0)
    got = port_config.complex_from_parts(torch.from_numpy(re),
                                         torch.from_numpy(im))
    want = jax_config.complex_from_parts(re, im)
    assert got.dtype == torch.complex128
    _close(got.real, np.real(want))
    _close(got.imag, np.imag(want))
    assert port_config.complex_from_parts(
        re, im, torch.complex64).dtype == torch.complex64


def test_api_execute_is_the_flat_engine():
    assert api.execute is interpreter.execute
