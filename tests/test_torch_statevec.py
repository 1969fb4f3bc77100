"""The port's flat-state primitives (rocquantum_tpu_torch/ops/statevec.py)
against the JAX package's ``rocquantum_tpu/ops/statevec.py``.

The same numpy-seeded complex states at n = 3-7, carried across by
``convert.state_from_reference``, go through every function of both.
Tolerances: complex64 amplitudes within 1e-5 of max|amp| and readouts
within 1e-5; complex128 within 1e-12; draws: int32 on both sides, the
marginal of 20,000 draws within 0.03 of the marginal probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocquantum_tpu import config as jax_config
from rocquantum_tpu.ops import gates as jax_gates
from rocquantum_tpu.ops import statevec as jsv
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.ops import statevec as sv

F32_TOL = 1e-5
F64_TOL = 1e-12
SHOTS = 20000
FREQ_TOL = 0.03


@pytest.fixture(autouse=True)
def restore_precision():
    """Afterwards both packages' precision and JAX's x64 flag are as they
    were."""
    old = (jax.config.jax_enable_x64, jax_config.get_precision(),
           port_config.get_precision())
    yield
    jax_config.set_precision(old[1])
    port_config.set_precision(old[2])
    jax.config.update("jax_enable_x64", old[0])


def _random_state(n, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (z / np.linalg.norm(z)).astype(dtype)


def _pair(n, seed, double=False):
    """(JAX state, port state) of one seeded random state."""
    if double:
        jax_config.set_precision("double")
        port_config.set_precision("double")
    psi = _random_state(n, seed, np.complex128 if double else np.complex64)
    js = jnp.asarray(psi)
    return js, convert.state_from_reference(np.asarray(js), device="cpu")


def _close(port, ref, double=False):
    ref = np.asarray(ref)
    got = port.cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1.0) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= (F64_TOL if double else F32_TOL) * scale, err


def _random_unitary(m, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(1 << m, 1 << m)) + 1j * rng.normal(
        size=(1 << m, 1 << m))
    q, _ = np.linalg.qr(z)
    return q


def test_init_and_basis_states():
    for n in (3, 5):
        _close(sv.init_state(n, device="cpu"), jsv.init_state(n))
        _close(sv.basis_state(n, 5, device="cpu"), jsv.basis_state(n, 5))
    st = sv.init_state(4, device="cpu")
    assert st.dtype == torch.complex64 and st.shape == (16,)
    port_config.set_precision("double")
    assert sv.init_state(3, device="cpu").dtype == torch.complex128


GATES = [("H", [1], [], []), ("X", [0], [], []), ("Y", [2], [], []),
         ("Z", [3], [], []), ("S", [1], [], []), ("SDG", [2], [], []),
         ("T", [0], [], []), ("TDG", [3], [], []), ("RX", [2], [], [0.3]),
         ("RY", [0], [], [-1.1]), ("RZ", [3], [], [0.7]),
         ("P", [1], [], [0.4]), ("U3", [2], [], [0.3, -0.2, 1.1]),
         ("CNOT", [0, 3], [], []), ("CNOT", [2], [4], []),
         ("CZ", [4, 1], [], []), ("CRX", [1], [3], [0.9]),
         ("CRY", [0], [2], [-0.4]), ("CRZ", [4], [0], [1.3]),
         ("MCX", [2], [0, 4], []), ("CSWAP", [1, 3], [4], []),
         ("SWAP", [0, 4], [], []), ("RZZ", [1, 2], [], [0.8])]


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("gate", GATES, ids=lambda g: f"{g[0]}{g[1]}{g[2]}")
def test_apply_gate(gate, double):
    name, targets, controls, params = gate
    js, ps = _pair(5, 11, double)
    ref = jsv.apply_gate(js, name, targets, controls, params)
    _close(sv.apply_gate(ps, name, targets, controls, params), ref, double)


@pytest.mark.parametrize("targets", [[0], [6], [3], [0, 1], [1, 0], [5, 6],
                                     [6, 5], [2, 5], [0, 1, 2], [4, 5, 6],
                                     [6, 1, 3]])
def test_apply_matrix(targets):
    """Arbitrary, low-contiguous and high-contiguous targets, in order and
    permuted (the contiguous ones in order take the port's matmul path)."""
    js, ps = _pair(7, 3)
    u = _random_unitary(len(targets), len(targets))
    _close(sv.apply_matrix(ps, u, targets),
           jsv.apply_matrix(js, jnp.asarray(u, jnp.complex64), targets))


@pytest.mark.parametrize("controls,targets", [([0], [3]), ([5, 2], [0]),
                                              ([6], [1, 4]), ([], [2, 3])])
def test_apply_controlled_matrix(controls, targets):
    js, ps = _pair(7, 4)
    u = _random_unitary(len(targets), 9)
    _close(sv.apply_controlled_matrix(ps, u, controls, targets),
           jsv.apply_controlled_matrix(js, jnp.asarray(u, jnp.complex64),
                                       controls, targets))


@pytest.mark.parametrize("double", [False, True])
def test_prob_one_collapse_and_expval_z(double):
    js, ps = _pair(6, 5, double)
    for q in (0, 3, 5):
        _close(sv.prob_one(ps, q), jsv.prob_one(js, q), double)
        _close(sv.expval_z(ps, q), jsv.expval_z(js, q), double)
        for outcome in (0, 1):
            _close(sv.collapse(ps, q, outcome), jsv.collapse(js, q, outcome),
                   double)


def test_collapse_dyn_with_a_tensor_outcome():
    js, ps = _pair(5, 6)
    for q in (0, 2, 4):
        for outcome in (0, 1):
            got = sv.collapse_dyn(ps, q, torch.tensor(outcome))
            ref = jsv.collapse_dyn(js, q, jnp.asarray(outcome, jnp.int32))
            _close(got, ref)
            _close(got, jsv.collapse(js, q, outcome))


def test_collapse_renormalization_guard():
    """Collapsing onto a zero-probability outcome gives zeros, not NaN."""
    ps = sv.basis_state(3, 0, device="cpu")
    out = sv.collapse(ps, 1, 1)
    assert torch.all(out == 0)
    _close(out, jsv.collapse(jsv.basis_state(3, 0), 1, 1))


@pytest.mark.parametrize("qubits", [[0], [4], [2, 0], [0, 2], [1, 2, 3],
                                    [3, 1, 4, 0], [0, 1, 2, 3, 4],
                                    [4, 3, 2, 1, 0], [1, 3, 0, 4, 2]])
@pytest.mark.parametrize("double", [False, True])
def test_marginal_probs(qubits, double):
    js, ps = _pair(5, 7, double)
    got = sv.marginal_probs(ps, qubits)
    assert got.dtype == torch.float64
    _close(got, jsv.marginal_probs(js, tuple(qubits)), double)


def test_marginal_rejects_duplicates():
    with pytest.raises(ValueError):
        sv.marginal_probs(sv.init_state(3, device="cpu"), [1, 1])


@pytest.mark.parametrize("qubits", [[0, 3], [4, 1, 2], list(range(6))])
def test_sample_draws_int32_from_the_marginal(qubits):
    js, ps = _pair(6, 8)
    gen = torch.Generator()
    gen.manual_seed(3)
    got = sv.sample(ps, qubits, SHOTS, gen)
    ref = jsv.sample(js, tuple(qubits), SHOTS, jax.random.PRNGKey(3))
    assert got.dtype == torch.int32 and np.asarray(ref).dtype == np.int32
    assert got.shape == (SHOTS,)
    marg = np.asarray(jsv.marginal_probs(js, tuple(qubits)))
    k = 1 << len(qubits)
    for draws in (got.numpy(), np.asarray(ref)):
        freq = np.bincount(draws, minlength=k) / SHOTS
        assert np.max(np.abs(freq - marg)) <= FREQ_TOL


def test_sample_reproducible_with_the_generator():
    _, ps = _pair(4, 9)
    draws = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(11)
        draws.append(sv.sample(ps, [0, 1, 2, 3], 64, gen))
    assert torch.equal(draws[0], draws[1])


PAULIS = [[("X", 0)], [("Y", 3)], [("Z", 2)], [("X", 1), ("Y", 4)],
          [("Z", 0), ("Z", 5)], [("Y", 2), ("X", 2)],
          [("I", 1), ("X", 3), ("Z", 4), ("Y", 0)]]


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("ops", PAULIS, ids=str)
def test_pauli_strings(ops, double):
    js, ps = _pair(6, 10, double)
    _close(sv.apply_pauli_string(ps, ops), jsv.apply_pauli_string(js, ops),
           double)
    _close(sv.expval_pauli_string(ps, ops),
           jsv.expval_pauli_string(js, ops), double)


@pytest.mark.parametrize("qubits", [[0], [2, 5], [0, 1, 3], [5, 4, 3, 2]])
def test_expval_pauli_product_z(qubits):
    js, ps = _pair(6, 12)
    _close(sv.expval_pauli_product_z(ps, qubits),
           jsv.expval_pauli_product_z(js, qubits))


def test_expval_x_and_y():
    js, ps = _pair(5, 13)
    for q in range(5):
        _close(sv.expval_x(ps, q), jsv.expval_x(js, q))
        _close(sv.expval_y(ps, q), jsv.expval_y(js, q))


def test_apply_matrix_and_measure():
    js, ps = _pair(5, 14)
    u = _random_unitary(2, 15)
    got_state, got_p = sv.apply_matrix_and_measure(ps, u, [1, 3], 3)
    ref_state, ref_p = jsv.apply_matrix_and_measure(
        js, jnp.asarray(u, jnp.complex64), [1, 3], 3)
    _close(got_state, ref_state)
    _close(got_p, ref_p)


def test_slices_and_parts():
    js, ps = _pair(6, 16)
    for start, size in ((0, 64), (8, 16), (60, 4)):
        for got, ref in zip(sv.state_slice_parts(ps, start, size),
                            jsv.state_slice_parts(js, start, size)):
            _close(got, ref)
    re, im = sv.state_to_parts(ps)
    ref_re, ref_im = jsv.state_to_parts(js)
    assert re.is_contiguous() and im.is_contiguous()
    _close(re, ref_re)
    _close(im, ref_im)
    _close(sv.parts_to_state(re, im), jsv.parts_to_state(ref_re, ref_im))


def test_index_bit_relabels():
    js, ps = _pair(6, 17)
    _close(sv.swap_index_bits(ps, 1, 4), jsv.swap_index_bits(js, 1, 4))
    _close(sv.permute_index_bits(ps, (0, 3, 5), (5, 0, 3)),
           jsv.permute_index_bits(js, (0, 3, 5), (5, 0, 3)))


def test_fixed_gate_table_matches():
    for name, mat in jax_gates.FIXED.items():
        _close(torch.as_tensor(sv._g.FIXED[name]), np.asarray(mat), True)
