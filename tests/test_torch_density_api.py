"""The port's flat complex-rho API (``rocquantum_tpu_torch/ops/density.py``)
against the JAX package's (``rocquantum_tpu/ops/density.py``).

Every function of hipDensityMat's functional surface runs on the same
seeded random rho at n = 3-4 in both packages: within 1e-5 in single
precision and 1e-12 in double. The channels cover one, two, three and four
targets (the JAX package switches to its per-term path past three, the
port past two) and ``apply_kraus_at`` at permuted positions of the 2n-bit
view. ``purity`` is held to ``trace(rho @ rho)``; the JAX package's sums
``Re(rho_ij^2)``, which equals it only for a real rho (ROADMAP Queue 3),
and a case shows both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocquantum_tpu_torch as rq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.ops import density as jax_density
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.ops import density as port_density

TOL = {"single": 1e-5, "double": 1e-12}
FRACTION_TOL = 0.03
SHOTS = 20000
MODES = ("single", "double")


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


@pytest.fixture(autouse=True)
def restore_precision():
    """Afterwards both packages' precision and JAX's x64 flag are as they
    were."""
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


def _set(mode: str):
    jax_config.set_precision(mode)
    rq.set_precision(mode)


def _cdtype(mode):
    return np.complex64 if mode == "single" else np.complex128


def _random_rho(n, seed, mode, real=False):
    """A seeded random density matrix (positive, trace 1), flat."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(1 << n, 1 << n))
    if not real:
        a = a + 1j * rng.normal(size=(1 << n, 1 << n))
    rho = a @ a.conj().T
    rho /= np.trace(rho).real
    return rho.reshape(-1).astype(_cdtype(mode))


def _unitary(m, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(1 << m, 1 << m))
                        + 1j * rng.normal(size=(1 << m, 1 << m)))
    return q


def _kraus(m, terms, seed):
    """A random channel on m qubits: K_i = U_i sqrt(p_i) (sum K†K = 1)."""
    p = np.random.default_rng(seed).dirichlet(np.ones(terms))
    return [np.sqrt(pi) * _unitary(m, seed + 1 + i)
            for i, pi in enumerate(p)]


def _both(mode, n, seed, real=False):
    rho = _random_rho(n, seed, mode, real)
    return jnp.asarray(rho), convert.rho_from_reference(rho, device="cpu")


def _close(got, want, mode, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL[mode], (what, err)


@pytest.mark.parametrize("mode", MODES)
def test_state_helpers(mode):
    _set(mode)
    n = 3
    assert port_density.num_qubits_of(torch.zeros(1 << (2 * n))) == n
    assert port_density.num_qubits_of(torch.zeros(1 << n, 1 << n)) == n
    with pytest.raises(ValueError):
        port_density.num_qubits_of(torch.zeros(1 << 5))
    got = port_density.init_density(n, device="cpu")
    want = jax_density.init_density(n)
    assert got.dtype == (torch.complex64 if mode == "single"
                         else torch.complex128)
    _close(got, want, mode, "init_density")
    jrho, prho = _both(mode, n, 1)
    _close(port_density.to_matrix(prho), jax_density.to_matrix(jrho), mode)
    assert torch.equal(port_density.from_matrix(
        port_density.to_matrix(prho)), prho)


@pytest.mark.parametrize("mode", MODES)
def test_from_statevector_takes_both_signatures(mode):
    """One complex state (the JAX signature) gives the complex flat rho;
    the state's planes give rho's planes, as before."""
    _set(mode)
    rng = np.random.default_rng(4)
    psi = (rng.normal(size=8) + 1j * rng.normal(size=8))
    psi = (psi / np.linalg.norm(psi)).astype(_cdtype(mode))
    want = jax_density.from_statevector(jnp.asarray(psi))
    got = port_density.from_statevector(torch.from_numpy(psi))
    assert got.is_complex()
    _close(got, want, mode, "complex form")
    re, im = port_density.from_statevector(torch.from_numpy(psi.real.copy()),
                                           torch.from_numpy(psi.imag.copy()))
    _close(torch.complex(re, im), want, mode, "plane form")
    re, im = port_density.from_statevector(torch.from_numpy(psi.real.copy()))
    assert im is None
    _close(re, jax_density.from_statevector(jnp.asarray(psi.real)), mode,
           "real plane form")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("targets", [[0], [2], [2, 0], [1, 3, 0]])
def test_apply_matrix_dm(mode, targets):
    _set(mode)
    n = 4
    jrho, prho = _both(mode, n, 2)
    u = _unitary(len(targets), 7).astype(_cdtype(mode))
    _close(port_density.apply_matrix_dm(prho, u, targets),
           jax_density.apply_matrix_dm(jrho, jnp.asarray(u), targets), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("controls,targets", [([0], [2]), ([3, 1], [0]),
                                              ([2], [0, 3])])
def test_apply_controlled_matrix_dm(mode, controls, targets):
    _set(mode)
    n = 4
    jrho, prho = _both(mode, n, 3)
    u = _unitary(len(targets), 8).astype(_cdtype(mode))
    _close(port_density.apply_controlled_matrix_dm(prho, u, controls,
                                                   targets),
           jax_density.apply_controlled_matrix_dm(jrho, jnp.asarray(u),
                                                  controls, targets), mode)


GATES = [("H", [1], (), (), False), ("S", [0], (), (), True),
         ("RX", [2], (), (0.7,), False), ("U3", [1], (), (0.3, -1.1, 0.4),
                                           True),
         ("RZZ", [0, 2], (), (0.9,), False), ("SWAP", [2, 0], (), (), False),
         ("CNOT", [0, 2], (), (), False), ("CRY", [2, 1], (), (1.3,), False),
         ("CZ", [1], [2], (), False), ("CSWAP", [2, 0, 1], (), (), False),
         ("CCX", [0, 1, 2], (), (), False), ("X", [1], [0, 2], (), False)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,targets,controls,params,adjoint", GATES)
def test_apply_gate_dm(mode, name, targets, controls, params, adjoint):
    _set(mode)
    jrho, prho = _both(mode, 3, 5)
    _close(port_density.apply_gate_dm(prho, name, targets, controls, params,
                                      adjoint),
           jax_density.apply_gate_dm(jrho, name, targets, controls, params,
                                     adjoint), mode, name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("targets,terms", [([1], 3), ([2, 0], 4),
                                           ([0, 3, 1], 3), ([3, 1, 0, 2], 2)])
def test_apply_kraus(mode, targets, terms):
    """One and two targets on the superoperator in both packages; three on
    the port's per-term path against JAX's superoperator; four per term in
    both."""
    _set(mode)
    n = 4
    jrho, prho = _both(mode, n, 6)
    kraus = _kraus(len(targets), terms, 11)
    _close(port_density.apply_kraus(prho, kraus, targets),
           jax_density.apply_kraus(jrho, [jnp.asarray(k) for k in kraus],
                                   targets), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("row_pos,col_pos", [([5], [1]), ([0, 6], [4, 3]),
                                             ([7, 2, 4], [0, 5, 1]),
                                             ([1, 6, 3, 4], [7, 0, 5, 2])])
def test_apply_kraus_at_permuted_positions(mode, row_pos, col_pos):
    """Row and column qubits anywhere in the 2n-bit view (n = 4), as after
    a relabel."""
    _set(mode)
    jrho, prho = _both(mode, 4, 9)
    kraus = _kraus(len(row_pos), 3, 21)
    _close(port_density.apply_kraus_at(prho, kraus, row_pos, col_pos),
           jax_density.apply_kraus_at(jrho, [jnp.asarray(k) for k in kraus],
                                      row_pos, col_pos), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("channel", sorted(port_density.CHANNELS))
def test_apply_channel(mode, channel):
    _set(mode)
    jrho, prho = _both(mode, 3, 10)
    _close(port_density.apply_channel(prho, channel, 0.13, [2, 0]),
           jax_density.apply_channel(jrho, channel, 0.13, [2, 0]), mode)
    with pytest.raises(ValueError):
        port_density.apply_channel(prho, "no_such_channel", 0.1, [0])


@pytest.mark.parametrize("mode", MODES)
def test_readouts(mode):
    _set(mode)
    n = 4
    jrho, prho = _both(mode, n, 12)
    _close(port_density.probabilities_dm(prho),
           jax_density.probabilities_dm(jrho), mode, "probabilities")
    _close(port_density.trace_dm(prho), jax_density.trace_dm(jrho), mode,
           "trace")
    for qubits in ([0], [3, 1], [2, 0, 3]):
        _close(port_density.marginal_probs_dm(prho, qubits),
               jax_density.marginal_probs_dm(jrho, qubits), mode, qubits)
    for q in range(n):
        _close(port_density.prob_one_dm(prho, q),
               jax_density.prob_one_dm(jrho, q), mode, ("prob_one", q))
        _close(port_density.expval_z_dm(prho, q),
               jax_density.expval_z_dm(jrho, q), mode, ("<Z>", q))
        for outcome in (0, 1):
            _close(port_density.collapse_dm(prho, q, outcome),
                   jax_density.collapse_dm(jrho, q, outcome), mode,
                   ("collapse", q, outcome))
    for qubits in ([1], [0, 3], [2, 0, 2, 1]):
        _close(port_density.expval_pauli_product_z_dm(prho, qubits),
               jax_density.expval_pauli_product_z_dm(jrho, qubits), mode,
               qubits)
    for ops in ([("X", 0)], [("Y", 2), ("Z", 0)], [("I", 1), ("X", 3)],
                [("X", 1), ("Y", 2), ("Z", 3), ("Y", 0)],
                [("X", 2), ("Y", 2), ("Z", 1)]):
        _close(port_density.expval_pauli_string_dm(prho, ops),
               jax_density.expval_pauli_string_dm(jrho, ops), mode, ops)


@pytest.mark.parametrize("mode", MODES)
def test_purity_is_trace_of_rho_squared(mode):
    """The port's purity is Tr(rho^2) = sum |rho_ij|^2; the JAX package's
    agrees on a real rho and sums Re(rho_ij^2) on a complex one."""
    _set(mode)
    for real in (True, False):
        jrho, prho = _both(mode, 3, 13, real=real)
        m = np.asarray(jrho, np.complex128).reshape(8, 8)
        want = float(np.trace(m @ m).real)
        _close(port_density.purity(prho), want, mode, "purity")
        jax_value = float(jax_density.purity(jrho))
        if real:
            assert abs(jax_value - want) <= TOL[mode]
        else:
            assert abs(jax_value - float(np.sum((m * m).real))) <= TOL[mode]
            assert abs(jax_value - want) > 100 * TOL["single"]


@pytest.mark.parametrize("mode", MODES)
def test_sample_dm(mode):
    """int32 draws from the diagonal's marginal; equal seeds repeat."""
    _set(mode)
    jrho, prho = _both(mode, 3, 14)
    qubits = [2, 0]
    draws = port_density.sample_dm(prho, qubits, SHOTS,
                                   torch.Generator().manual_seed(3))
    assert draws.dtype == torch.int32 and draws.shape == (SHOTS,)
    again = port_density.sample_dm(prho, qubits, SHOTS,
                                   torch.Generator().manual_seed(3))
    assert torch.equal(draws, again)
    jax_draws = jax_density.sample_dm(jrho, qubits, SHOTS,
                                      jax.random.PRNGKey(3))
    assert jax_draws.dtype == jnp.int32
    marg = np.asarray(jax_density.marginal_probs_dm(jrho, qubits))
    for draw in (draws.numpy(), np.asarray(jax_draws)):
        freq = np.bincount(draw, minlength=4) / SHOTS
        assert np.max(np.abs(freq - marg)) <= FRACTION_TOL


def test_flat_rho_stays_on_its_device_and_dtype():
    """Every unitary and channel keeps the complex dtype and device."""
    rq.set_precision("single")
    rho = port_density.init_density(2, device="cpu")
    rho = port_density.apply_gate_dm(rho, "H", [0])
    rho = port_density.apply_channel(rho, "amplitude_damping", 0.2, [0, 1])
    assert rho.dtype == torch.complex64 and rho.device.type == "cpu"
    assert port_density.trace_dm(rho).dtype == torch.float64
    assert abs(float(port_density.trace_dm(rho)) - 1.0) < 1e-6


def test_init_density_needs_cuda_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_density.init_density(2)
