"""The port's f32 Circuit path end to end against the JAX package's.

``rocquantum_tpu_torch.Circuit`` against ``rocquantum_tpu.Circuit`` at
N = 15 with the Pallas kernels in interpret mode (as
tests/test_pair32_flush.py runs the JAX path): the same IR and parameters,
carried across by ``rocquantum_tpu_torch.convert``, through both flushes.
"""

import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
from rocquantum_tpu.compiler.interpreter import clear_cache
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.ops import pairsim as jax_pairsim
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.ops import fused_sv
from rocquantum_tpu_torch.ops import pairsim as port_pairsim
from rocquantum_tpu_torch.ops import statevec as port_sv

N = 15


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("ROCQ_PALLAS_INTERPRET", "1")
    clear_cache()
    yield
    clear_cache()


def _run_ir(circ, ir):
    for op in ir.ops:
        circ._enqueue(op.name, op.targets, op.controls, op.params, op.matrix,
                      op.is_adjoint)


def _bound_ansatz(n, layers, seed):
    """Ring-ansatz IR with its ParamRefs bound to seeded angles."""
    ir = jax_circuits.hardware_efficient_ansatz_ir(n, layers)
    theta = np.random.default_rng(seed).normal(size=ir.num_params)
    bound = rocq.compiler.CircuitIR(n, name=ir.name)
    for op in ir.ops:
        bound.add(op.name, op.targets, op.controls,
                  [float(theta[p.index]) for p in op.params])
    return bound


def _tfim(module, n):
    terms = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    terms.update({f"X{q}": -0.5 for q in range(n)})
    return module.PauliOperator(terms)


def _pair_circuits(ir, seed=0):
    cj = rocq.Circuit(N, rocq.Simulator(seed=seed))
    ct = rq.Circuit(N, rq.Simulator(seed=seed, device="cpu"))
    _run_ir(cj, ir)
    _run_ir(ct, convert.ir_from_reference(ir))
    return cj, ct


def test_ring_ansatz_stays_real_and_matches():
    ir = _bound_ansatz(N, 2, seed=1)
    cj, ct = _pair_circuits(ir)
    cj.flush()
    ct.flush()
    assert cj._state[1] is None and ct.state[1] is None
    assert ct.state[0].dtype == torch.float32
    np.testing.assert_allclose(ct.get_statevector(), cj.get_statevector(),
                               atol=1e-5)
    assert abs(ct.expval(_tfim(rq, N)) - cj.expval(_tfim(rocq, N))) < 1e-5


def test_qft_basis_state_complex_d2_and_swap_restore():
    x = 0x2B3D % (1 << N)
    ir = rocq.compiler.CircuitIR(N)
    for q in range(N):
        if (x >> q) & 1:
            ir.add("X", [q])
    ir.ops.extend(jax_circuits.qft_ir(N).ops)
    cj, ct = _pair_circuits(ir)
    ct.flush()
    assert ct.state[1] is not None             # phases made it complex
    assert ct._layout != list(range(N))        # SWAPs became relabels
    psi = ct.get_statevector()
    assert ct._layout == list(range(N))
    np.testing.assert_allclose(psi, cj.get_statevector(), atol=1e-5)
    k = np.arange(1 << N)
    closed = np.exp(2j * np.pi * ((x * k) % (1 << N)) / (1 << N)) \
        / np.sqrt(1 << N)
    np.testing.assert_allclose(psi, closed, atol=1e-6)


def test_ghz_probabilities_and_samples():
    cj, ct = _pair_circuits(jax_circuits.ghz_ir(N))
    np.testing.assert_allclose(ct.get_probabilities(),
                               cj.get_probabilities(), atol=1e-6)
    np.testing.assert_allclose(ct.get_probabilities([0, N - 1]),
                               cj.get_probabilities([0, N - 1]), atol=1e-6)
    shots = 20000
    top = (1 << N) - 1
    hist_t = np.bincount(ct.sample(list(range(N)), shots) == top, minlength=2)
    hist_j = np.bincount(np.asarray(cj.sample(list(range(N)), shots)) == top,
                         minlength=2)
    tvd = 0.5 * np.abs(hist_t / shots - hist_j / shots).sum()
    assert tvd <= 0.03
    assert set(np.unique(ct.sample(list(range(N)), 500))) <= {0, top}
    assert 0.5 * np.abs(hist_t / shots - 0.5).sum() <= 0.03


def test_measure_same_outcomes_for_same_seed():
    ir = _bound_ansatz(N, 1, seed=4)
    cj, ct = _pair_circuits(ir, seed=11)
    for q in (0, 3, 7, 3):
        oj, pj = cj.measure(q)
        ot, pt = ct.measure(q)
        assert ot == oj
        assert abs(pt - pj) < 1e-5
    assert ct.state[1] is None                 # collapse keeps a real carry
    np.testing.assert_allclose(ct.get_statevector(), cj.get_statevector(),
                               atol=1e-5)


def test_small_circuit_takes_plain_path():
    """Below the kernel threshold the flush runs plain torch, like the JAX
    package runs XLA there: the state turns into a full pair."""
    ir = rocq.compiler.CircuitIR(6)
    ir.add("H", [0])
    ir.add("RY", [3], params=[0.4])
    ir.add("CNOT", [5], controls=[0])
    ir.add("SWAP", [1, 4])
    ir.add("T", [2])
    cj = rocq.Circuit(6, rocq.Simulator())
    ct = rq.Circuit(6, rq.Simulator(device="cpu"))
    _run_ir(cj, ir)
    _run_ir(ct, convert.ir_from_reference(ir))
    np.testing.assert_allclose(ct.get_statevector(), cj.get_statevector(),
                               atol=1e-6)
    assert fused_sv.LAUNCHES == 0


@pytest.mark.parametrize("term", [
    (("X", 1),), (("Y", 2),), (("Z", 0), ("Z", 4)),
    (("X", 0), ("Y", 3), ("Z", 5)), (("Y", 1), ("Y", 4)), (),
])
def test_pauli_expectations_match(term):
    rng = np.random.default_rng(len(term) + 3)
    n = 6
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    want = float(jax_pairsim.expval_terms_pair(re, im, [term], [0.7]))
    got = float(port_pairsim.expval_terms_pair(
        *convert.state_from_numpy(re, im), [term], [0.7]))
    assert abs(got - want) < 1e-5


def test_marginals_collapse_and_slices_match():
    rng = np.random.default_rng(9)
    n = 7
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    t_re, t_im = convert.state_from_numpy(re, im)
    for qubits in ([2, 0, 5], list(range(n)), [6]):
        np.testing.assert_allclose(
            port_pairsim.marginal_probs_pair(t_re, t_im, qubits).numpy(),
            np.asarray(jax_pairsim.marginal_probs_pair(re, im, qubits)),
            atol=1e-6)
    assert abs(float(port_pairsim.prob_one_pair(t_re, t_im, 4))
               - float(jax_pairsim.prob_one_pair(re, im, 4))) < 1e-6
    c_re, c_im = port_pairsim.collapse_pair(t_re, t_im, 4, 1)
    j_re, j_im = jax_pairsim.collapse_pair(re, im, 4, 1)
    np.testing.assert_allclose(c_re.numpy(), np.asarray(j_re), atol=1e-6)
    np.testing.assert_allclose(c_im.numpy(), np.asarray(j_im), atol=1e-6)
    s_re, s_im = port_pairsim.slice_pair(t_re, t_im, 5, 9)
    np.testing.assert_array_equal(s_re.numpy(), re[5:14])
    np.testing.assert_array_equal(s_im.numpy(), im[5:14])


@pytest.mark.parametrize("targets,controls", [
    ([1], []), ([0, 5], []), ([4, 2], [6]), ([3], [0, 5]),
])
def test_statevec_ops_match(targets, controls):
    import jax.numpy as jnp
    from rocquantum_tpu.ops import statevec as jax_sv
    rng = np.random.default_rng(len(targets) * 7 + len(controls))
    n = 7
    v = (rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n))
    v = (v / np.linalg.norm(v)).astype(np.complex64)
    m = len(targets)
    u, _ = np.linalg.qr(rng.normal(size=(1 << m, 1 << m))
                        + 1j * rng.normal(size=(1 << m, 1 << m)))
    want = np.asarray(jax_sv.apply_controlled_matrix(
        jnp.asarray(v), jnp.asarray(u, jnp.complex64), controls, targets))
    got = port_sv.apply_controlled_matrix(torch.from_numpy(v), u, controls,
                                          targets).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.asarray(jax_sv.swap_index_bits(jnp.asarray(v), 1, 5))
    got = port_sv.swap_index_bits(torch.from_numpy(v), 1, 5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_reset_and_readback_slice():
    c = rq.Circuit(N, rq.Simulator(device="cpu"))
    _run_ir(c, convert.ir_from_reference(_bound_ansatz(N, 1, seed=2)))
    full = c.get_statevector()
    np.testing.assert_allclose(c.get_statevector_slice(100, 50),
                               full[100:150], atol=0)
    c.reset()
    psi = c.get_statevector()
    assert psi[0] == 1 and np.count_nonzero(psi) == 1
    with pytest.raises(NotImplementedError):
        rq.set_precision("double")
