"""Batched circuits, ``Circuit(n, sim, batch_size=b)``, against the JAX
package's (the unsharded classes of tests/test_batched.py,
TestBatchedMeasurement and TestBatchedPair).

The same gate calls go to both packages' circuits. Tolerances: states
within 1e-6 (single precision) and 1e-12 (double); measured outcome arrays
equal for the same seed, their probabilities within 1e-6 / 1e-12;
``(b,)`` expectations within 1e-5 relative of a complex128 sum over the
JAX package's state (its own single-precision sum is float32); ``(b,
2^k)`` probabilities within the state tolerances; ``(b, shots)`` int32
draws, per element, within 4 sigma of the JAX package's probabilities (the
draws come from different generators). At n = 15 the port's plan holds
kernel blocks, run through the batched fused layer's plain version on the
CPU, against the JAX package's Pallas kernels in interpret mode, within
1e-5. Below the Circuit: ``ops/statevec.py`` on a ``(b, 2^n)`` state
against ``jax.vmap`` of the JAX functions, and ``ops/pairsim.py``'s
batched double twins against the JAX package's on its flat padded pair.
"""

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu as rocq
import rocquantum_tpu_torch as rq
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch.compiler import interpreter
from rocquantum_tpu_torch.ops import fused_sv

B = 3
F32_TOL = 1e-6
F64_TOL = 1e-12
KERNEL_TOL = 1e-5
EXPVAL_RTOL = 1e-5


@pytest.fixture(autouse=True)
def restore_precision():
    """Afterwards both packages' precision and JAX's x64 flag (which
    set_precision("double") turns on) are as they were."""
    old = (jax_config.get_precision(), port_config.get_precision(),
           port_config.df64_enabled(), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    port_config.set_precision("df64" if old[2] else old[1])
    jax.config.update("jax_enable_x64", old[3])


def _precision(mode):
    jax_config.set_precision("double" if mode == "df64" else mode)
    port_config.set_precision(mode)


def _pair(n, b, seed=0):
    """(JAX circuit, port circuit) with simulators of one seed."""
    return (rocq.Circuit(n, rocq.Simulator(seed=seed), batch_size=b),
            rq.Circuit(n, rq.Simulator(seed=seed, device="cpu"),
                       batch_size=b))


def _gates(circ, theta=0.41):
    """A circuit with real, complex, controlled, diagonal and SWAP gates
    on five qubits."""
    circ.h(0)
    circ.cx(0, 1)
    circ.ry(theta, 2)
    circ.rx(0.3, 3)
    circ.crz(0.7, 2, 4)
    circ.swap(1, 3)
    circ.rzz(0.5, 0, 4)
    circ.t(2)
    circ.ccx(0, 2, 3)


def _expval_c128(state, terms):
    """sum_k c_k <psi|P_k|psi> in complex128 for each row of ``state``."""
    n = state.shape[-1].bit_length() - 1
    paulis = {"X": np.array([[0, 1], [1, 0]]),
              "Y": np.array([[0, -1j], [1j, 0]]),
              "Z": np.diag([1, -1])}
    out = np.zeros(state.shape[0])
    for ops, c in terms:
        phi = state.astype(np.complex128).reshape((-1,) + (2,) * n)
        for ch, q in ops:
            phi = np.moveaxis(np.tensordot(paulis[ch], phi,
                                           axes=([1], [n - q])), 0, n - q)
        out += c * np.real(np.sum(np.conj(state) * phi.reshape(
            state.shape), axis=-1))
    return out


def test_batch_size_below_one_raises():
    with pytest.raises(ValueError):
        rq.Circuit(2, rq.Simulator(device="cpu"), batch_size=0)
    with pytest.raises(ValueError):
        rocq.Circuit(2, rocq.Simulator(), batch_size=0)


@pytest.mark.parametrize("mode", ["single", "double", "df64"])
def test_statevector_matches_reference(mode):
    _precision(mode)
    jc, pc = _pair(5, B)
    for c in (jc, pc):
        _gates(c)
    want = jc.get_statevector()
    got = pc.get_statevector()
    assert got.shape == want.shape == (B, 1 << 5)
    tol = F32_TOL if mode == "single" else F64_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if mode == "single":
        assert pc.state.dtype == torch.complex64 and pc.state.dim() == 2
    else:
        assert isinstance(pc.state, tuple)
        assert pc.state[0].dtype == torch.float64
        assert pc.state[0].shape == (B, 1 << 5)


@pytest.mark.parametrize("mode", ["single", "double"])
def test_measure_collapses_each_element(mode):
    """Per-element draws in element order: the same outcome array as the
    JAX package for one seed, each element collapsed to its outcome, and
    the collapse feeding the next flush."""
    _precision(mode)
    tol = F32_TOL if mode == "single" else F64_TOL
    for seed in (5, 11):
        jc, pc = _pair(3, B, seed)
        for c in (jc, pc):
            c.h(0)
            c.ry(0.8, 2)
        jo, jp = jc.measure(0)
        po, pp = pc.measure(0)
        assert po.shape == (B,) and pp.shape == (B,)
        np.testing.assert_array_equal(po, np.asarray(jo))
        np.testing.assert_allclose(pp, np.asarray(jp), atol=tol)
        jo2, jp2 = jc.measure(2)
        po2, pp2 = pc.measure(2)
        np.testing.assert_array_equal(po2, np.asarray(jo2))
        np.testing.assert_allclose(pp2, np.asarray(jp2), atol=tol)
        for c in (jc, pc):
            c.cx(0, 1)
        states = pc.get_statevector()
        np.testing.assert_allclose(states, jc.get_statevector(), atol=tol)
        for b in range(B):
            idx = int(po[b]) * 3 + 4 * int(po2[b])  # |00x> or |11x>
            assert abs(abs(states[b][idx]) - 1.0) < tol


@pytest.mark.parametrize("mode", ["single", "double"])
def test_slice_and_probabilities(mode):
    _precision(mode)
    tol = F32_TOL if mode == "single" else F64_TOL
    jc, pc = _pair(5, B)
    for c in (jc, pc):
        _gates(c)
    sl = pc.get_statevector_slice(3, 9)
    assert sl.shape == (B, 9)
    np.testing.assert_allclose(sl, jc.get_statevector_slice(3, 9), atol=tol)
    for qubits in (None, [0, 1], [4, 0, 2]):
        got = pc.get_probabilities(qubits)
        want = jc.get_probabilities(qubits)
        k = 5 if qubits is None else len(qubits)
        assert got.shape == (B, 1 << k)
        np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("mode", ["single", "double"])
def test_expval_per_element(mode):
    _precision(mode)
    jc, pc = _pair(5, B)
    for c in (jc, pc):
        _gates(c)
        c.measure(2)  # the elements differ from here on
        c.ry(0.9, 2)
    op_terms = {"Z0 Z1": 1.0, "X2": 0.5, "Y3 Z4": -0.25, "X0 Y1 Z2": 0.75}
    got = pc.expval(rq.PauliOperator(op_terms))
    assert got.shape == (B,)
    terms = [([(s[0], int(s[1:])) for s in k.split()], v)
             for k, v in op_terms.items()]
    want = _expval_c128(jc.get_statevector(), terms)
    np.testing.assert_allclose(got, want, rtol=EXPVAL_RTOL,
                               atol=EXPVAL_RTOL)
    if mode == "double":
        np.testing.assert_allclose(
            got, np.asarray(jc.expval(rocq.PauliOperator(op_terms))),
            atol=F64_TOL)


@pytest.mark.parametrize("mode", ["single", "double"])
def test_sampling_per_element(mode):
    """(b, shots) int32 draws, each element drawn from its own marginal
    (the elements differ after a measurement), within 4 sigma of the JAX
    package's probabilities."""
    _precision(mode)
    shots = 4000
    jc, pc = _pair(3, B, seed=3)
    for c in (jc, pc):
        c.h(0)
        c.ry(1.1, 1)
        c.measure(0)
        c.cx(0, 2)
    out = pc.sample([0, 1, 2], shots)
    assert out.shape == (B, shots) and out.dtype == np.int32
    probs = jc.get_probabilities([0, 1, 2])
    for b in range(B):
        freq = np.bincount(out[b], minlength=8) / shots
        sigma = np.sqrt(probs[b] * (1 - probs[b]) / shots)
        assert np.all(np.abs(freq - probs[b]) <= 4 * sigma + 1e-12)
    counts = pc.sample_counts([0], 100)
    assert set(counts) <= {"0", "1"} and sum(counts.values()) == B * 100


def test_reset_returns_every_element_to_zero():
    jc, pc = _pair(4, B)
    for c in (jc, pc):
        c.h(1)
        c.measure(1)
        c.reset()
        c.x(3)
    np.testing.assert_allclose(pc.get_statevector(), jc.get_statevector(),
                               atol=F32_TOL)


@pytest.fixture
def batched_layers(monkeypatch):
    """Records the plane shapes of every fused-layer call."""
    shapes = []
    wrapped = fused_sv.apply_fused_layer

    def recording(re, im, *args, **kwargs):
        shapes.append(tuple(re.shape))
        return wrapped(re, im, *args, **kwargs)

    monkeypatch.setattr(fused_sv, "apply_fused_layer", recording)
    return shapes


def test_kernel_path_matches_reference_at_n15(monkeypatch, batched_layers):
    """n = 15, b = 3: the port's batched flush plans kernel blocks whose
    passes take (3, 2^15) planes; the JAX package runs its batched Pallas
    kernels in interpret mode. Each element within 1e-5."""
    monkeypatch.setenv("ROCQ_PALLAS_INTERPRET", "1")
    jax_interp.clear_cache()
    interpreter.clear_cache()
    n = 15
    jc, pc = _pair(n, B, seed=2)
    rng = np.random.default_rng(15)
    theta = rng.normal(size=2 * n)
    for c in (jc, pc):
        c.h(0)
        c.measure(0)  # elements differ before the kernel blocks run
        for q in range(n):
            c.ry(float(theta[q]), q)
        for q in range(n - 1):
            c.cx(q, q + 1)
        for q in range(n):
            c.rz(float(theta[n + q]), q)
        c.cx(n - 1, 0)
    got = pc.get_statevector()
    want = jc.get_statevector()
    assert batched_layers and all(s == (B, 1 << n) for s in batched_layers)
    np.testing.assert_allclose(got, want, atol=KERNEL_TOL)
    jax_interp.clear_cache()
    interpreter.clear_cache()


def _random_batch(n, b, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(dtype)


def _unitary(k, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k)))
    return q


def test_statevec_batch_axis_matches_the_vmapped_reference():
    """ops/statevec.py on a (b, 2^n) state against jax.vmap of the JAX
    package's functions (float32, within 1e-6): gates on low, high and
    scattered targets, controls, a relabel, a named gate; P(1), a
    per-element collapse, marginals and slices."""
    import jax.numpy as jnp

    from rocquantum_tpu.ops import statevec as jsv
    from rocquantum_tpu_torch.ops import statevec as sv

    n = 5
    host = _random_batch(n, B, 5)
    state, jstate = torch.from_numpy(host), jnp.asarray(host)
    u2, u1 = _unitary(4, 1), _unitary(2, 2)
    cases = [
        (lambda s: sv.apply_matrix(s, u2, [0, 1]),
         lambda s: jsv.apply_matrix(s, jnp.asarray(u2, s.dtype), [0, 1])),
        (lambda s: sv.apply_matrix(s, u2, [3, 4]),
         lambda s: jsv.apply_matrix(s, jnp.asarray(u2, s.dtype), [3, 4])),
        (lambda s: sv.apply_matrix(s, u2, [4, 1]),
         lambda s: jsv.apply_matrix(s, jnp.asarray(u2, s.dtype), [4, 1])),
        (lambda s: sv.apply_controlled_matrix(s, u1, [0, 3], [2]),
         lambda s: jsv.apply_controlled_matrix(
             s, jnp.asarray(u1, s.dtype), [0, 3], [2])),
        (lambda s: sv.permute_index_bits(s, (1, 3, 4), (3, 4, 1)),
         lambda s: jsv.permute_index_bits(s, (1, 3, 4), (3, 4, 1))),
        (lambda s: sv.apply_gate(s, "CRZ", [2], [4], [0.7]),
         lambda s: jsv.apply_gate(s, "CRZ", [2], [4], [0.7])),
    ]
    for port_fn, jax_fn in cases:
        got = port_fn(state)
        assert got.shape == (B, 1 << n)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax.vmap(jax_fn)(jstate)),
                                   atol=F32_TOL)
    p1 = sv.prob_one(state, 3)
    assert p1.shape == (B,)
    np.testing.assert_allclose(
        p1.numpy(), np.asarray(jax.vmap(lambda s: jsv.prob_one(s, 3))(jstate)),
        atol=F32_TOL)
    outcomes = np.array([1, 0, 1], np.int32)
    np.testing.assert_allclose(
        sv.collapse_dyn(state, 3, torch.from_numpy(outcomes)).numpy(),
        np.asarray(jax.vmap(lambda s, o: jsv.collapse_dyn(s, 3, o))(
            jstate, jnp.asarray(outcomes))), atol=F32_TOL)
    marg = sv.marginal_probs(state, [4, 0, 2])
    assert marg.shape == (B, 8) and marg.dtype == torch.float64
    np.testing.assert_allclose(
        marg.numpy(), np.asarray(jax.vmap(
            lambda s: jsv.marginal_probs(s, [4, 0, 2]))(jstate)),
        atol=F32_TOL)
    re, im = sv.state_slice_parts(state, 5, 7)
    jre, jim = jax.vmap(lambda s: jsv.state_slice_parts(s, 5, 7))(jstate)
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    gen = torch.Generator().manual_seed(0)
    draws = sv.sample(state, [0, 1], 50, gen)
    assert draws.shape == (B, 50) and draws.dtype == torch.int32


def test_pair_batched_twins_match_the_reference():
    """The batched double twins of ops/pairsim.py on (b, 2^n) float64
    planes against the JAX package's on its flat padded pair of the same
    amplitudes (b = 3 padded to 4 rows): the same shapes and values
    within 1e-12."""
    import jax.numpy as jnp

    from rocquantum_tpu.ops import pairsim as jps
    from rocquantum_tpu_torch.ops import pairsim as ps

    jax_config.set_precision("double")
    port_config.set_precision("double")
    n = 4
    host = _random_batch(n, B, 7, np.complex128)
    re, im = (torch.from_numpy(np.ascontiguousarray(x))
              for x in (host.real, host.imag))
    flat = [jnp.asarray(np.concatenate([x, np.zeros((1, 1 << n))]).ravel())
            for x in (host.real, host.imag)]
    np.testing.assert_array_equal(
        ps.init_pair_batched(n, B, torch.float64)[0].numpy(),
        np.asarray(jps.init_pair_batched(n, B)[0]).reshape(-1, 1 << n)[:B])
    np.testing.assert_allclose(
        ps.prob_one_pair_batched(re, im, 2, n, B).numpy(),
        np.asarray(jps.prob_one_pair_batched(*flat, 2, n, B)),
        atol=F64_TOL)
    outcomes = np.array([0, 1, 1])
    got = ps.collapse_pair_batched(re, im, 2, torch.from_numpy(outcomes),
                                   n, B)
    want = jps.collapse_pair_batched(*flat, 2, jnp.asarray(outcomes), n, B)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w).reshape(-1, 1 << n)[:B], atol=F64_TOL)
    terms = ((("Z", 0), ("Z", 1)), (("X", 2),), (("Y", 3), ("X", 0)), ())
    coeffs = (1.0, 0.5, -0.25, 0.125)
    np.testing.assert_allclose(
        ps.expval_terms_pair_batched(re, im, terms, coeffs, n, B).numpy(),
        np.asarray(jps.expval_terms_pair_batched(*flat, terms, coeffs, n,
                                                 B)), atol=F64_TOL)
    for qubits in ([0, 2], list(range(n))):
        np.testing.assert_allclose(
            ps.marginal_probs_pair_batched(re, im, qubits, n, B).numpy(),
            np.asarray(jps.marginal_probs_pair_batched(*flat, qubits, n,
                                                       B)), atol=F64_TOL)
    for g, w in zip(ps.slice_pair_batched(re, im, 3, 6, n, B),
                    jps.slice_pair_batched(*flat, 3, 6, n, B)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ps.statevector_pair_batched(re, im, n, B),
                    jps.statevector_pair_batched(*flat, n, B)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    draws = ps.sample_pair_batched(re, im, [1, 3], 40,
                                   torch.Generator().manual_seed(1), n, B)
    assert draws.shape == (B, 40) and draws.dtype == torch.int32
    with pytest.raises(ValueError):
        ps.prob_one_pair_batched(re, im, 2, n, B + 1)
