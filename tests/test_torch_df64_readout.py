"""The port's df64 readout twins and compile_df64_ir against the JAX
package's (``rocquantum_tpu/ops/df64.py``).

The same df64 state, made from a numpy seed and split by the JAX package,
goes to both packages (``convert.df64_from_reference``); the port also
reads it as a real carry (imaginary planes ``None``) where the state is
real. Readouts agree within 1e-12; ``compile_df64_ir`` runs an IR with
complex gates, controls, a D2M diagonal and SWAP_BITS / PERMUTE_BITS
relabels and agrees within 1e-12 of the JAX program.
"""

import jax
import numpy as np
import pytest
import torch

from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.compiler.ir import ParamRef as JaxParamRef
from rocquantum_tpu.ops import df64 as jax_df64
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.ops import df64
from rocquantum_tpu_torch.parallel import (make_mesh, shard_state, sharded,
                                           state_sharding)

N = 6
TOL = 1e-12
TERMS = [(), (("Z", 0),), (("Z", 1), ("Z", 4)), (("X", 2),),
         (("Y", 3), ("Y", 5)), (("X", 0), ("Z", 1), ("Y", 2)), (("I", 3),)]
COEFFS = [0.25, -1.0, 0.5, -0.5, 0.75, 0.3, 1.5]


@pytest.fixture(autouse=True)
def jax_double():
    """The JAX df64 functions need jax_enable_x64 (set_precision turns it
    on and leaves it on); JAX's precision and x64 flag are restored."""
    old = (jax_config.get_precision(), jax_config.df64_enabled(),
           jax.config.jax_enable_x64)
    jax_config.set_precision("double")
    yield
    jax_config.set_precision("df64" if old[1] else old[0])
    jax.config.update("jax_enable_x64", old[2])


def _states(seed, real):
    """(JAX df64 state, port planes) of one normalized random state; the
    port's is a real carry when ``real``."""
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << N)
    if not real:
        psi = psi + 1j * rng.normal(size=1 << N)
    psi = psi / np.linalg.norm(psi)
    jax_state = jax_df64.state_from_pair_f64(
        jax.numpy.asarray(psi.real), jax.numpy.asarray(np.imag(psi)))
    planes = convert.df64_from_reference(jax_state)
    if real:
        planes = (planes[0], planes[1], None, None)
    return jax_state, planes


def _f(x):
    return float(np.asarray(x))


@pytest.mark.parametrize("real", [False, True])
def test_readout_twins_match_reference(real):
    jax_state, planes = _states(1, real)
    assert abs(_f(df64.norm2_df64(planes)) - 1.0) <= TOL
    assert abs(_f(df64.norm2_df64(planes))
               - _f(jax_df64.norm2_df64(jax_state))) <= TOL
    np.testing.assert_allclose(df64.probs_df64(planes).numpy(),
                               np.asarray(jax_df64.probs_df64(jax_state)),
                               rtol=0, atol=TOL)
    for qubits in ([0], [1, 4], [0, 2, 5]):
        assert abs(_f(df64.expval_pauli_product_z_df64(planes, qubits))
                   - _f(jax_df64.expval_pauli_product_z_df64(
                       jax_state, qubits))) <= TOL
    for term in TERMS[1:]:
        assert abs(_f(df64.expval_pauli_string_df64(planes, term))
                   - _f(jax_df64.expval_pauli_string_df64(
                       jax_state, term))) <= TOL
    got = df64.expval_terms_df64(planes, TERMS, COEFFS)
    assert got.dtype == torch.float64
    assert abs(_f(got) - _f(jax_df64.expval_terms_df64(
        jax_state, TERMS, COEFFS))) <= TOL
    for q in range(N):
        assert abs(_f(df64.prob_one_df64(planes, q))
                   - _f(jax_df64.prob_one_df64(jax_state, q))) <= TOL


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("qubit,outcome", [(0, 1), (3, 0), (5, 1)])
def test_collapse_matches_reference(real, qubit, outcome):
    jax_state, planes = _states(2, real)
    want = jax_df64.state_to_pair_f64(
        jax_df64.collapse_df64(jax_state, qubit, outcome))
    got = df64.collapse_df64(planes, qubit, outcome)
    assert (got[2] is None) == real
    assert all(p is None or p.dtype == torch.float32 for p in got)
    re, im = df64.state_to_pair_f64(got)
    np.testing.assert_allclose(re.numpy(), np.asarray(want[0]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(np.zeros(1 << N) if im is None else im.numpy(),
                               np.asarray(want[1]), rtol=0, atol=TOL)
    assert abs(_f(df64.norm2_df64(got)) - 1.0) <= TOL
    assert abs(_f(df64.prob_one_df64(got, qubit)) - outcome) <= TOL


@pytest.mark.parametrize("real", [False, True])
def test_sample_dtype_support_and_frequencies(real):
    _, planes = _states(3, real)
    qubits = [1, 4]
    probs = df64.probs_df64(planes).numpy()
    idx = np.arange(1 << N)
    marg = np.zeros(4)
    np.add.at(marg, ((idx >> 1) & 1) | (((idx >> 4) & 1) << 1), probs)
    gen = torch.Generator().manual_seed(0)
    shots = 20000
    draws = df64.sample_df64(planes, qubits, shots, gen)
    assert draws.dtype == torch.int32 and draws.shape == (shots,)
    freq = np.bincount(draws.numpy(), minlength=4) / shots
    assert freq.shape == (4,)
    assert np.abs(freq - marg).max() <= 0.02
    # a collapsed qubit is drawn with certainty
    one = df64.collapse_df64(planes, 4, 1)
    assert set(df64.sample_df64(one, [4], 100, gen).tolist()) == {1}


def test_init_df64():
    got = df64.init_df64(3, "cpu")
    want = jax_df64.init_df64(3)
    assert len({p.data_ptr() for p in got}) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ir():
    """Complex and real gates, controls, a D2M diagonal, SWAP_BITS and
    PERMUTE_BITS, ParamRef slots and baked angles."""
    ir = JaxIR(N)
    for q in range(N):
        ir.add("RY", [q], params=[JaxParamRef(q)])
    for q in range(N - 1):
        ir.add("CNOT", [q + 1], controls=[q])
    ir.add("SWAP_BITS", [0, 4])
    ir.add("H", [2])
    ir.add("RZ", [5], params=[0.37])
    ir.add("RX", [1], controls=[3], params=[JaxParamRef(N)])
    ir.add("D2M", [0, 3], matrix=np.exp(1j * np.array([[0.1, 0.2],
                                                       [0.3, 0.4]])))
    ir.add("PERMUTE_BITS", [1, 2, 5], controls=[2, 5, 1])
    ir.add("U3", [4], params=[0.3, -0.2, 0.9])
    ir.add("SWAP", [1, 3])
    return ir


def test_compile_df64_ir_matches_reference():
    jir = _ir()
    params = np.random.default_rng(4).normal(size=N + 1)
    want = jax_df64.state_to_pair_f64(jax_df64.compile_df64_ir(jir)(
        *jax_df64.init_df64(N), jax.numpy.asarray(params)))
    port_ir = convert.ir_from_reference(jir)
    fn = df64.compile_df64_ir(port_ir)
    assert df64.compile_df64_ir(convert.ir_from_reference(jir)) is fn
    for start in (df64.init_df64(N, "cpu"),
                  df64.init_df64(N, "cpu")[:2] + (None, None)):
        re, im = df64.state_to_pair_f64(fn(*start, params))
        np.testing.assert_allclose(re.numpy(), np.asarray(want[0]), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(im.numpy(), np.asarray(want[1]), rtol=0,
                                   atol=TOL)


def test_compile_df64_ir_keeps_a_real_carry_and_rejects_sharding():
    ir = JaxIR(N)
    for q in range(N):
        ir.add("RY", [q], params=[0.1 * (q + 1)])
    ir.add("CNOT", [2], controls=[0])
    ir.add("SWAP_BITS", [1, 5])
    port_ir = convert.ir_from_reference(ir)
    planes = df64.compile_df64_ir(port_ir)(
        *df64.init_df64(N, "cpu")[:2], None, None)
    assert planes[2] is None and planes[3] is None
    want = jax_df64.state_to_pair_f64(jax_df64.compile_df64_ir(ir)(
        *jax_df64.init_df64(N), jax.numpy.zeros(0)))
    np.testing.assert_allclose(df64.state_to_pair_f64(planes)[0].numpy(),
                               np.asarray(want[0]), rtol=0, atol=TOL)
    # a sharding is a parallel.state_sharding, nothing else
    with pytest.raises(TypeError, match="state_sharding"):
        df64.compile_df64_ir(port_ir, sharding=object())


def test_compile_df64_ir_runs_sharded():
    """Over 4 shards (bits 4 and 5 select the shard, so the SWAP_BITS
    crosses the boundary) the real carry stays real and the planes are the
    unsharded run's, bit for bit; a state of another sharding is refused."""
    ir = JaxIR(N)
    for q in range(N):
        ir.add("RY", [q], params=[0.1 * (q + 1)])
    ir.add("CNOT", [2], controls=[0])
    ir.add("SWAP_BITS", [1, 5])
    port_ir = convert.ir_from_reference(ir)
    planes = df64.compile_df64_ir(port_ir)(
        *df64.init_df64(N, "cpu")[:2], None, None)
    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    fn = df64.compile_df64_ir(port_ir, sharding=state_sharding(mesh))
    out = sharded.gather(fn(shard_state(
        df64.init_df64(N, "cpu")[:2] + (None, None), mesh)))
    assert out[2] is None and out[3] is None
    for got, ref in zip(out[:2], planes[:2]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0)
    other = make_mesh(2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="not sharded as"):
        fn(shard_state(df64.init_df64(N, "cpu")[:2] + (None, None), other))
