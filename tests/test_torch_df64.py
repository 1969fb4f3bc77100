"""The port's double-float (df64) layer and arithmetic against the JAX
package's.

``apply_fused_layer_df64_reference`` (the plain-torch version the CUDA
kernel csrc/fused_df64.cu is held to on the card) must compute what the
Pallas df64 kernels compute (``rocquantum_tpu.ops.pallas_df64``, interpret
mode): the window kernel ``_kernel_df`` and the paired kernel
``_kernel_multi_df``, on the real and the complex carry, with every spec
kind, free CNOT/CU controls and D2 on free bits. Values are compared
promoted to float64 (hi + lo) at 1e-13, the df64 accuracy contract for a
normalized state. The arithmetic (``ops/df64.py``) is compared with the JAX
functions, which on the CPU also take their error terms through float64.
Inputs come from a numpy seed and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.ops import df64 as jax_df64
from rocquantum_tpu.ops import pallas_sv
from rocquantum_tpu.ops.pallas_df64 import (apply_fused_layer_df64,
                                            pack_gate_mats_df64)
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.compiler import interpreter as port_interp
from rocquantum_tpu_torch.compiler.passes import PallasBlock
from rocquantum_tpu_torch.ops import df64, fused_df64

N = 18
ATOL = 1e-13

# route -> (geometry, pair_bits): the JAX window is 17 bits at the default
# geometry (12, 5) and 15 at the tall one (10, 5)
ROUTES = {
    "window": (None, ()),                                 # _kernel_df
    "one_pair": (None, (17,)),                            # _kernel_multi_df
    "three_pairs": (pallas_sv.TALL_GEOMETRY, (15, 16, 17)),  # same
}

# (route, carry, random gates besides one U per pair bit). The interpret-
# mode run of the JAX kernel takes seconds per complex gate, ~6 s per gate
# with three pair bits, so the complex carry is held to the Pallas kernels
# with none and one pair bit here; the port's plain version has no notion
# of pair bits, and the CUDA kernel meets the complex carry with three pair
# bits on the card (tests/test_torch_gpu.py, chip_smoke.py).
CASES = [("window", "real", 16), ("window", "complex", 8),
         ("one_pair", "real", 16), ("one_pair", "complex", 8),
         ("three_pairs", "real", 4)]


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


def _limit(geometry):
    col, tile = geometry or (pallas_sv.COL_QUBITS, pallas_sv.TILE_ROWS_LOG2)
    return col + tile


def _matrix(rng, kind, real):
    if kind == "D2":
        if real:
            return rng.choice([-1.0, 1.0], (2, 2)) * rng.uniform(0.5, 1, (2, 2))
        return np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
    if real:
        th = rng.normal()
        return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    q, _ = np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
    return q


def random_specs(rng, n, limit, pair_bits, real, count=16):
    """Specs legal for the JAX geometry: targets in the window or the pair
    set, controls anywhere (free above the window), D2 on any bits
    including two free ones; every pair bit carries a gate."""
    local = list(range(limit)) + list(pair_bits)
    free = [q for q in range(limit, n) if q not in pair_bits]
    specs = [("U", p) for p in pair_bits]
    for i in range(count):
        kind = ("U", "CNOT", "CU", "D2")[i % 4]
        t = int(rng.choice(local))
        if kind == "U":
            specs.append(("U", t))
        elif kind in ("CNOT", "CU"):
            pool = free if (free and i % 8 < 4) else \
                [q for q in local if q != t]
            specs.append((kind, int(rng.choice(pool)), t))
        elif i % 8 == 3 and free:
            specs.append(("D2", int(rng.choice(free)), int(rng.choice(free))))
        else:
            specs.append(("D2", int(rng.choice(local)), int(rng.integers(n))))
    mats = [np.asarray(_matrix(rng, s[0], real), np.complex128)
            for s in specs]
    return specs, mats, [real] * len(specs)


def random_state(rng, n, real):
    v = rng.normal(size=(2, 1 << n))
    if real:
        v[1] = 0.0
    v /= np.linalg.norm(v)
    return v[0], None if real else v[1]


def _jax_planes(re, im):
    rh, rl, ih, il = jax_df64.state_from_pair_f64(
        jnp.asarray(re), jnp.asarray(np.zeros_like(re) if im is None else im))
    return (rh, rl, None, None) if im is None else (rh, rl, ih, il)


def _promoted(planes):
    return [None if p is None else p.numpy() if isinstance(p, torch.Tensor)
            else np.asarray(p) for p in df64.state_to_pair_f64(
                tuple(None if p is None else torch.as_tensor(np.array(p))
                      for p in planes))]


@pytest.mark.parametrize("route,mode,count", CASES)
def test_reference_matches_pallas_df64(route, mode, count):
    geometry, pair_bits = ROUTES[route]
    real = mode == "real"
    rng = np.random.default_rng(sorted(ROUTES).index(route) * 2 + real)
    specs, mats, flags = random_specs(rng, N, _limit(geometry), pair_bits,
                                      real, count)
    re, im = random_state(rng, N, real)
    gm = pack_gate_mats_df64(mats)
    want = apply_fused_layer_df64(*_jax_planes(re, im), specs,
                                  jnp.asarray(gm), real_flags=flags,
                                  pair_bits=pair_bits, geometry=geometry,
                                  interpret=True)
    planes = df64.state_from_pair_f64(
        *convert.state_from_numpy(re, im, dtype=np.float64))
    before = [None if p is None else p.clone() for p in planes]
    got = fused_df64.apply_fused_layer_df64_reference(
        *planes, specs, fused_df64.pack_gate_mats_df64(mats),
        real_flags=flags)
    assert (got[2] is None) == real
    for g, w in zip(_promoted(got), _promoted(want)):
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # the inputs are untouched (the reference is functional)
    for p, b in zip(planes, before):
        if b is not None:
            assert torch.equal(p, b)


def test_pack_matches_jax_packing():
    rng = np.random.default_rng(4)
    mats = [_matrix(rng, "U", False) for _ in range(5)]
    np.testing.assert_array_equal(fused_df64.pack_gate_mats_df64(mats),
                                  pack_gate_mats_df64(mats))


def test_wrapper_on_cpu_uses_reference_and_launches_nothing():
    """Port geometry (10 window bits, pair bits 11 and 13): the wrapper on
    CPU tensors is the plain version, bit for bit, and launches nothing."""
    rng = np.random.default_rng(5)
    n = 14
    specs, mats, flags = random_specs(rng, n, 10, (11, 13), real=False)
    re, im = random_state(rng, n, real=False)
    planes = df64.state_from_pair_f64(
        *convert.state_from_numpy(re, im, dtype=np.float64))
    gm = fused_df64.pack_gate_mats_df64(mats)
    before = fused_df64.LAUNCHES
    got = fused_df64.apply_fused_layer_df64(*planes, specs, gm,
                                            pair_bits=(11, 13),
                                            real_flags=flags)
    want = fused_df64.apply_fused_layer_df64_reference(*planes, specs, gm,
                                                       real_flags=flags)
    assert fused_df64.LAUNCHES == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("bad", [
    dict(specs=[("U", 12)]),                       # outside the local set
    dict(specs=[("CNOT", 3, 12)]),                 # target outside
    dict(specs=[("U", 0)], pair_bits=(10, 11, 12, 13)),  # too many pairs
    dict(specs=[("U", 0)], real=False, im=False),  # complex gate, real carry
    dict(specs=[("U", 0)], gm_shape=(1, 2, 2, 2)),  # f32 packing
    dict(specs=[("U", 0)], im="half"),             # im_hi without im_lo
])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    n = 14
    rh = torch.zeros(1 << n)
    ih = None if bad.get("im") is False else torch.zeros(1 << n)
    il = None if bad.get("im") in (False, "half") else torch.zeros(1 << n)
    specs = bad["specs"]
    gm = np.zeros(bad.get("gm_shape", (len(specs), 2, 2, 4)), np.float32)
    with pytest.raises(ValueError):
        fused_df64.apply_fused_layer_df64(
            rh, torch.zeros_like(rh), ih, il, specs, gm,
            pair_bits=bad.get("pair_bits", ()),
            real_flags=[bad.get("real", True)] * len(specs))


def _df_pairs(rng, size):
    """Random df64 values over a wide range of magnitudes, as (hi, lo)
    float32 numpy arrays."""
    v = rng.normal(size=size) * np.exp2(rng.integers(-30, 30, size))
    hi = v.astype(np.float32)
    return hi, (v - hi.astype(np.float64)).astype(np.float32)


def _ulp_lo_close(got, want):
    """Equal to within one ulp of the lo word: |got - want| (promoted) is
    at most the float32 spacing of want's lo word."""
    g = got[0].numpy().astype(np.float64) + got[1].numpy()
    w0, w1 = (np.asarray(x) for x in want)
    w = w0.astype(np.float64) + w1
    tol = np.spacing(np.abs(w1).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) - tol)


@pytest.mark.parametrize("name", ["df_add", "df_sub", "df_mul"])
def test_arithmetic_matches_jax(name):
    rng = np.random.default_rng(len(name))
    x, y = _df_pairs(rng, 4096), _df_pairs(rng, 4096)
    if name != "df_mul":  # cancellation: y close to -x in half the lanes
        y = (np.where(np.arange(4096) % 2 == 0, -x[0], y[0]), y[1])
    got = getattr(df64, name)(tuple(map(torch.from_numpy, x)),
                              tuple(map(torch.from_numpy, y)))
    want = getattr(jax_df64, name)(tuple(map(jnp.asarray, x)),
                                   tuple(map(jnp.asarray, y)))
    _ulp_lo_close(got, want)


def test_splits_promotion_and_select_match_jax():
    """The exact pieces agree bit for bit: error-free transformations, the
    host scalar split, the plane split and promotion, and the select."""
    rng = np.random.default_rng(12)
    re, im = rng.normal(size=(2, 1024)) * np.exp2(rng.integers(-20, 20, 1024))
    got = df64.state_from_pair_f64(torch.from_numpy(re), torch.from_numpy(im))
    want = jax_df64.state_from_pair_f64(jnp.asarray(re), jnp.asarray(im))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(df64.state_to_pair_f64(got),
                    jax_df64.state_to_pair_f64(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for v in (np.pi, -1e-9 / 3, 0.1 + 1e-12):
        assert df64.split_f64_host(v) == jax_df64.split_f64_host(v)
    a, b = got[0], got[2]
    for name in ("two_sum", "two_prod"):
        for g, w in zip(getattr(df64, name)(a, b),
                        getattr(jax_df64, name)(jnp.asarray(a.numpy()),
                                                jnp.asarray(b.numpy()))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = rng.random(1024) < 0.5
    for g, w in zip(df64.df_select(torch.from_numpy(mask), got[:2], got[2:]),
                    jax_df64.df_select(jnp.asarray(mask), want[:2],
                                       want[2:])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_op_cases():
    ir = JaxIR(7)
    ir.add("H", [1])
    ir.add("RX", [4], params=[0.71])
    ir.add("CRY", [2], controls=[6], params=[-1.3])
    ir.add("CNOT", [0], controls=[5])
    ir.add("T", [3], is_adjoint=True)
    ir.add("RZZ", [1, 5], params=[0.4])
    ir.add("D2M", [6, 2], matrix=np.exp(1j * np.array([[0.1, 0.2],
                                                        [0.3, 0.4]])))
    ir.add("SWAP", [0, 3])
    ir.add("CSWAP", [2, 4], controls=[1])
    ir.add("MCX", [3], controls=[0, 6])
    u, _ = np.linalg.qr(np.random.default_rng(8).normal(size=(4, 4))
                        + 1j * np.random.default_rng(9).normal(size=(4, 4)))
    ir.add("UNITARY", [5, 0], matrix=u)
    return list(ir.ops)


@pytest.mark.parametrize("index", range(11))
def test_apply_op_matches_jax(index):
    op = _jax_op_cases()[index]
    rng = np.random.default_rng(index)
    re, im = random_state(rng, 7, real=False)
    jax_planes = jax_df64.state_from_pair_f64(jnp.asarray(re),
                                              jnp.asarray(im))
    want = jax_df64.apply_op_df64(jax_planes, op, list(op.params))
    port_op = convert.ir_from_reference(JaxIR(7, [op])).ops[0]
    planes = df64.state_from_pair_f64(
        *convert.state_from_numpy(re, im, dtype=np.float64))
    got = df64.apply_op_df64(planes, port_op)
    for k in (0, 2):
        _ulp_lo_close(got[k:k + 2], want[k:k + 2])


def test_block_specs_df64_match_jax_packing():
    """pallas_block_specs_df64 gives the kinds, supports, real flags and
    hi/lo matrices of the JAX package's."""
    from rocquantum_tpu.compiler import interpreter as jax_interp
    from rocquantum_tpu.compiler.passes import PallasBlock as JaxBlock
    ir = JaxIR(N)
    for q in range(0, N, 3):
        ir.add("H", [q])
    ir.add("CNOT", [2], controls=[N - 1])
    ir.add("CRY", [13], controls=[N - 2], params=[0.37])
    ir.add("P", [5], controls=[N - 1], params=[0.81])
    ir.add("RZZ", [1, N - 3], params=[0.29])
    ir.add("D2M", [4, N - 1], matrix=np.exp(1j * np.array([[0.1, 0.2],
                                                           [0.3, 0.4]])))
    ir.add("RZ", [7], params=[-0.6])
    ir.add("CZ", [8], controls=[N - 1])
    port_ir = convert.ir_from_reference(ir)
    jk, js, jgm, jflags = jax_interp.pallas_block_specs_df64(
        JaxBlock(ops=list(ir.ops)), None)
    pk, ps, pgm, pflags = port_interp.pallas_block_specs_df64(
        PallasBlock(ops=list(port_ir.ops)), None)
    assert list(pk) == list(jk)
    assert [tuple(s) for s in ps] == [tuple(s) for s in js]
    assert list(pflags) == list(jflags)
    hi_lo = pgm.astype(np.float64)
    want = np.asarray(jgm).astype(np.float64)
    np.testing.assert_allclose(hi_lo[..., 0::2] + hi_lo[..., 1::2],
                               want[..., 0::2] + want[..., 1::2],
                               rtol=0, atol=1e-15)
