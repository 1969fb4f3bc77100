"""The port's region dots (rocquantum_tpu_torch.ops.region_dot) against the
JAX package's two MXU probe kernels (``.scratch/tpu_mxu_probe.py``), run in
Pallas interpret mode on the CPU.

The probe kernels are copied here as the probe script defines them (the
script runs its measurements when imported), with ``interpret=True``. Inputs
come from a numpy seed and go to both. Tolerances are the probe's own
measure, the relative error of sum(y^2), at 1e-6, and the largest
elementwise difference at 1e-5 of max|y| (both float32 products of 128- or
32-term sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rocquantum_tpu_torch.ops import fused_sv, region_dot

T, C = 32, 4096
R = 1 << 7


def _lane_kernel(m_ref, x_ref, o_ref):  # tpu_mxu_probe.py:13-19
    x = x_ref[...].reshape(T, C // 128, 128)
    m = m_ref[...]
    y = jax.lax.dot_general(x, m, (((2,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    o_ref[...] = y.reshape(T, C)


def _row_kernel(a_ref, x_ref, o_ref):  # tpu_mxu_probe.py:44-48
    o_ref[...] = jax.lax.dot_general(a_ref[...], x_ref[...],
                                     (((1,), (0,)), ((), ())),
                                     precision=jax.lax.Precision.HIGHEST,
                                     preferred_element_type=jnp.float32)


def _probe(kernel, mat, x):
    """The probe's pallas_call (tpu_mxu_probe.py:25-30, :53-58), in place,
    in interpret mode."""
    rows = x.shape[0]
    blk = pl.BlockSpec((T, C), lambda i: (i, 0), memory_space=pltpu.VMEM)
    mspec = pl.BlockSpec(mat.shape, lambda i: (0, 0),
                         memory_space=pltpu.VMEM)
    f = pl.pallas_call(kernel, grid=(rows // T,), in_specs=[mspec, blk],
                       out_specs=blk,
                       out_shape=jax.ShapeDtypeStruct((rows, C), jnp.float32),
                       input_output_aliases={1: 0}, interpret=True)
    return np.asarray(f(jnp.asarray(mat), jnp.asarray(x)))


def _inputs(size):
    x = np.random.default_rng(0).normal(size=(R, C)).astype(np.float32)
    mat = np.random.default_rng(1).normal(size=(size, size)).astype(
        np.float32)
    return x, mat


def _assert_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    s_got, s_want = np.sum(got * got), np.sum(want * want)
    assert abs(s_got - s_want) / s_want <= 1e-6
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_lane_dot_reference_matches_probe_kernel():
    x, m = _inputs(region_dot.LANE)
    want = _probe(_lane_kernel, m, x)
    got = region_dot.lane_dot_reference(torch.from_numpy(x),
                                        torch.from_numpy(m))
    _assert_close(got.numpy(), want)


def test_row_dot_reference_matches_probe_kernel():
    x, a = _inputs(region_dot.TILE)
    want = _probe(_row_kernel, a, x)
    got = region_dot.row_dot_reference(torch.from_numpy(a),
                                       torch.from_numpy(x))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("name", ["lane", "row"])
def test_wrapper_on_cpu_updates_in_place_and_launches_nothing(name):
    x, mat = _inputs(region_dot.LANE if name == "lane" else region_dot.TILE)
    tx, tm = torch.from_numpy(x.copy()), torch.from_numpy(mat)
    before = (region_dot.LANE_LAUNCHES, region_dot.ROW_LAUNCHES)
    if name == "lane":
        want = region_dot.lane_dot_reference(tx, tm)
        got = region_dot.lane_dot(tx, tm)
    else:
        want = region_dot.row_dot_reference(tm, tx)
        got = region_dot.row_dot(tm, tx)
    assert got is tx
    assert (region_dot.LANE_LAUNCHES, region_dot.ROW_LAUNCHES) == before
    assert torch.equal(got, want)


def _rotation(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


@pytest.mark.parametrize("name", ["lane", "row"])
def test_region_dot_applies_a_composed_gate_layer(name):
    """The probe's purpose: a lane dot by the transposed Kronecker product
    of seven RY gates is those gates on qubits 0-6, a row dot by the
    product of five is those gates on qubits 12-16 (qubit 0 the least
    significant bit, as everywhere in the package)."""
    qubits = range(7) if name == "lane" else range(12, 17)
    rng = np.random.default_rng(7)
    thetas = rng.normal(size=len(qubits))
    composed = np.eye(1)
    for th in thetas:  # the later (higher) qubit is the more significant
        composed = np.kron(_rotation(th), composed)
    x = rng.normal(size=(R, C))
    x /= np.linalg.norm(x)
    tx = torch.from_numpy(x.astype(np.float32))
    if name == "lane":
        got = region_dot.lane_dot(tx.clone(), torch.from_numpy(
            composed.T.astype(np.float32)))
    else:
        got = region_dot.row_dot(torch.from_numpy(
            composed.astype(np.float32)), tx.clone())
    specs = [("U", q) for q in qubits]
    mats = np.stack([np.stack([_rotation(th), np.zeros((2, 2))], -1)
                     for th in thetas]).astype(np.float32)
    want, _ = fused_sv.apply_fused_layer_reference(
        tx.reshape(-1), None, specs, mats, real_flags=[True] * len(specs))
    np.testing.assert_allclose(got.reshape(-1).numpy(), want.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("bad", [
    dict(x=(R, 2048)),                 # not a 4096-float row
    dict(x=(R + 16, C)),               # rows not a multiple of 32
    dict(x=(R, C), mat=64),            # wrong matrix size
])
@pytest.mark.parametrize("name", ["lane", "row"])
def test_wrappers_reject_bad_shapes(name, bad):
    size = region_dot.LANE if name == "lane" else region_dot.TILE
    x = torch.zeros(bad["x"])
    mat = torch.zeros(bad.get("mat", size), bad.get("mat", size))
    with pytest.raises(ValueError):
        if name == "lane":
            region_dot.lane_dot(x, mat)
        else:
            region_dot.row_dot(mat, x)


# ---- the wgmma lane kernel's host side and arithmetic ----------------------

def _np_tf32(v):
    """Nearest tf32, ties away from zero (cvt.rna.tf32.f32), in numpy."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _kernel_column(s, j):
    """Tile column whose value the kernel hands wgmma at k-step ``s``,
    column ``j``: thread t's float4 at 16 (s // 2) + 4 t holds k-step
    2c's values at j = t, t + 4 as elements 0, 1 and k-step 2c + 1's as
    elements 2, 3."""
    return 16 * (s // 2) + 4 * (j % 4) + 2 * (s % 2) + j // 4


def _np_image(m):
    """The B image written forward from m: row k of m goes to K position
    8 s + j (inverse of _kernel_column), word (kb, n, chunk ^ (n % 8), e)
    of a 128-byte swizzled K-major layout."""
    hi = _np_tf32(m)
    lo = _np_tf32(m - hi)
    img = np.zeros((2, 128 * 128), np.float32)
    n = np.arange(128)
    for k in range(128):
        c, t, e = k // 16, (k % 16) // 4, k % 4
        kp = 8 * (2 * c + e // 2) + t + 4 * (e % 2)
        pos = ((kp // 32 * 128 + n) * 8 + (((kp % 32) // 4) ^ (n % 8))) \
            * 4 + kp % 4
        img[0, pos], img[1, pos] = hi[k], lo[k]
    return img


def _unswizzle(img):
    """B[s, j, n] of each split, read as the wgmma descriptor addresses
    them: K block s // 4, 32 bytes in per s % 4, chunk swizzled by n % 8."""
    s, j, n = np.meshgrid(np.arange(16), np.arange(8), np.arange(128),
                          indexing="ij")
    chunk = (2 * (s % 4) + j // 4) ^ (n % 8)
    pos = ((s // 4 * 128 + n) * 8 + chunk) * 4 + j % 4
    return img[:, pos]


def test_tf32_round_matches_numpy():
    v = np.random.default_rng(3).normal(size=4096).astype(np.float32) \
        * np.float32(2.0) ** np.random.default_rng(4).integers(-30, 30, 4096)
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                    np.float32)  # halfway cases round away from zero
    v = np.concatenate([v.astype(np.float32), ties])
    got = region_dot.tf32_round(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.uint32), _np_tf32(v).view(np.uint32))
    assert np.array_equal(got[-3:], np.array(
        [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10], np.float32))


def test_lane_operands_match_numpy_image_bitwise():
    _, m = _inputs(region_dot.LANE)
    got = region_dot.lane_operands(torch.from_numpy(m)).numpy()
    assert got.shape == (2, 128 * 128)
    assert np.array_equal(got.view(np.uint32), _np_image(m).view(np.uint32))


def test_lane_operands_split_m_into_tf32_hi_lo():
    _, m = _inputs(region_dot.LANE)
    img = region_dot.lane_operands(torch.from_numpy(m)).numpy()
    assert not np.any(img.view(np.uint32) & 0x1FFF)   # tf32 bit patterns
    b = _unswizzle(img)                               # (2, 16, 8, 128)
    s, j = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
    rows = _kernel_column(s, j)
    assert sorted(rows.ravel()) == list(range(128))
    hi, lo = b[0], b[1]
    want = m[rows]                                    # (16, 8, 128)
    assert np.all(np.abs(want.astype(np.float64) - hi - lo)
                  <= 2.0 ** -22 * np.abs(want))
    assert np.array_equal(hi, _np_tf32(want))


def _trunc32(v):
    """float64 -> float32 toward zero (the tensor cores' adder)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _emulate_lane_kernel(x, img, group):
    """The kernel's arithmetic: A split once per value, per k-step three
    tf32 products of 8 terms into accumulators that add by truncation; the
    big ones from zero every ``group`` k-steps and joined by rounded
    float32 adds, the small ones chained; y = joined + small."""
    rows = x.reshape(-1, 128)
    b = _unswizzle(img).astype(np.float64)  # (2, 16, 8, 128)
    acc = big = small = None
    for s in range(16):
        a = rows[:, _kernel_column(s, np.arange(8))]
        ah = _np_tf32(a)
        al = _np_tf32(a - ah)
        ah, al = ah.astype(np.float64), al.astype(np.float64)
        prod = ah @ b[0, s]
        big = _trunc32(prod if s % group == 0 else big + prod)
        small = _trunc32(ah @ b[1, s] + (0.0 if s == 0 else small))
        small = _trunc32(small + al @ b[0, s])
        if s % group == group - 1:
            acc = big if acc is None else acc + big
    return (acc + small).reshape(x.shape)


@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_lane_kernel_arithmetic_is_float32_grade(group):
    """The emulated kernel at R = 128 on the probe's inputs: within 1e-6 of
    max|y| of the float64 product (the probe's PROBE_TOL is 1e-5)."""
    x, m = _inputs(region_dot.LANE)
    img = region_dot.lane_operands(torch.from_numpy(m)).numpy()
    got = _emulate_lane_kernel(x, img, group)
    want = (x.reshape(-1, 128).astype(np.float64) @ m.astype(np.float64)
            ).reshape(x.shape)
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
