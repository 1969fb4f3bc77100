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
