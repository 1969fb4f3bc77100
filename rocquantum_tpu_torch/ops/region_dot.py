"""Dense real matrices on low index bits of a float32 plane, on the tensor
cores: the counterpart of the JAX package's MXU probes
(``.scratch/tpu_mxu_probe.py``).

The plane is viewed as ``(R, 4096)`` float32 rows, ``R`` a multiple of 32,
and updated in place, as the TPU probes alias their input and output:

- :func:`lane_dot` ``(x, m)``: ``y[r, 128 k + j] = sum_i x[r, 128 k + i]
  m[i, j]``, a 128x128 matrix on index bits 0-6;
- :func:`row_dot` ``(a, x)``: ``y[32 t + i, c] = sum_k a[i, k]
  x[32 t + k, c]``, a 32x32 matrix on the row bits 0-4 (index bits 12-16).

On CUDA tensors each launches its kernel in ``csrc/region_dot.cu`` (3xTF32,
float32-grade like the probes' ``Precision.HIGHEST``: the lane dot on
``wgmma``, the row dot on ``mma.sync``); on CPU tensors each writes its
plain-torch version (a float32 matmul over the probe's view) into ``x``.

The lane kernel takes ``m`` as its B operand image, packed here by
:func:`lane_operands`: the hi and lo tf32 splits of ``m``, rows in the
kernel's K order, K-major in the 128-byte swizzled layout of a ``wgmma``
shared-memory descriptor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

COLS = 4096     # floats in a probe row
LANE = 128      # the lane dot's matrix is LANE x LANE
TILE = 32       # the row dot's matrix is TILE x TILE; R is a multiple of it

# kernel launches in this process, one per call on the GPU
LANE_LAUNCHES = 0
ROW_LAUNCHES = 0

_LIB = None
_B_INDEX = {}


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("region_dot")
        lib.rocq_lane_dot.restype = ctypes.c_int
        lib.rocq_lane_dot.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_void_p]
        lib.rocq_row_dot.restype = ctypes.c_int
        lib.rocq_row_dot.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, mat: torch.Tensor, size: int, name: str):
    if x.dim() != 2 or x.shape[1] != COLS or x.shape[0] % TILE:
        raise ValueError(f"x must be (R, {COLS}) with R a multiple of "
                         f"{TILE}, got {tuple(x.shape)}")
    if tuple(mat.shape) != (size, size):
        raise ValueError(f"{name} must be ({size}, {size}), got "
                         f"{tuple(mat.shape)}")
    if x.device != mat.device:
        raise ValueError(f"x and {name} must be on one device")
    if x.device.type == "cuda":
        for what, t in (("x", x), (name, mat)):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.data_ptr() % 16:
                raise ValueError(f"the kernel takes a contiguous, 16-byte "
                                 f"aligned float32 {what}")


def lane_dot_reference(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain torch: ``x.view(-1, 128) @ m`` as a new ``(R, 4096)`` tensor."""
    return (x.reshape(-1, LANE) @ m).reshape(x.shape)


def row_dot_reference(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch: ``a @ x.view(R / 32, 32, 4096)`` as a new ``(R, 4096)``
    tensor."""
    return (a @ x.reshape(-1, TILE, COLS)).reshape(x.shape)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest tf32 (10 mantissa bits; ties away
    from zero, as ``cvt.rna.tf32.f32``), as float32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def lane_k_order() -> np.ndarray:
    """Row of ``m`` that the kernel's K position ``8 s + j`` holds (k-step
    ``s``, wgmma column ``j``): a thread's float4 at columns ``16 c + 4 t``
    of a tile row feeds k-steps ``2c`` and ``2c + 1`` at ``j = t`` and
    ``t + 4``."""
    kp = np.arange(LANE)
    s, j = kp // 8, kp % 8
    return 16 * (s // 2) + 4 * (j % 4) + 2 * (s % 2) + j // 4


def _b_index(device) -> torch.Tensor:
    """Flat index into ``m`` (row-major) of each 4-byte word of one split's
    B image: K blocks of 32 (16 KiB each), then the 128 columns of ``m``
    as 128-byte rows, whose 16-byte chunks are swizzled by ``chunk ^ (n %
    8)``."""
    key = str(device)
    if key not in _B_INDEX:
        kb, n, c, e = np.meshgrid(np.arange(LANE // 32), np.arange(LANE),
                                  np.arange(8), np.arange(4), indexing="ij")
        kp = kb * 32 + (c ^ (n % 8)) * 4 + e
        idx = lane_k_order()[kp] * LANE + n
        _B_INDEX[key] = torch.from_numpy(idx.reshape(-1)).to(device)
    return _B_INDEX[key]


def lane_operands(m: torch.Tensor) -> torch.Tensor:
    """The lane kernel's B operand image of ``m``: ``(2, 128 * 128)``
    float32 holding tf32 values, hi = tf32(m) then lo = tf32(m - hi), each
    in the layout of :func:`_b_index`."""
    hi = tf32_round(m)
    lo = tf32_round(m - hi)
    return torch.stack([hi, lo]).reshape(2, -1)[:, _b_index(m.device)]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def lane_dot(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x <- x.view(-1, 128) @ m`` in place; returns ``x``."""
    _check(x, m, LANE, "m")
    if x.device.type != "cuda":
        return x.copy_(lane_dot_reference(x, m))
    lib = build()
    global LANE_LAUNCHES
    LANE_LAUNCHES += 1
    image = lane_operands(m)
    err = lib.rocq_lane_dot(x.data_ptr(), image.data_ptr(), x.shape[0],
                            _stream(x))
    if err != 0:
        raise RuntimeError(f"lane_dot kernel launch failed: cudaError_t "
                           f"{err} (x {tuple(x.shape)})")
    return x


def row_dot(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x <- a @ x.view(R / 32, 32, 4096)`` in place; returns ``x``."""
    _check(x, a, TILE, "a")
    if x.device.type != "cuda":
        return x.copy_(row_dot_reference(a, x))
    lib = build()
    global ROW_LAUNCHES
    ROW_LAUNCHES += 1
    err = lib.rocq_row_dot(a.data_ptr(), x.data_ptr(), x.shape[0],
                           _stream(x))
    if err != 0:
        raise RuntimeError(f"row_dot kernel launch failed: cudaError_t "
                           f"{err} (x {tuple(x.shape)})")
    return x
