"""Index-bit rotation of float32 state planes: the counterpart of the
rotation half of ``rocquantum_tpu/ops/relabel.py``.

:func:`rotate_region` rotates the index bits ``[ROT_LO, n)`` of each
``(2^n,)`` plane DOWN by ``shift``: the bit at ``ROT_LO + j`` moves to
``ROT_LO + ((j - shift) mod (n - ROT_LO))``. It is an out-of-place copy. On
CUDA tensors it launches the hand-written kernel in ``csrc/rotate_bits.cu``
(built with nvcc at first use) for every shift and any leading batch; on CPU
tensors it runs :func:`rotate_bits_down`, the plain-torch version the tests
and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

ROT_LO = 7  # rotations never touch bits [0, 7): a 128-float contiguous run

# kernel launches in this process (one per rotated tensor on the GPU)
LAUNCHES = 0

_LIB = None


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("rotate_bits")
        fn = lib.rocq_rotate_bits_down
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _region_shift(x: torch.Tensor, n: int, shift: int) -> int:
    """The shift reduced modulo the region size; checks the plane size."""
    if x.dim() < 1 or x.shape[-1] != 1 << n:
        raise ValueError(f"the last axis must hold 2^{n} amplitudes, got "
                         f"shape {tuple(x.shape)}")
    size = n - ROT_LO
    if size < 1:
        raise ValueError(f"a rotation needs n > {ROT_LO}, got n={n}")
    return int(shift) % size


def rotate_bits_down(x: torch.Tensor, n: int, shift: int) -> torch.Tensor:
    """Plain-torch rotation: one view ``(..., hi, lo, 128)`` with
    ``lo = 2^shift``, transposed to ``(..., lo, hi, 128)`` and made
    contiguous. Leading batch dims pass through; returns ``x`` itself when
    the shift is a multiple of the region size."""
    s = _region_shift(x, n, shift)
    if s == 0:
        return x
    lead = tuple(x.shape[:-1])
    v = x.reshape(lead + (1 << (n - ROT_LO - s), 1 << s, 1 << ROT_LO))
    k = len(lead)
    return v.transpose(k, k + 1).contiguous().reshape(x.shape)


def rotate_region(x: torch.Tensor, n: int, shift: int) -> torch.Tensor:
    """Rotate index bits ``[ROT_LO, n)`` of every plane of ``x`` down by
    ``shift`` into a new tensor (``x`` itself for a zero shift). CUDA
    tensors go through the kernel and must be contiguous float32; CPU
    tensors through :func:`rotate_bits_down`."""
    s = _region_shift(x, n, shift)
    if x.device.type != "cuda":
        return rotate_bits_down(x, n, s)
    if s == 0:
        return x
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the rotation kernel takes a contiguous float32 "
                         f"tensor, got {x.dtype} "
                         f"(contiguous={x.is_contiguous()})")
    if x.data_ptr() % 16:
        raise ValueError("the rotation kernel needs a 16-byte aligned tensor")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build()
    global LAUNCHES
    LAUNCHES += 1
    err = lib.rocq_rotate_bits_down(x.data_ptr(), out.data_ptr(),
                                    x.numel() >> n, n, s, stream)
    if err != 0:
        raise RuntimeError(f"rotate_bits kernel launch failed: cudaError_t "
                           f"{err} (n={n}, shift={s}, shape "
                           f"{tuple(x.shape)})")
    return out
