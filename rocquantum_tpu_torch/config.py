"""Global configuration: simulation precision.

Counterpart of ``rocquantum_tpu/config.py``. ``"single"`` (the default)
carries complex64 amplitudes as two float32 planes, eps 1e-6. ``"double"``
carries complex128 amplitudes as two float64 planes, eps 1e-12, and flushes
through the exact per-op float64 engine. ``"df64"`` is double precision
with the double-float engine opted in: the flush splits each float64 plane
into a hi/lo float32 pair and runs the fused compensated-f32 kernel
(ops/fused_df64.py); ``get_precision()`` then reports ``"double"``, since
the held state and every readback are the same as in ``"double"``. The
precision is this package's own global and affects states created after the
call.
"""

from __future__ import annotations

import os

import torch

_PRECISIONS = ("single", "double", "df64")

_precision = "single"  # "single" | "double"
_df64 = False          # double precision on the double-float engine


def set_precision(precision: str) -> None:
    """Set the simulation precision: ``"single"``, ``"double"`` or
    ``"df64"``."""
    global _precision, _df64
    if precision not in _PRECISIONS:
        raise ValueError("precision must be 'single', 'double' or 'df64', "
                         f"got {precision!r}")
    _df64 = precision == "df64"
    _precision = "double" if precision == "df64" else precision


def get_precision() -> str:
    return _precision


def df64_enabled() -> bool:
    """True when double-precision circuits run the double-float engine:
    opted in with ``set_precision("df64")`` or the ROCQ_DF64 variable."""
    if _precision != "double":
        return False
    return _df64 or bool(os.environ.get("ROCQ_DF64"))


def complex_dtype() -> torch.dtype:
    return torch.complex128 if _precision == "double" else torch.complex64


def real_dtype() -> torch.dtype:
    return torch.float64 if _precision == "double" else torch.float32


def eps() -> float:
    return 1e-12 if _precision == "double" else 1e-6


def complex_from_parts(re, im, dtype=None) -> torch.Tensor:
    """A complex tensor from (real, imaginary) parts, ``dtype`` defaulting
    to the precision's complex type."""
    dtype = dtype or complex_dtype()
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.complex(torch.as_tensor(re, dtype=real),
                         torch.as_tensor(im, dtype=real))
