"""Global configuration: simulation precision.

The port runs single precision only (complex64 amplitudes carried as two
float32 planes, eps 1e-6), the JAX package's default. Double precision and
the double-float engine are not ported yet.
"""

from __future__ import annotations

import torch

_NOT_PORTED = ("precision {!r} is not ported to the PyTorch package yet "
               "(ROADMAP.md, Queue 1 item 7: fp64/df64); only 'single' runs")


def set_precision(precision: str) -> None:
    """Set the simulation precision. Only ``"single"`` is available."""
    if precision in ("double", "df64"):
        raise NotImplementedError(_NOT_PORTED.format(precision))
    if precision != "single":
        raise ValueError("precision must be 'single', 'double' or 'df64', "
                         f"got {precision!r}")


def get_precision() -> str:
    return "single"


def complex_dtype() -> torch.dtype:
    return torch.complex64


def real_dtype() -> torch.dtype:
    return torch.float32


def eps() -> float:
    return 1e-6
