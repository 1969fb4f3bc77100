"""ctypes bridge to the native C++ greedy pathfinder
(``native/pathfinder.cpp``, shared unchanged with the JAX package).

The library is built with g++ at first use into the port's build directory
(ops/_build.py), never beside this module. Where g++ is missing,
:func:`find_greedy_path` returns None and the caller runs the Python scan,
which has the identical cost rule and tie-break (the two are
differential-tested).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from ..ops import _build
from .pathfinder import (ContractionPlan, ContractionStep, _pair_contraction,
                         _prod)

_SRC = os.path.join(_build.REPO_ROOT, "native", "pathfinder.cpp")

_LIB = None
_LIB_TRIED = False


def _load():
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = _build.load_host_cpp("pathfinder", _SRC)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.rocq_greedy_path.restype = ctypes.c_int
    lib.rocq_greedy_path.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    _LIB = lib
    return _LIB


def pathfinder_name() -> str:
    """Which greedy scan runs in this process: "native" or "python"."""
    return "native" if _load() is not None else "python"


def find_greedy_path(labels: List[Tuple[str, ...]],
                     shapes: List[Tuple[int, ...]]
                     ) -> Optional[ContractionPlan]:
    """Native greedy plan, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    label_ids = {}
    for ls in labels:
        for l in ls:
            if l not in label_ids:
                label_ids[l] = len(label_ids)
    n = len(labels)
    ranks = np.asarray([len(ls) for ls in labels], np.int32)
    labels_flat = np.asarray([label_ids[l] for ls in labels for l in ls],
                             np.int32)
    dims_flat = np.asarray([d for s in shapes for d in s], np.int64)
    if ranks.sum() != len(labels_flat) or len(labels_flat) != len(dims_flat):
        return None
    out_pairs = np.zeros(2 * max(n - 1, 1), np.int32)
    n_steps = lib.rocq_greedy_path(n, ranks, labels_flat, dims_flat, out_pairs)
    if n_steps < 0:
        return None

    # replay the pairs to build the plan (the Python scan's bookkeeping)
    current = [(tuple(l), tuple(s)) for l, s in zip(labels, shapes)]
    steps = []
    total = 0.0
    largest = max((int(_prod(s)) for _, s in current), default=0)
    for k in range(n_steps):
        i, j = int(out_pairs[2 * k]), int(out_pairs[2 * k + 1])
        counts = {}
        for t, (ls, _) in enumerate(current):
            if t in (i, j):
                continue
            for l in ls:
                counts[l] = counts.get(l, 0) + 1
        out, out_size, flops = _pair_contraction(
            current[i][0], current[i][1], current[j][0], current[j][1], counts)
        dims = {}
        dims.update(dict(zip(current[i][0], current[i][1])))
        dims.update(dict(zip(current[j][0], current[j][1])))
        steps.append(ContractionStep(i, j, out, flops, out_size))
        total += flops
        largest = max(largest, out_size)
        current = [t for t_idx, t in enumerate(current)
                   if t_idx not in (i, j)]
        current.append((out, tuple(dims[l] for l in out)))
    return ContractionPlan(steps, total, largest)
