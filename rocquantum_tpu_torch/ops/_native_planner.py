"""ctypes bridge to the native C++ gate-layer scheduler
(``native/fusion_planner.cpp``, shared unchanged with the JAX package).

The library is built with g++ at first use into the port's build directory
(ops/_build.py). Where g++ is missing, :func:`plan_layer_native` returns
None and callers run the pure-Python planner, which gives identical plans
(the two are differential-tested).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import _build

_SRC = os.path.join(_build.REPO_ROOT, "native", "fusion_planner.cpp")

_LIB = None
_LIB_TRIED = False


def _load():
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = _build.load_host_cpp("fusionplanner", _SRC)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.rocq_plan_layer_mp.restype = ctypes.c_int
    lib.rocq_plan_layer_mp.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    _LIB = lib
    return _LIB


def planner_name() -> str:
    """Which planner runs in this process: "native" or "python"."""
    return "native" if _load() is not None else "python"


def plan_layer_native(n: int, supports: Sequence[Tuple[int, ...]],
                      reach: int, max_pairs: int,
                      anchors: Sequence[Tuple[int, ...]] = None
                      ) -> Optional[List[tuple]]:
    """Run the C++ multi-pair scheduler; returns a list of
    ('pass', pair_bits_tuple, gate_idx_tuple) records, or None when the
    library is unavailable. ``anchors[i]`` lists the qubits that must fit
    the window/pair set (default: the full support)."""
    lib = _load()
    if lib is None:
        return None
    num = len(supports)
    if anchors is None:
        anchors = supports
    q0 = np.asarray([s[0] for s in supports], np.int32)
    q1 = np.asarray([s[1] if len(s) > 1 else -1 for s in supports], np.int32)
    a0 = np.asarray([a[0] if len(a) > 0 else -1 for a in anchors], np.int32)
    a1 = np.asarray([a[1] if len(a) > 1 else -1 for a in anchors], np.int32)
    capacity = 4 * num + (max_pairs + 4) * (2 * num + 2) + 16
    out = np.zeros(capacity, np.int32)
    rc = lib.rocq_plan_layer_mp(n, reach, max_pairs, num, q0, q1, a0, a1,
                                out, capacity)
    if rc < 0:
        return None
    items: List[tuple] = []
    w = 0
    while w < rc:
        w += 1  # record tag (always 1 = pass)
        npairs = int(out[w])
        w += 1
        pairs = tuple(int(v) for v in out[w:w + npairs])
        w += npairs
        count = int(out[w])
        w += 1
        idx = tuple(int(v) for v in out[w:w + count])
        w += count
        items.append(("pass", pairs, idx))
    return items
