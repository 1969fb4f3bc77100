"""Contraction-order search.

A copy of ``rocquantum_tpu/tensornet/pathfinder.py`` (the reference
Pathfinder: a GREEDY exhaustive pair scan minimizing per-step FLOPs, the
algorithm dispatch, the config struct and the plan types), kept here so
this package imports nothing of the JAX package. OPTIMAL and AUTO plan
with opt_einsum, imported when they are asked for; KAHYPAR and METIS map
to AUTO. Without opt_einsum those raise ImportError: they never fall back
to the greedy plan, which would be another plan than the JAX package's.

The greedy scan is host combinatorics (no device work): the native C++
scan (native/pathfinder.cpp) runs when it builds, else this Python scan;
both implement the identical cost rule and tie-break.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class PathfinderAlgorithm(enum.Enum):
    GREEDY = "greedy"           # reference GREEDY (exhaustive pair scan)
    OPTIMAL = "optimal"         # opt_einsum dynamic programming
    AUTO = "auto"               # opt_einsum auto
    KAHYPAR = "kahypar"         # accepted for compat; maps to AUTO
    METIS = "metis"             # accepted for compat; maps to AUTO


@dataclasses.dataclass
class ContractionStep:
    """Contract tensors at (i, j) of the current list; the result is
    appended (ids are indices into the evolving tensor list, matching the
    reference plan replay, hipTensorNet.cpp:278-300)."""
    i: int
    j: int
    out_labels: Tuple[str, ...]
    flops: float
    out_size: int  # elements


@dataclasses.dataclass
class ContractionPlan:
    steps: List[ContractionStep]
    total_flops: float
    largest_intermediate: int  # elements

    def __repr__(self):
        return (f"ContractionPlan(steps={len(self.steps)}, "
                f"flops={self.total_flops:.3g}, "
                f"largest={self.largest_intermediate})")


@dataclasses.dataclass
class OptimizerConfig:
    """hipTensorNetContractionOptimizerConfig_t analog
    (hipTensorNet_api.h:2-37)."""
    algorithm: PathfinderAlgorithm = PathfinderAlgorithm.GREEDY
    memory_limit_bytes: Optional[int] = None
    num_slices: Optional[int] = None
    # opt_einsum knobs
    repetitions: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "OptimizerConfig":
        cfg = cls()
        if "algorithm" in d:
            a = d["algorithm"]
            cfg.algorithm = (a if isinstance(a, PathfinderAlgorithm)
                             else PathfinderAlgorithm(str(a).lower()))
        cfg.memory_limit_bytes = d.get("memory_limit", d.get("memory_limit_bytes"))
        cfg.num_slices = d.get("num_slices")
        cfg.repetitions = d.get("repetitions", 1)
        return cfg


def _pair_contraction(labels_a, dims_a, labels_b, dims_b, external_counts):
    """Output labels/dims + FLOPs for contracting a pair. A shared label is
    summed only if no OTHER tensor still uses it (multiplicity accounting —
    generalizes the reference's shared-label rule to networks where an index
    appears 3+ times)."""
    dims = {}
    dims.update(dict(zip(labels_a, dims_a)))
    dims.update(dict(zip(labels_b, dims_b)))
    shared = [l for l in labels_a if l in set(labels_b)]
    contracted = [l for l in shared if external_counts.get(l, 0) == 0]
    out = [l for l in labels_a if l not in contracted]
    out += [l for l in labels_b if l not in set(labels_a) and l not in contracted]
    k = 1
    for l in contracted:
        k *= dims[l]
    out_size = 1
    for l in out:
        out_size *= dims[l]
    # complex multiply-add per output element per contracted configuration
    flops = 8.0 * out_size * k
    return tuple(out), out_size, flops


def find_greedy_path(labels: List[Tuple[str, ...]],
                     shapes: List[Tuple[int, ...]]) -> ContractionPlan:
    """Exhaustive greedy pair scan minimizing per-step FLOPs
    (Pathfinder.cpp:174-269 cost rule)."""
    current = [(tuple(l), tuple(s)) for l, s in zip(labels, shapes)]
    steps: List[ContractionStep] = []
    total_flops = 0.0
    largest = max((int(_prod(s)) for _, s in current), default=0)

    while len(current) > 1:
        best = None
        for i in range(len(current)):
            for j in range(i + 1, len(current)):
                counts: Dict[str, int] = {}
                for k, (ls, _) in enumerate(current):
                    if k in (i, j):
                        continue
                    for l in ls:
                        counts[l] = counts.get(l, 0) + 1
                out, out_size, flops = _pair_contraction(
                    current[i][0], current[i][1],
                    current[j][0], current[j][1], counts)
                key = (flops, out_size, i, j)
                if best is None or key < best[0]:
                    best = (key, i, j, out, out_size, flops)
        _, i, j, out, out_size, flops = best
        dims = {}
        dims.update(dict(zip(current[i][0], current[i][1])))
        dims.update(dict(zip(current[j][0], current[j][1])))
        steps.append(ContractionStep(i, j, out, flops, out_size))
        total_flops += flops
        largest = max(largest, out_size)
        new_entry = (out, tuple(dims[l] for l in out))
        current = [t for k, t in enumerate(current) if k not in (i, j)]
        current.append(new_entry)

    return ContractionPlan(steps, total_flops, largest)


def _prod(xs):
    p = 1
    for x in xs:
        p *= x
    return p


def _opt_einsum_path(labels, shapes, optimize) -> ContractionPlan:
    """Plan via opt_einsum, converted to the evolving-list step format."""
    try:
        import opt_einsum
    except ImportError as exc:
        raise ImportError(
            f"the {optimize!r} planner needs the opt_einsum package, which "
            "is not installed; use PathfinderAlgorithm.GREEDY") from exc

    # Build symbol mapping (labels may be multi-char)
    all_labels = sorted({l for ls in labels for l in ls})
    sym = {l: opt_einsum.get_symbol(i) for i, l in enumerate(all_labels)}
    counts: Dict[str, int] = {}
    for ls in labels:
        for l in ls:
            counts[l] = counts.get(l, 0) + 1
    out_labels = [l for l in all_labels if counts[l] == 1]
    eq = ",".join("".join(sym[l] for l in ls) for ls in labels)
    eq += "->" + "".join(sym[l] for l in out_labels)
    path, _info = opt_einsum.contract_path(
        eq, *[tuple(s) for s in shapes], shapes=True, optimize=optimize)

    # Convert pairwise path to steps
    current = [(tuple(l), tuple(s)) for l, s in zip(labels, shapes)]
    steps: List[ContractionStep] = []
    total = 0.0
    largest = max((int(_prod(s)) for _, s in current), default=0)
    for pair in path:
        if len(pair) == 1:
            i, j = pair[0], pair[0]  # degenerate; skip
            continue
        i, j = sorted(pair)
        ext: Dict[str, int] = {}
        for k, (ls, _) in enumerate(current):
            if k in (i, j):
                continue
            for l in ls:
                ext[l] = ext.get(l, 0) + 1
        out, out_size, flops = _pair_contraction(
            current[i][0], current[i][1], current[j][0], current[j][1], ext)
        dims = {}
        dims.update(dict(zip(current[i][0], current[i][1])))
        dims.update(dict(zip(current[j][0], current[j][1])))
        steps.append(ContractionStep(i, j, out, flops, out_size))
        total += flops
        largest = max(largest, out_size)
        current = [t for k, t in enumerate(current) if k not in (i, j)]
        current.append((out, tuple(dims[l] for l in out)))
    return ContractionPlan(steps, total, largest)


class Pathfinder:
    """findOptimalPath dispatch (Pathfinder.cpp:150-170)."""

    def __init__(self, config: Optional[OptimizerConfig] = None):
        self.config = config or OptimizerConfig()

    def find_optimal_path(self, labels: Sequence[Tuple[str, ...]],
                          shapes: Sequence[Tuple[int, ...]]) -> ContractionPlan:
        algo = self.config.algorithm
        if algo == PathfinderAlgorithm.GREEDY:
            from . import _native_pathfinder
            plan = _native_pathfinder.find_greedy_path(labels, shapes)
            if plan is not None:
                return plan
            return find_greedy_path(list(labels), list(shapes))
        if algo == PathfinderAlgorithm.OPTIMAL:
            return _opt_einsum_path(list(labels), list(shapes), "optimal")
        # AUTO / KAHYPAR / METIS -> opt_einsum auto
        return _opt_einsum_path(list(labels), list(shapes), "auto")
