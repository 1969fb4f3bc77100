"""Kernel-pass planning and execution: the counterpart of
``rocquantum_tpu/ops/relabel.py``.

A pass of the fused kernel (ops/fused_sv.py) reaches the low ``reach``
index bits plus up to ``max_pairs`` "pair bits" above them;
:func:`plan_full_layer` packs a whole gate list into the fewest such passes,
dependency-aware. The scheduling loop runs in native C++
(``native/fusion_planner.cpp``) with the Python implementation here as
fallback and differential-test oracle.

:func:`execute_plan` runs a plan: :class:`KernelPass` items through the
fused kernel and :class:`Rotation` items (index-bit relabels of the region
``[ROT_LO, n)``, the scheme pair bits replaced) through the rotation kernel
of ops/rotate.py. The planner emits no rotations, as in the JAX package;
callers that build rotation plans by hand still run them here.

The kernel takes any set of pair bits, so the JAX package's limits on
contiguous runs of pair bits (a Mosaic view-rank rule) do not apply here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


from . import fused_sv
from .rotate import ROT_LO, rotate_bits_down, rotate_region  # noqa: F401


@dataclasses.dataclass(frozen=True)
class KernelPass:
    """One fused-kernel pass: ``gate_idx[k]`` (index into the caller's gate
    list) applies at the physical bit(s) ``positions[k]`` (a 1-tuple for 1q
    gates, (control, target) for CNOT/CU, (a, b) for D2). ``pair_bits`` are
    the out-of-window bits this pass makes local."""
    gate_idx: Tuple[int, ...]
    positions: Tuple[Tuple[int, ...], ...]
    pair_bits: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Rotation:
    """Rotate index-bit region [ROT_LO, n) DOWN by ``shift``: the bit at
    position ROT_LO + j moves to ROT_LO + ((j - shift) mod size)."""
    shift: int


def _items_to_plan(supports, items) -> List[KernelPass]:
    """Rebuild KernelPass objects (with positions) from the native
    scheduler's compact records."""
    return [KernelPass(gate_idx=idx,
                       positions=tuple(supports[i] for i in idx),
                       pair_bits=tuple(pairs))
            for _, pairs, idx in items]


def _scan_pass(pending, supports, anchors, reach, pairs):
    """List-schedule one pass: take gates in order whose qubits are not
    blocked by an earlier unscheduled gate and whose ANCHOR qubits fit the
    window or the pair set (free/unanchored bits are resolved per block in
    the kernel)."""
    taken, blocked = [], set()
    for i in pending:
        s = supports[i]
        if any(q in blocked for q in s):
            blocked |= set(s)
            continue
        if all(q < reach or q in pairs for q in anchors[i]):
            taken.append(i)
        else:
            blocked |= set(s)
    return taken


def _grow_pass(pending, supports, anchors, reach, max_pairs):
    """Grow one pass's pair-bit set greedily: seed with the head gate's
    out-of-window bits (guarantees progress), then add the pair bit that
    schedules the most extra gates (ascending candidate order; strict
    improvement only — bit-identical to the native scheduler)."""
    head = pending[0]
    pairs = {q for q in anchors[head] if q >= reach}
    take = _scan_pass(pending, supports, anchors, reach, pairs)
    while len(pairs) < max_pairs:
        cands = sorted({q for i in pending
                        for q in anchors[i] if q >= reach} - pairs)
        best, best_take = None, take
        for p in cands:
            t = _scan_pass(pending, supports, anchors, reach, pairs | {p})
            if len(t) > len(best_take):
                best, best_take = p, t
        if best is None:
            break
        pairs.add(best)
        take = best_take
    return pairs, take


def plan_full_layer(n: int, supports: Sequence[Tuple[int, ...]], reach: int,
                    pair_ok: bool = True, max_pairs: int = None,
                    anchors: Sequence[Tuple[int, ...]] = None,
                    use_native: bool = True) -> List[KernelPass]:
    """Schedule gates (given by their qubit ``supports``) into KernelPass
    items covering all n qubits.

    ``reach`` is the number of low window bits; up to ``max_pairs``
    (default the f32 kernel's real-plane limit, ``fused_sv.MAX_PAIRS``; 0
    when ``pair_ok`` is false) extra bits
    >= reach per pass ride as pair bits. Gates with disjoint supports
    commute (may share or swap passes); a gate never overtakes an earlier
    gate touching any of its qubits.

    ``anchors[i]`` are the qubits of gate i that must fit the window or the
    pair set (default: its full support). A diagonal anchors nothing and a
    CNOT/CU with an out-of-window control anchors only its target: those
    bits are constant per kernel block. Dependency blocking always uses
    the full support. ``use_native=False`` runs the Python planner."""
    supports = [tuple(int(q) for q in s) for s in supports]
    anchors = supports if anchors is None else \
        [tuple(int(q) for q in a) for a in anchors]
    if any(q >= n for s in supports for q in s):
        raise ValueError(f"qubit out of range for n={n}: {supports}")
    if max_pairs is None:
        max_pairs = fused_sv.MAX_PAIRS
    if not pair_ok:
        max_pairs = 0
    if any(len([q for q in a if q >= reach]) > max(max_pairs, 0)
           for a in anchors):
        raise ValueError(
            f"a gate has more out-of-window anchored qubits than max_pairs="
            f"{max_pairs} at reach={reach}: {supports}")

    if use_native:
        from ._native_planner import plan_layer_native
        native = plan_layer_native(n, supports, reach, max_pairs,
                                   anchors=anchors)
        if native is not None:
            return _items_to_plan(supports, native)

    pending = list(range(len(supports)))  # gate indices, original order
    plan: List[KernelPass] = []
    while pending:
        pairs, take = _grow_pass(pending, supports, anchors, reach,
                                 max_pairs)
        if not take:
            raise AssertionError("scheduler made no progress")
        used = {q for i in take for q in anchors[i] if q >= reach}
        plan.append(KernelPass(
            gate_idx=tuple(take),
            positions=tuple(supports[i] for i in take),
            pair_bits=tuple(sorted(used))))
        taken_set = set(take)
        pending = [i for i in pending if i not in taken_set]
    return plan


def plan_full_1q_layer(n: int, qubits: Sequence[int], reach: int,
                       pair_ok: bool = True) -> List[KernelPass]:
    """:func:`plan_full_layer` of one-qubit gates on ``qubits``."""
    return plan_full_layer(n, [(int(q),) for q in qubits], reach,
                           pair_ok=pair_ok)


def execute_plan(re, im, plan: Sequence[object], gate_mats, n: int,
                 kinds: Sequence[str], real_flags: Sequence[bool] = None,
                 device=None, dense_mats=None):
    """Run a plan on a float-pair state: one fused-kernel call per
    :class:`KernelPass`, one rotation copy per plane for each
    :class:`Rotation`.

    ``kinds[i]`` is the i-th gate's kind ("U", "CNOT", "CU", "D2" or
    "U4"); ``gate_mats[i]`` its packed (2, 2, 2) matrix (numpy), and a
    U4's (4, 4, 2) one ``dense_mats[i]``. ``im=None`` runs
    every pass in the real-plane mode; ``re=None`` (with ``im=None``)
    starts from |0...0> on ``device``: the first pass generates it, or, when
    the plan starts with a rotation, the fill kernel writes it first. Positions are physical index bits: after a rotation they name
    the bits the rotation moved the qubits to."""
    for item in plan:
        if isinstance(item, Rotation):
            if re is None:
                re = fused_sv.init_zero(n, device)
            # no injected data dependency as in JAX: eager torch already
            # runs the two copies one after the other
            re = rotate_region(re, n, item.shift)
            if im is not None:
                im = rotate_region(im, n, item.shift)
            continue
        idx = list(item.gate_idx)
        flags = tuple(real_flags[i] for i in idx) \
            if real_flags is not None else None
        specs = tuple((kinds[i],) + tuple(p)
                      for i, p in zip(idx, item.positions))
        re, im = fused_sv.apply_fused_layer(
            re, im, specs, gate_mats[idx], pair_bits=item.pair_bits,
            real_flags=flags, num_qubits=n, device=device,
            dense_mats=None if dense_mats is None else dense_mats[idx])
    return re, im
