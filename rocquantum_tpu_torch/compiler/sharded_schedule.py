"""Qubit relabels for the single-device flush: the two functions of
``rocquantum_tpu/compiler/sharded_schedule.py`` that a circuit on one device
uses. SWAP gates become free layout relabels (:func:`elide_swaps`), and the
identity layout is restored before a full-state readback
(:func:`unpermute_ops`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .ir import GateOp

SWAP_BITS = "SWAP_BITS"  # pseudo-op: exchange two physical index bits


def _is_plain_swap(op: GateOp) -> bool:
    return (op.name == "SWAP" and not op.controls and op.matrix is None)


def elide_swaps(ops: Sequence[GateOp], layout: Sequence[int]
                ) -> Tuple[List[GateOp], List[int]]:
    """Turn SWAP gates into layout relabels (zero data movement — SWAP is
    self-adjoint so the is_adjoint flag is irrelevant) and map all other
    ops' qubits through the evolving logical->physical layout."""
    layout = list(layout)
    out: List[GateOp] = []
    for op in ops:
        if _is_plain_swap(op):
            a, b = op.targets
            layout[a], layout[b] = layout[b], layout[a]
            continue
        out.append(GateOp(op.name,
                          tuple(layout[t] for t in op.targets),
                          tuple(layout[c] for c in op.controls),
                          op.params, op.matrix, op.is_adjoint))
    return out, layout


def unpermute_ops(layout: Sequence[int]) -> List[GateOp]:
    """SWAP_BITS chain restoring the identity layout (for a full
    statevector readback in logical order)."""
    layout = list(layout)
    out = []
    for logical in range(len(layout)):
        phys = layout[logical]
        if phys == logical:
            continue
        # swap bits so that logical sits at position logical
        other = layout.index(logical)
        out.append(GateOp(SWAP_BITS, (phys, logical)))
        layout[logical], layout[other] = logical, phys
    return out
