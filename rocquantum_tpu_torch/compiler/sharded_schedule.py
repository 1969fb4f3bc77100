"""Qubit-locality scheduling and layout relabels: a copy of
``rocquantum_tpu/compiler/sharded_schedule.py``.

On one device SWAP gates become free layout relabels (:func:`elide_swaps`)
and the identity layout is restored before a full-state readback
(:func:`unpermute_ops`). On a sharded state (parallel/sharded.py) a gate
may touch only local index bits, so :func:`schedule_for_sharding` rewrites
an op list: gates whose qubits sit on global (shard-selecting) bits get
them swapped into the local region first, by SWAP_BITS / PERMUTE_BITS
pseudo-ops, each one all-to-all round (the reference's rule,
MULTI_GPU_GUIDE.md:58-59, there left to the caller). Diagonal gates apply
at any layout and move nothing. The logical -> physical layout is threaded
through the caller, so readouts address physical bits.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .ir import GateOp

SWAP_BITS = "SWAP_BITS"  # pseudo-op: exchange two physical index bits
# pseudo-op: composed multi-bit relabel -- new bit targets[i] takes the
# value of old bit controls[i] (ops/statevec.permute_index_bits)
PERMUTE_BITS = "PERMUTE_BITS"


def permutation_of(op: GateOp) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(dsts, srcs) of a PERMUTE_BITS op; its adjoint is the inverse
    permutation (the two swapped)."""
    if op.is_adjoint:
        return op.controls, op.targets
    return op.targets, op.controls


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


def schedule_for_sharding(ops: Sequence[GateOp], n: int, n_global: int,
                          initial_layout: Sequence[int] = None
                          ) -> Tuple[List[GateOp], List[int]]:
    """Return (physical ops incl. SWAP_BITS, final layout).

    ``layout[logical] = physical index bit``. Gates whose logical qubits sit
    on global physical bits get those qubits swapped into the local region
    first, evicting the local occupant whose next use is farthest away
    (Belady-style) to minimize future swaps.
    """
    n_local = n - n_global
    if n_local <= 0:
        raise ValueError("mesh has no local qubits")
    layout = list(initial_layout) if initial_layout is not None \
        else list(range(n))
    if sorted(layout) != list(range(n)):
        raise ValueError("initial_layout must be a permutation")

    from .passes import is_diagonal

    # next-use table for the eviction heuristic (diagonal ops apply at any
    # layout, so they neither demand locality nor protect a bit from
    # eviction)
    next_use = {q: [] for q in range(n)}
    for step, op in enumerate(ops):
        if is_diagonal(op):
            continue
        for q in list(op.targets) + list(op.controls):
            next_use[q].append(step)

    out: List[GateOp] = []
    use_ptr = {q: 0 for q in range(n)}

    def next_use_of(q, step):
        uses = next_use[q]
        i = use_ptr[q]
        while i < len(uses) and uses[i] < step:
            i += 1
        return uses[i] if i < len(uses) else float("inf")

    for step, op in enumerate(ops):
        if _is_plain_swap(op):
            # SWAP = relabel: free, even across the device boundary (the
            # alternative is a full all-to-all)
            a, b = op.targets
            layout[a], layout[b] = layout[b], layout[a]
            for q in (a, b):
                use_ptr[q] += 1
            continue
        support = set(op.targets) | set(op.controls)
        if is_diagonal(op):
            # diagonal gates are elementwise in the computational basis:
            # a global qubit's bit value is constant per device, so the
            # phase multiply needs NO relabeling and NO communication —
            # emit on current physical bits (the reference relabeled every
            # non-local gate, MULTI_GPU_GUIDE.md:58-59; QAOA cost layers
            # and QFT phase cascades are comm-free here)
            out.append(GateOp(op.name,
                              tuple(layout[t] for t in op.targets),
                              tuple(layout[c] for c in op.controls),
                              op.params, op.matrix, op.is_adjoint))
            continue
        if len(support) > n_local:
            raise ValueError(
                f"gate support {sorted(support)} exceeds the local region "
                f"({n_local} qubits)")
        demanded = [q for q in sorted(support) if layout[q] >= n_local]
        if demanded:
            # Belady-guarded PREFETCH BATCHING: gather upcoming global-
            # qubit demands (first-use order) and localize them together —
            # each accepted pair rides the SAME PERMUTE_BITS, so a column
            # of gates over the global region costs ONE
            # all-to-all round instead of one per qubit. A prefetch is
            # accepted only when the evicted bit's next use lies AFTER the
            # prefetched qubit's first use (otherwise it is a net loss and
            # the scan stops — later candidates are used even later).
            seen = set(demanded)
            # windowed lookahead: keeps host-side scheduling O(N) on long
            # queues while still catching whole gate columns
            for later in ops[step + 1:step + 1 + 8 * n]:
                if is_diagonal(later) or _is_plain_swap(later):
                    continue
                for q in list(later.targets) + list(later.controls):
                    if q not in seen and layout[q] >= n_local:
                        demanded.append(q)
                        seen.add(q)
            pairs = []  # (global_phys, victim_phys, logical_q, victim_lq)
            taken = set()  # victim physical bits already claimed
            protected = set(support)
            phys_owner = {layout[l]: l for l in range(n)}
            # cap: 4 pairs per relabel (8 exposed bits, the JAX package's
            # compiler limit, kept so both packages emit the same
            # schedule), but never below the CURRENT op's required set
            n_req = sum(1 for q in demanded if q in support)
            cap = max(4, n_req)
            demanded = demanded[:cap]
            for idx, q in enumerate(demanded):
                candidates = [(next_use_of(phys_owner[p], step), p)
                              for p in range(n_local)
                              if p not in taken
                              and phys_owner[p] not in protected
                              and phys_owner[p] not in seen]
                if not candidates and q in support:
                    # a REQUIRED qubit must land: allow evicting a
                    # future-demanded occupant (prefetch exclusions are
                    # best-effort, locality is not)
                    candidates = [(next_use_of(phys_owner[p], step), p)
                                  for p in range(n_local)
                                  if p not in taken
                                  and phys_owner[p] not in protected]
                if not candidates:
                    break
                victim_next, victim_phys = max(candidates)
                if q not in support and victim_next <= next_use_of(q, step):
                    break  # prefetch would evict a sooner-needed bit
                victim_logical = phys_owner[victim_phys]
                pairs.append((layout[q], victim_phys, q, victim_logical))
                taken.add(victim_phys)
                protected.add(q)
            if len(pairs) == 1:
                g_phys, v_phys, q, v_lq = pairs[0]
                out.append(GateOp(SWAP_BITS, (g_phys, v_phys)))
            else:
                # one composed relabel: new[v] = old[g], new[g] = old[v]
                dsts, srcs = [], []
                for g_phys, v_phys, _, _ in pairs:
                    dsts.extend((v_phys, g_phys))
                    srcs.extend((g_phys, v_phys))
                out.append(GateOp(PERMUTE_BITS, tuple(dsts), tuple(srcs)))
            for g_phys, v_phys, q, v_lq in pairs:
                layout[q], layout[v_lq] = v_phys, g_phys
        # emit the gate on physical bits
        out.append(GateOp(op.name,
                          tuple(layout[t] for t in op.targets),
                          tuple(layout[c] for c in op.controls),
                          op.params, op.matrix, op.is_adjoint))
        for q in support:
            use_ptr[q] += 1

    return out, layout


def unpermute_ops(layout: Sequence[int], merge: bool = False
                  ) -> List[GateOp]:
    """Relabel sequence restoring the identity layout (for full
    statevector readback in logical order). ``merge=True`` (sharded
    callers) collapses the whole restore into ONE PERMUTE_BITS — one
    all-to-all round instead of one per displaced bit; the default
    SWAP_BITS chain serves single-device callers."""
    layout = list(layout)
    if merge:
        displaced = [lg for lg in range(len(layout)) if layout[lg] != lg]
        if not displaced:
            return []
        # restore: logical q's amplitude bit sits at physical layout[q];
        # after the relabel, bit q must hold old bit layout[q]'s value.
        # Emit per CYCLE-PACKED chunks of <= 8 bits (the JAX package's
        # view-rank limit, kept so both packages emit the same ops). A
        # union of complete cycles is an independently-applicable
        # permutation.
        cycles, visited = [], set()
        for lg in displaced:
            if lg in visited:
                continue
            cyc, cur = [], lg
            while cur not in visited:
                visited.add(cur)
                cyc.append(cur)
                cur = layout[cur]
            cycles.append(cyc)
        out = []
        chunk: List[int] = []
        for cyc in cycles:
            if len(cyc) > 8:
                # an oversized single cycle falls back to its swap chain
                sub = {q: layout[q] for q in cyc}
                lay = list(range(len(layout)))
                for q in cyc:
                    lay[q] = sub[q]
                out.extend(unpermute_ops(lay, merge=False))
                continue
            if chunk and len(chunk) + len(cyc) > 8:
                out.append(GateOp(PERMUTE_BITS, tuple(chunk),
                                  tuple(layout[q] for q in chunk)))
                chunk = []
            chunk.extend(cyc)
        if chunk:
            if len(chunk) == 2:
                out.append(GateOp(SWAP_BITS, tuple(chunk)))
            else:
                out.append(GateOp(PERMUTE_BITS, tuple(chunk),
                                  tuple(layout[q] for q in chunk)))
        return out
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
