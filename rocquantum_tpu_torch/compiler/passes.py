"""IR transformation passes, a jax-free copy of
``rocquantum_tpu/compiler/passes.py``.

- :func:`adjoint_ir` — the adjoint-generation transform: ops in reverse
  order, each with its ``is_adjoint`` flag toggled (the reference
  AdjointGenerationPass, AdjointGeneration.cpp:26-110).
- :func:`fuse_pallas_runs` — collect runs of kernel-eligible gates (1q, CNOT,
  controlled 1q, two-qubit diagonals and, where the kernel takes them,
  dense two-qubit matrices) into :class:`PallasBlock` s that the
  fused-layer kernel (ops/fused_sv.py) applies in few passes.
- :func:`fuse_diagonals` — group consecutive diagonal gates into
  :class:`DiagBlock` s.
- :func:`plan_fusion` — group adjacent gates whose combined qubit support
  fits in ``max_fuse`` qubits into :class:`FusedBlock` s applied as one
  dense matrix (generalizes the reference's GateFusion absorb-1q-into-CNOT
  scheme, GateFusion.cpp:89-156, and fixes its qubit-ordering bug).
- :func:`consolidate_low` / :func:`consolidate_high` — merge runs of gates
  on the lowest / highest index bits into one dense block.

The class name ``PallasBlock`` is kept from the JAX package so the two can
be read side by side; in this package such a block runs the CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .ir import CircuitIR, GateOp


def adjoint_ir(ir: CircuitIR) -> CircuitIR:
    """Return the adjoint circuit: reversed op order, each op daggered."""
    out = CircuitIR(ir.num_qubits, name=f"{ir.name}.adj")
    for op in reversed(ir.ops):
        out.ops.append(dataclasses.replace(op, is_adjoint=not op.is_adjoint))
    return out


@dataclasses.dataclass
class FusedBlock:
    """A run of gates applied as one dense matrix over ``qubits``."""
    qubits: Tuple[int, ...]  # sorted ascending; bit k of the fused matrix
    ops: List[GateOp]


@dataclasses.dataclass
class DiagBlock:
    """A run of diagonal gates applied elementwise: each member contributes
    a broadcastable phase factor."""
    ops: List[GateOp]

    @property
    def qubits(self) -> Tuple[int, ...]:
        s = set()
        for op in self.ops:
            s |= set(op.targets) | set(op.controls)
        return tuple(sorted(s))


@dataclasses.dataclass
class PallasBlock:
    """A run of kernel-eligible gates applied by the fused-layer kernel:
    the whole run costs one pass over the amplitudes per planned kernel
    pass (ops/relabel.py). ``plan`` is its structure on the kernel it was
    planned for (compiler/interpreter.py's ``BlockPlan``), set when its
    circuit is planned."""
    ops: List[GateOp]
    plan: object = dataclasses.field(default=None, compare=False,
                                     repr=False)

    @property
    def qubits(self) -> Tuple[int, ...]:
        s = set()
        for op in self.ops:
            s |= set(op.targets) | set(op.controls)
        return tuple(sorted(s))


def is_dense2q(op) -> bool:
    """A dense 4x4 matrix gate on two qubits with no control: the f32
    kernel's U4 kind."""
    return (isinstance(op, GateOp) and op.matrix is not None
            and getattr(op.matrix, "shape", None) == (4, 4)
            and len(op.targets) == 2 and not op.controls
            and op.name.upper() != "D2M")


def fuse_pallas_runs(items: List[object], max_qubit: int,
                     min_gates: int = 6, num_qubits: int = None,
                     relabel_reach: int = None,
                     kernel=None) -> List[object]:
    """Collect runs of uncontrolled 1q gates on qubits <= max_qubit into
    PallasBlocks (runs shorter than ``min_gates`` aren't worth the
    float-pair conversion passes). Disjoint items commute past an open
    run. Dense two-qubit matrix gates (:func:`is_dense2q`) join a run
    where ``kernel``, the module of the fused kernel that will run it
    (ops/fused_sv.py or ops/fused_df64.py), lists "U4" among its
    ``KINDS``.

    With ``relabel_reach`` set (the kernel's in-tile window, see
    ops/relabel.py), gates ABOVE the window are accepted too and scheduled
    into pair-bit passes — but only when the resulting plan beats one pass
    per out-of-window gate; otherwise the run is
    split back into an in-window PallasBlock plus raw high-qubit ops (1q
    gates on distinct qubits commute, so the split preserves semantics).
    """
    out: List[object] = []
    block: PallasBlock = None
    dense2q = kernel is not None and "U4" in kernel.KINDS

    def supports(item):
        if isinstance(item, (FusedBlock, DiagBlock, PallasBlock)):
            return set(item.qubits)
        return set(item.targets) | set(item.controls)

    def _sup(op):
        """Qubit support of an eligible op (2q forms: (control, target))."""
        name = op.name.upper()
        if name in ("RZZ", "D2M") or is_dense2q(op):
            return (op.targets[0], op.targets[1])
        if name in ("CNOT", "CX", "CZ", "CRZ", "CRX", "CRY"):
            if op.controls:
                return (op.controls[0], op.targets[0])
            return (op.targets[0], op.targets[1])
        if op.controls:  # controlled 1q (diagonal -> "D2", dense -> "CU")
            return (op.controls[0], op.targets[0])
        return (op.targets[0],)

    def eligible(item):
        if not isinstance(item, GateOp):
            return False
        name = item.name.upper()
        if item.matrix is not None:
            if name == "D2M":  # generic 2q diagonal: rides as "D2"
                s = _sup(item)
                return len(s) == 2 and all(q <= max_qubit for q in s)
            if is_dense2q(item):  # dense 4x4 -> kernel kind "U4"
                return dense2q and all(q <= max_qubit for q in item.targets)
            # dense 2x2 matrix gates ride as "U" / "CU" (one control);
            # traced matrices (adjoint-grad embeds tracers) are fine — the
            # kernel takes gate matrices as runtime inputs
            if getattr(item.matrix, "shape", None) != (2, 2):
                return False
            if len(item.targets) != 1 or len(item.controls) > 1:
                return False
            return all(q <= max_qubit for q in _sup(item))
        if name in ("CNOT", "CX"):
            ok = ((len(item.controls) == 1 and len(item.targets) == 1)
                  or (not item.controls and len(item.targets) == 2))
            return ok and all(q <= max_qubit for q in _sup(item))
        if is_diagonal(item):
            # diagonals ride the kernel as masked multiplies ("D2" for the
            # controlled-phase family, "U" for plain 1q diagonals) — the
            # QFT's H + controlled-phase cascade becomes ONE kernel pass
            s = _sup(item)
            nq = len(item.controls) + len(item.targets)
            return (nq <= 2 and len(s) == nq
                    and all(q <= max_qubit for q in s))
        if name in ("CRX", "CRY") or (len(item.controls) == 1
                                      and len(item.targets) == 1):
            # controlled dense 1q -> kernel kind "CU" (free high controls)
            s = _sup(item)
            return len(s) == 2 and all(q <= max_qubit for q in s)
        return (not item.controls and len(item.targets) == 1
                and name not in ("SWAP_BITS", "PERMUTE_BITS", "SWAP")
                and item.targets[0] <= max_qubit)

    def emit_run(ops):
        if relabel_reach is None:
            out.append(PallasBlock(ops=ops))
            return
        sups = [_sup(op) for op in ops]
        # ANCHORS: diagonals are free (grid-resolved bits), a CNOT's
        # out-of-window control likewise — neither forces pairing/splits
        def _anchor(op, s):
            if is_diagonal(op):
                return ()
            if is_dense2q(op):  # both qubits in registers
                return s
            # every eligible non-diagonal 2q form is (control, target) —
            # CNOT/CX and the CU family both resolve an out-of-window
            # control from the grid/pair position, so only the target
            # anchors
            if len(s) == 2 and s[0] >= relabel_reach:
                return (s[1],)
            return s

        anchors = [_anchor(op, s) for op, s in zip(ops, sups)]
        high_idx = [i for i, a in enumerate(anchors)
                    if any(q >= relabel_reach for q in a)]
        if not high_idx:
            out.append(PallasBlock(ops=ops))
            return
        from ..ops.relabel import plan_full_layer
        try:
            plan = plan_full_layer(num_qubits, sups, relabel_reach,
                                   pair_ok=num_qubits > relabel_reach,
                                   anchors=anchors)
        except ValueError:
            # unschedulable without rotations (pair-bit-only regime at
            # n > MAX_ROTATION_QUBITS): force the split path below
            plan = list(range(2 * len(ops) + 2))
        n_items = len(plan)
        # old-path cost for the same run: one fused pass for the in-window
        # gates plus roughly one pass per out-of-window gate
        if n_items <= 1 + len(high_idx) and n_items < len(ops):
            out.append(PallasBlock(ops=ops))
            return
        # inefficient plan: split back into an in-window block + raw high
        # ops — ONLY when no high op shares a qubit with a low op (the
        # split reorders across the run, which is valid only for disjoint
        # supports); otherwise keep the (dependency-correct) plan
        high_qubits = {q for i in high_idx for q in sups[i]}
        low_idx = [i for i in range(len(ops)) if i not in set(high_idx)]
        if any(set(sups[i]) & high_qubits for i in low_idx):
            out.append(PallasBlock(ops=ops))
            return
        low = [ops[i] for i in low_idx]
        if len(low) >= min_gates:
            out.append(PallasBlock(ops=low))
        else:
            out.extend(low)
        out.extend(ops[i] for i in high_idx)

    def flush():
        nonlocal block
        if block is not None:
            if len(block.ops) >= min_gates:
                emit_run(block.ops)
            else:
                out.extend(block.ops)
            block = None

    for item in items:
        if eligible(item):
            if block is None:
                block = PallasBlock(ops=[])
            block.ops.append(item)
        elif block is not None and supports(item) & set(block.qubits):
            flush()
            out.append(item)
        else:
            out.append(item)
    flush()
    return out


# Diagonal named gates (incl. implicitly-controlled forms: a controlled
# diagonal is diagonal).
_DIAGONAL_NAMES = {"Z", "S", "SDG", "T", "TDG", "RZ", "P", "PHASE",
                   "CZ", "CRZ", "RZZ"}


def is_diagonal(op: GateOp) -> bool:
    if op.name.upper() == "D2M":
        # generic 2q diagonal: op.matrix holds the 2x2 of diagonal VALUES
        # d[bit_t0, bit_t1] (diagonal channel superops lower to this)
        return True
    return (op.matrix is None and op.name.upper() in _DIAGONAL_NAMES)


def fuse_diagonals(ops: List[object]) -> List[object]:
    """Group consecutive diagonal gates into DiagBlocks; non-diagonal ops on
    disjoint qubits commute past an open block. Pre-built blocks (e.g.
    PallasBlocks when the Pallas pass runs first) pass through."""
    out: List[object] = []
    block: DiagBlock = None

    def flush():
        nonlocal block
        if block is not None:
            # singletons stay DiagBlocks: the elementwise phase multiply is
            # one cheap pass, while a lone cross-region controlled-phase on
            # the dense slice path measured 6.3 ms vs 0.27 ms for an entire
            # fused 19-gate cascade (n=20, v5e)
            out.append(block)
            block = None

    for op in ops:
        if isinstance(op, GateOp) and is_diagonal(op):
            if block is None:
                block = DiagBlock(ops=[])
            block.ops.append(op)
        else:
            if isinstance(op, (FusedBlock, DiagBlock, PallasBlock)):
                support = set(op.qubits)
            else:
                support = set(op.targets) | set(op.controls)
            if block is not None and support & set(block.qubits):
                flush()
            out.append(op)
    flush()
    return out


def _support(op: GateOp) -> Tuple[int, ...]:
    return tuple(sorted(set(op.targets) | set(op.controls)))


def plan_fusion(ops: List[GateOp], max_fuse: int = 2) -> List[object]:
    """Group ops into FusedBlocks / passthrough GateOps.

    Greedy single-pass scheme: maintain open blocks with pairwise-disjoint
    qubit supports (disjoint unitaries commute, so emission order among them
    is free). An op joins an open block when it intersects exactly that block
    and the union support fits in ``max_fuse`` qubits. Ops with larger
    support (e.g. MCX with many controls) pass through unfused, flushing the
    blocks they touch, preserving the controlled slice-update fast path.
    """
    if max_fuse < 1:
        return list(ops)

    emitted: List[object] = []
    open_blocks: List[FusedBlock] = []

    def flush(blocks):
        for b in blocks:
            open_blocks.remove(b)
            if len(b.ops) == 1:
                emitted.append(b.ops[0])  # keep original (controlled) form
            else:
                emitted.append(b)

    for op in ops:
        if isinstance(op, (DiagBlock, PallasBlock)):
            flush([b for b in open_blocks if set(b.qubits) & set(op.qubits)])
            emitted.append(op)
            continue
        q = _support(op)
        if len(q) > max_fuse or op.name in ("SWAP_BITS",
                                            "PERMUTE_BITS"):
            # SWAP_BITS is a layout relabel, not a unitary to fuse — it must
            # stay a transpose so sharded states reshard via all-to-all
            flush([b for b in open_blocks if set(b.qubits) & set(q)])
            emitted.append(op)
            continue
        touching = [b for b in open_blocks if set(b.qubits) & set(q)]
        if len(touching) == 1:
            b = touching[0]
            union = tuple(sorted(set(b.qubits) | set(q)))
            if len(union) <= max_fuse:
                b.qubits = union
                b.ops.append(op)
                continue
        elif not touching:
            # Disjoint from every open block: blocks are pairwise disjoint
            # (they commute), so the op may join any block with room —
            # kron-fusing independent gates into one pass. Prefer the
            # fullest block that still fits.
            candidates = [b for b in open_blocks
                          if len(b.qubits) + len(q) <= max_fuse]
            if candidates:
                b = max(candidates, key=lambda b: len(b.qubits))
                b.qubits = tuple(sorted(set(b.qubits) | set(q)))
                b.ops.append(op)
                continue
            open_blocks.append(FusedBlock(qubits=q, ops=[op]))
            continue
        flush(touching)
        open_blocks.append(FusedBlock(qubits=q, ops=[op]))

    flush(list(open_blocks))
    return emitted


def _consolidate_region(items: List[object], region: set,
                        block_qubits: tuple) -> List[object]:
    """Merge consecutive items supported inside ``region`` into FusedBlocks
    over ``block_qubits``; region-disjoint items pass through (commute)."""
    out: List[object] = []
    open_block = None

    def support(item):
        if isinstance(item, (FusedBlock, DiagBlock, PallasBlock)):
            return set(item.qubits)
        return set(item.targets) | set(item.controls)

    def members(item):
        return item.ops if isinstance(item, (FusedBlock, DiagBlock)) \
            else [item]

    def flush():
        nonlocal open_block
        if open_block is not None:
            out.append(open_block)
            open_block = None

    for item in items:
        s = support(item)
        if isinstance(item, PallasBlock):
            # the pallas kernel already applies its run in one pass; never
            # re-densify it
            if s & region:
                flush()
            out.append(item)
            continue
        is_relabel = (not isinstance(item, (FusedBlock, DiagBlock))
                      and item.name in ("SWAP_BITS", "PERMUTE_BITS"))
        if s <= region and not is_relabel:
            if open_block is None:
                open_block = FusedBlock(qubits=block_qubits, ops=[])
            open_block.ops.extend(members(item))
        elif s & region or is_relabel:
            flush()
            out.append(item)
        else:
            out.append(item)
    flush()
    return out


def consolidate_low(items: List[object], width: int) -> List[object]:
    """Second fusion stage: merge consecutive items whose qubit support lies
    entirely in {0..width-1} into one FusedBlock over all ``width`` low
    qubits, applied as a single (R, 2^width) @ W matmul. Items fully above
    the low region commute with the open block and pass through without
    flushing it.
    """
    if width < 1:
        return list(items)
    return _consolidate_region(items, set(range(width)),
                               tuple(range(width)))


def consolidate_high(items: List[object], width: int, n: int) -> List[object]:
    """Mirror of consolidate_low for the TOP ``width`` qubits: merged runs
    apply as one (2^width, 2^width) @ (2^width, R) left-matmul."""
    if width < 1:
        return list(items)
    return _consolidate_region(items, set(range(n - width, n)),
                               tuple(range(n - width, n)))
