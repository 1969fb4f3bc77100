"""Fused gate-layer pass on the f32 state vector: the counterpart of
``rocquantum_tpu/ops/pallas_sv.py``.

:func:`apply_fused_layer` applies an ordered list of gate specs to every
amplitude of a flat ``(2^n,)`` float32 state plane pair ``(re, im)`` in one
pass, or of a batch of such states held as contiguous ``(b, 2^n)`` planes
(one launch covers every element). On CUDA tensors it launches the
hand-written kernel in ``csrc/fused_sv.cu`` (built with nvcc at first use,
updated in place); on
CPU tensors it runs :func:`apply_fused_layer_reference`, the plain-torch
version the tests and ``chip_smoke.py`` hold the kernel against.
:func:`init_zero` writes |0...0> into a new plane, on CUDA with the fill
kernel of the same source (plain version :func:`_zero_plane`).

Specs, as in the JAX package: ``("U", q)`` dense 2x2 ``gate_mats[k]`` on
qubit q; ``("CNOT", c, t)``; ``("CU", c, t)`` controlled 2x2; ``("D2", a,
b)`` multiply by the packed diagonal ``gate_mats[k, bit_a, bit_b]``.
``gate_mats`` is ``(K, 2, 2, 2)`` float32 ``[k, row, col, re/im]`` (CNOT
rows are placeholders). ``im=None`` is the real-plane mode (every gate
real); ``re=None`` (with ``im=None`` and ``num_qubits``) starts the pass
from |0...0> instead of reading a state.

Which specs a pass may take: targets (and CNOT/CU controls below the
window) in the low :data:`W_BITS` index bits or in at most
:func:`max_pairs` "pair bits" above them: :data:`MAX_PAIRS` on the real
plane, :data:`MAX_PAIRS_COMPLEX` on re+im (whose amplitudes take twice the
registers). Other CNOT/CU controls and D2 bits need no pairing: the kernel
reads them from the tile's base index. The pass planner (ops/relabel.py)
packs gate lists into such passes with :func:`plan_geometry`: on the real
plane it counts window bits 7-9 as pair bits too, so that a tile holds at
most 2^12 amplitudes.

How a pass runs (:func:`pass_schedule`, cached by structure): one block per
TILE, the amplitudes of the tile bits: index bits 0-6 (one 512-byte row a
warp) and every bit a gate targets, padded to at least 10 bits; the other
bits (window bits 7-9 included) are constant over a tile. A thread holds
2^:func:`reg_bits` amplitudes in registers, so a tile of up to 12 bits is
one warp. The schedule names, for each point of the pass, which tile bits
are register bits (a gate's target must be one) and which are thread bits;
it orders the gates (never past an earlier gate on a shared qubit) so that
few layout changes ("swaps", one exchange through shared memory each) are
needed, and decodes every gate into the kernel's record. The records go to
the kernel by value.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .statevec import num_qubits_of, view_dims

W_BITS = 10     # the window: low bits any pass may target
MAX_PAIRS = 5   # targeted bits above the window, anywhere in [W_BITS, n)
MAX_PAIRS_COMPLEX = 3  # the same on re+im planes
LANE_BITS = 5
ROW_BITS = 2 + LANE_BITS  # bits 0-6: a float4 per lane, 512 bytes a warp
MIN_TILE_BITS = 10  # 32 amplitudes a thread; the smallest state taken
PLAN_REACH = ROW_BITS  # real-plane passes: bits below need no pairing
EXCHANGE_REG_BITS = 5  # register bits of a launch that needs exchanges
IO_LANES = tuple(range(2, ROW_BITS))  # lanes of the load/store layout
MAX_OPS = 96      # gate and swap records of one launch
MAX_LAYOUTS = 8   # layouts of one launch
_SLOTS = 16

_KIND_CODES = {"U": 0, "CNOT": 1, "CU": 2, "D2": 3}
SWAP = 4
# bit sources of a record: class << 8 | index
SRC_NONE, SRC_REG, SRC_THREAD, SRC_FREE = 0, 1, 2, 3

_OP_DTYPE = np.dtype([("kind", np.uint8), ("real", np.uint8),
                      ("t", np.uint8), ("pad", np.uint8), ("a", np.int16),
                      ("b", np.int16), ("m", np.float32, 8)])
_PARAMS_DTYPE = np.dtype([
    ("n", np.int32), ("w", np.int32), ("tile_bits", np.int32),
    ("reg_bits", np.int32), ("num_ops", np.int32), ("gen_zero", np.int32),
    ("batch", np.int32), ("lbits", np.int8, _SLOTS),
    ("layouts", np.int8, (MAX_LAYOUTS, _SLOTS)),
    ("ops", _OP_DTYPE, MAX_OPS)])
assert _OP_DTYPE.itemsize == 40 and _PARAMS_DTYPE.itemsize == 4012

# kernel launches in this process: fused passes, those of them in the
# start-from-|0...0> mode and those over a batch of more than one state,
# and |0...0> fills
LAUNCHES = 0
INIT_LAUNCHES = 0
BATCHED_LAUNCHES = 0
ZERO_LAUNCHES = 0

_LIB = None


def window_bits(n: int) -> int:
    """Low local bits of a pass on an n-qubit state (the planner's reach)."""
    return min(W_BITS, n)


def max_pairs(complex_carry: bool) -> int:
    """Pair bits a pass may take on the real plane or on re+im."""
    return MAX_PAIRS_COMPLEX if complex_carry else MAX_PAIRS


def plan_geometry(n: int, complex_carry: bool) -> Tuple[int, int]:
    """The pass planner's (reach, max_pairs) for this kernel. On the real
    plane a pass may target bits 0-6 and :data:`MAX_PAIRS` bits above
    them (window bits 7-9 count as pair bits), so its tile has at most
    2^12 amplitudes; on re+im the window and :data:`MAX_PAIRS_COMPLEX`."""
    if complex_carry:
        return window_bits(n), MAX_PAIRS_COMPLEX
    return min(PLAN_REACH, n), MAX_PAIRS


def reg_bits(tile: int, complex_carry: bool) -> int:
    """Most register bits per thread of a launch with ``tile`` tile bits
    (bits 0-1 are one float4): on the real plane every tile bit off the
    lanes, up to 7 (128 amplitudes a thread, one warp per tile up to 12
    tile bits, then up to 8 warps); on re+im 5."""
    return 5 if complex_carry else min(tile - LANE_BITS, 7)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load_cuda("fused_sv")
        lib.rocq_fused_pass.restype = ctypes.c_int
        lib.rocq_fused_pass.argtypes = [ctypes.c_void_p] * 4
        lib.rocq_init_zero.restype = ctypes.c_int
        lib.rocq_init_zero.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _normalize_specs(specs) -> Tuple[tuple, ...]:
    out = []
    for spec in specs:
        kind = spec[0]
        if kind not in _KIND_CODES:
            raise ValueError(f"unknown gate kind {kind!r} in {spec}")
        qs = tuple(int(q) for q in spec[1:])
        if len(qs) != (1 if kind == "U" else 2):
            raise ValueError(f"malformed spec {spec}")
        out.append((kind,) + qs)
    return tuple(out)


def _anchored(spec, w: int) -> Tuple[int, ...]:
    """Qubits of a spec that must lie in the pass's local set: a U target;
    a CNOT/CU target and its control when the control is below the window
    (a control above it may be a free, block-resolved bit); no D2 bit."""
    kind = spec[0]
    if kind == "D2":
        return ()
    if kind == "U":
        return (spec[1],)
    return (spec[2],) if spec[1] >= w else (spec[1], spec[2])


def _check_layer(re, im, specs, gate_mats, pair_bits, real_flags,
                 num_qubits):
    """Validate a call; returns (n, specs, pair_bits, real_flags)."""
    if re is None:
        if im is not None or num_qubits is None:
            raise ValueError("re=None (start from |0...0>) requires im=None "
                             "and num_qubits")
        n = int(num_qubits)
    else:
        n = num_qubits_of(re)
    specs = _normalize_specs(specs)
    if real_flags is None:
        real_flags = (False,) * len(specs)
    real_flags = tuple(bool(f) for f in real_flags)
    if len(real_flags) != len(specs):
        raise ValueError("real_flags length must match specs")
    if im is None and not all(real_flags):
        raise ValueError("real-plane mode (im=None) requires every gate "
                         "matrix to be real")
    if tuple(np.shape(gate_mats)) != (len(specs), 2, 2, 2):
        raise ValueError(f"gate_mats must have shape ({len(specs)}, 2, 2, 2)"
                         f", got {tuple(np.shape(gate_mats))}")
    pair_bits = _check_specs(n, specs, pair_bits, window_bits(n),
                             max_pairs(im is not None))
    return n, specs, pair_bits, real_flags


def _check_specs(n: int, specs, pair_bits, w: int,
                 limit: int) -> Tuple[int, ...]:
    """Check that every spec fits a pass with these pair bits on an n-qubit
    state, for a kernel with a ``w``-bit window and ``limit`` pair bits;
    returns the pair bits sorted."""
    pair_bits = tuple(sorted({int(p) for p in pair_bits}))
    if len(pair_bits) > limit:
        raise ValueError(f"at most {limit} pair bits per pass, got "
                         f"{pair_bits}")
    if any(not w <= p < n for p in pair_bits):
        raise ValueError(f"pair bits {pair_bits} must lie in [{w}, {n})")
    local = set(range(w)) | set(pair_bits)
    for spec in specs:
        if any(not 0 <= q < n for q in spec[1:]):
            raise ValueError(f"qubit out of range for n={n}: {spec}")
        if spec[0] != "U" and spec[1] == spec[2] and spec[0] != "D2":
            raise ValueError(f"control equals target in {spec}")
        if any(q not in local for q in _anchored(spec, w)):
            raise ValueError(f"{spec} touches a qubit outside the pass's "
                             f"local set (bits < {w} and {pair_bits})")
    return pair_bits


# ---- the pass schedule ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where each local position of a tile sits: ``reg[k]`` is the local
    position held by register bit k of every thread, ``thread[k]`` the one
    on bit k of the thread index (lanes first, then warps)."""
    reg: Tuple[int, ...]
    thread: Tuple[int, ...]

    @property
    def is_io(self) -> bool:
        """Loads and stores need local bits 0-1 in one float4 and local
        bits 2-6 on the lanes, in order."""
        return self.reg[:2] == (0, 1) and \
            self.thread[:LANE_BITS] == IO_LANES


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a pass: the qubit of each local position
    (``lbits``), the layouts (0 loads, the last one in force stores) and
    the records in execution order, ``(kind, spec, t, a, b)``: ``spec`` is
    the index of the gate in the pass's spec list (-1 for a swap), ``t``
    the target register bit or, for a swap, the new layout's index, ``a``
    and ``b`` bit sources (``class << 8 | index``)."""
    lbits: Tuple[int, ...]
    layouts: Tuple[Layout, ...]
    program: Tuple[Tuple[int, int, int, int, int], ...]

    @property
    def tile_bits(self) -> int:
        return len(self.lbits)

    @property
    def reg_bits(self) -> int:
        return len(self.layouts[0].reg)

    @property
    def swaps(self) -> int:
        return sum(op[0] == SWAP for op in self.program)


def _local_bits(specs) -> Tuple[int, ...]:
    """The tile bits of a launch: bits 0-6, every target above them, and
    the lowest other bits above them up to MIN_TILE_BITS; ascending."""
    extra = {s[-1] for s in specs if s[0] != "D2" and s[-1] >= ROW_BITS}
    q = ROW_BITS
    while ROW_BITS + len(extra) < MIN_TILE_BITS:
        extra.add(q)
        q += 1
    return tuple(range(ROW_BITS)) + tuple(sorted(extra))


def _io_layout(regs, tile_bits: int) -> Layout:
    """The IO layout holding local positions ``regs`` (0 and 1 among them,
    none of 2-6) in registers: lanes on 2-6, warps on the rest."""
    warps = [p for p in range(tile_bits)
             if p not in regs and p not in IO_LANES]
    return Layout((0, 1) + tuple(sorted(set(regs) - {0, 1})),
                  IO_LANES + tuple(warps))


def _general_layout(regs, tile_bits: int) -> Layout:
    """A layout with ``regs`` in registers and lanes on positions of
    distinct residues mod 5 where it can (bank-conflict-free exchanges)."""
    rest = [p for p in range(tile_bits) if p not in regs]
    lanes = []
    for r in range(LANE_BITS):
        pick = next((p for p in rest if p % 5 == r and p not in lanes), None)
        if pick is not None:
            lanes.append(pick)
    lanes += [p for p in rest if p not in lanes][:LANE_BITS - len(lanes)]
    warps = [p for p in rest if p not in lanes]
    return Layout(tuple(sorted(regs)), tuple(lanes) + tuple(warps))


class _Scheduler:
    """List-schedules one launch's gates over register layouts."""

    def __init__(self, specs, lbits, regs: int):
        self.specs = specs
        self.tile_bits = len(lbits)
        self.regs = regs
        self.pos = {q: i for i, q in enumerate(lbits)}
        self.target = [None if s[0] == "D2" else self.pos[s[-1]]
                       for s in specs]
        supports = [set(s[1:]) for s in specs]
        self.preds = [[j for j in range(i) if supports[j] & supports[i]]
                      for i in range(len(specs))]

    def closure(self, done, regs) -> list:
        """Run, in list order, every gate whose predecessors ran and whose
        target (if any) is in ``regs``; returns them (``done`` grows)."""
        run = []
        for i in range(len(self.specs)):
            if i in done or not all(j in done for j in self.preds[i]):
                continue
            if self.target[i] is None or self.target[i] in regs:
                done.add(i)
                run.append(i)
        return run

    def grow(self, done, allowed, seed):
        """Register set for the next layout: from ``seed``, add the target
        of the first gate that is ready but blocked, until the thread's
        register bits are used; returns it and the gates it would run."""
        regs, sim = set(seed), set(done)
        while True:
            self.closure(sim, regs)
            if len(regs) == self.regs:
                break
            nxt = next((self.target[i] for i in range(len(self.specs))
                        if i not in sim and self.target[i] in allowed
                        and all(j in sim for j in self.preds[i])), None)
            if nxt is None:
                break
            regs.add(nxt)
        return regs, sim

    def fill(self, regs, allowed):
        """Top ``regs`` up to the register bits from ``allowed``."""
        for p in sorted(allowed, reverse=True):
            if len(regs) == self.regs:
                break
            regs.add(p)
        return regs

    def run(self):
        t = self.tile_bits
        io_allowed = {0, 1} | set(range(ROW_BITS, t))
        everything = set(range(t))
        regs, _ = self.grow(set(), io_allowed, {0, 1})
        layouts = [_io_layout(self.fill(regs, io_allowed), t)]
        program, done = [], set()
        while True:
            cur = layouts[-1]
            program += [self.encode(i, cur)
                        for i in self.closure(done, set(cur.reg))]
            if len(done) == len(self.specs):
                break
            regs, sim = self.grow(done, io_allowed, {0, 1})
            if len(sim) == len(self.specs):  # the rest fits a store layout
                layouts.append(_io_layout(self.fill(regs, io_allowed), t))
            else:
                regs, _ = self.grow(done, everything, set())
                layouts.append(_general_layout(self.fill(regs, everything),
                                               t))
            program.append((SWAP, -1, len(layouts) - 1, 0, 0))
        if not layouts[-1].is_io:
            keep = sorted(p for p in layouts[-1].reg if p >= ROW_BITS)
            regs = self.fill({0, 1} | set(keep[:self.regs - 2]), io_allowed)
            layouts.append(_io_layout(regs, t))
            program.append((SWAP, -1, len(layouts) - 1, 0, 0))
        return tuple(layouts), tuple(program)

    def source(self, q: int, layout: Layout) -> int:
        p = self.pos.get(q)
        if p is None:
            return SRC_FREE << 8 | q
        if p in layout.reg:
            return SRC_REG << 8 | layout.reg.index(p)
        return SRC_THREAD << 8 | layout.thread.index(p)

    def encode(self, i: int, layout: Layout):
        spec = self.specs[i]
        kind = _KIND_CODES[spec[0]]
        if spec[0] == "D2":
            b = SRC_NONE if spec[1] == spec[2] else \
                self.source(spec[2], layout)
            return (kind, i, 0, self.source(spec[1], layout), b)
        t = layout.reg.index(self.target[i])
        a = self.source(spec[1], layout) if spec[0] != "U" else SRC_NONE
        return (kind, i, t, a, SRC_NONE)


@dataclasses.dataclass(frozen=True)
class Rule:
    """What one launch of a fused kernel holds, for the scheduler:
    ``reg_bits(tile_bits, complex_carry)`` register bits a thread,
    ``exchange_reg_bits`` the register bits of a launch that needs
    exchanges (when fewer; None: never fewer), and the records and layouts
    of one parameter block."""
    reg_bits: Callable[[int, bool], int]
    exchange_reg_bits: Optional[int]
    max_ops: int
    max_layouts: int


F32_RULE = Rule(reg_bits, EXCHANGE_REG_BITS, MAX_OPS, MAX_LAYOUTS)


@functools.lru_cache(maxsize=4096)
def pass_schedule(n: int, specs: Tuple[tuple, ...],
                  complex_carry: bool = False,
                  rule: Rule = F32_RULE) -> Tuple[Launch, ...]:
    """The kernel launches of one pass on the real plane or on re+im
    (structure only: normalized ``specs`` that :func:`_check_specs`
    accepted), within ``rule`` (this module's kernel by default).
    Usually one; a pass whose records or layouts exceed one launch's room
    is split, in list order, into several."""
    if n < MIN_TILE_BITS:
        raise ValueError(f"the fused kernel needs n >= {MIN_TILE_BITS}, got "
                         f"n={n}")
    return _schedule_split(specs, complex_carry, 0, rule)


def _schedule_split(specs, complex_carry: bool, offset: int,
                    rule: Rule) -> Tuple[Launch, ...]:
    lbits = _local_bits(specs)
    regs = rule.reg_bits(len(lbits), complex_carry)
    layouts, program = _Scheduler(specs, lbits, regs).run()
    if (rule.exchange_reg_bits is not None
            and regs > rule.exchange_reg_bits and len(lbits) <= 13
            and any(op[0] == SWAP for op in program)):
        # a pass with exchanges has many targets: fewer amplitudes a thread
        # keep each gate's code short and more warps on an SM
        layouts, program = _Scheduler(specs, lbits,
                                      rule.exchange_reg_bits).run()
    if len(specs) > 1 and (len(program) > rule.max_ops
                           or len(layouts) > rule.max_layouts):
        half = len(specs) // 2
        return (_schedule_split(specs[:half], complex_carry, offset, rule)
                + _schedule_split(specs[half:], complex_carry,
                                  offset + half, rule))
    if len(program) > rule.max_ops or len(layouts) > rule.max_layouts:
        raise AssertionError("one gate does not fit one launch")
    program = tuple((k, s + offset if s >= 0 else s, t, a, b)
                    for k, s, t, a, b in program)
    return (Launch(lbits, layouts, program),)


def _rank5(vectors) -> int:
    """GF(2) rank of 5-bit vectors."""
    basis = []
    for v in vectors:
        for b in basis:
            v = min(v, v ^ b)
        if v:
            basis.append(v)
    return len(basis)


def swap_banks(lanes_from, lanes_to, tile_bits: int) -> Tuple[int, ...]:
    """The bank flips of one exchange: ``g[p - 5]`` for local positions
    p >= 5. Shared-memory word of local index l: l XOR the g of its set bits
    >= 5, an invertible swizzle; the bank vector of position p is 1 << p
    below 5, else g[p - 5]. Chosen so that both layouts' lanes have
    independent bank vectors: every warp access of the exchange is
    conflict-free. Tries the residue flip 1 << (p % 5) first."""
    high = sorted({p for p in tuple(lanes_from) + tuple(lanes_to) if p >= 5})
    g = {p: 0 for p in range(5, tile_bits)}

    def vectors(lanes):
        return [1 << p if p < 5 else g[p] for p in lanes
                if p < 5 or p in assigned]

    assigned = set()

    def search(k):
        if k == len(high):
            return True
        p = high[k]
        for v in [1 << (p % 5)] + [v for v in range(1, 32)
                                   if v != 1 << (p % 5)]:
            g[p] = v
            assigned.add(p)
            if all(_rank5(vectors(lanes)) == len(vectors(lanes))
                   for lanes in (lanes_from, lanes_to)):
                if search(k + 1):
                    return True
            assigned.discard(p)
        g[p] = 0
        return False

    if not search(0):
        raise AssertionError(f"no conflict-free swizzle for lanes "
                             f"{lanes_from} -> {lanes_to}")
    for p in range(5, tile_bits):
        if p not in assigned:
            g[p] = 1 << (p % 5)
    return tuple(g[p] for p in range(5, tile_bits))


@functools.lru_cache(maxsize=4096)
def _packed(n: int, launch: Launch, dtype: np.dtype = _PARAMS_DTYPE):
    """The launch's parameter block of ``dtype`` (this module's or the df64
    kernel's: the same header, layouts and record fields, with ``m``
    holding 2 or 4 floats an entry) without matrices and real flags, and
    where those go: (template, op rows, spec index per row, matrix gather
    index per row)."""
    op_dtype = dtype.fields["ops"][0].base
    width = op_dtype.fields["m"][0].shape[0]  # floats of the 4 entries
    entry = width // 4
    params = np.zeros((), dtype)
    params["n"] = n
    params["w"] = ROW_BITS
    params["tile_bits"] = launch.tile_bits
    params["reg_bits"] = launch.reg_bits
    params["num_ops"] = len(launch.program)
    params["lbits"][:launch.tile_bits] = launch.lbits
    for k, lay in enumerate(launch.layouts):
        params["layouts"][k, :launch.tile_bits] = lay.reg + lay.thread
    ops = params["ops"]
    rows, spec_idx, gather = [], [], []
    plain = np.arange(width)
    # D2(q, q): m[x][x] at entry 2x
    folded = np.concatenate([np.arange(entry) + entry * e
                             for e in (0, 0, 3, 3)])
    raw = params.reshape(1).view(np.uint8)
    cur = 0
    for r, (kind, spec, t, a, b) in enumerate(launch.program):
        ops["kind"][r], ops["t"][r], ops["a"][r], ops["b"][r] = kind, t, a, b
        if kind == SWAP:
            # the record's matrix bytes carry the exchange's bank flips
            g = swap_banks(launch.layouts[cur].thread[:LANE_BITS],
                           launch.layouts[t].thread[:LANE_BITS],
                           launch.tile_bits)
            at = dtype.fields["ops"][1] + r * op_dtype.itemsize \
                + op_dtype.fields["m"][1]
            raw[at:at + len(g)] = g
            cur = t
            continue
        rows.append(r)
        spec_idx.append(spec)
        pattern = folded if kind == _KIND_CODES["D2"] and b == SRC_NONE \
            else plain
        gather.append(width * spec + pattern)
    return (params, np.asarray(rows, np.int64), np.asarray(spec_idx, np.int64),
            np.asarray(gather, np.int64).reshape(-1, width))


def pack_launch(n: int, launch: Launch, gate_mats, real_flags,
                dtype: np.dtype = _PARAMS_DTYPE) -> np.ndarray:
    """One launch's parameter block of ``dtype`` (a numpy scalar) with the
    gate matrices (``(K, 2, 2, width / 4)`` float32) and real flags of the
    pass's specs filled in."""
    template, rows, spec_idx, gather = _packed(n, launch, dtype)
    params = template.copy()
    if len(rows):
        flat = np.ascontiguousarray(gate_mats, np.float32).reshape(-1)
        ops = params["ops"]
        ops["m"][rows] = flat[gather]
        ops["real"][rows] = np.asarray(real_flags, np.uint8)[spec_idx]
    return params


def launch_params(n: int, launch: Launch, gate_mats, real_flags,
                  gen_zero: bool, batch: int = 1) -> np.ndarray:
    """The kernel's parameter block for one launch over ``batch`` states
    (a numpy scalar of ``_PARAMS_DTYPE``, laid out as ``PassParams`` in
    csrc/fused_sv.cu)."""
    params = pack_launch(n, launch, gate_mats, real_flags)
    params["gen_zero"] = int(gen_zero)
    params["batch"] = batch
    return params


def apply_fused_layer(re: Optional[torch.Tensor], im: Optional[torch.Tensor],
                      specs: Sequence[tuple], gate_mats,
                      pair_bits: Sequence[int] = (),
                      real_flags: Sequence[bool] = None,
                      num_qubits: int = None, device=None):
    """Apply ``specs`` to the state in one pass; returns ``(re, im)``.

    The planes are ``(2^n,)``, or ``(b, 2^n)`` for a batch of b states
    (any b >= 1), every element getting the same gates in the same
    launches. On CUDA the planes are updated in place and returned (a fresh
    ``re`` in the ``re=None`` mode, allocated on ``device``, which defaults
    to the current CUDA device); on the CPU the plain reference returns new
    planes. Raises ``ValueError`` on specs the pass cannot take and
    ``RuntimeError`` when the launch fails."""
    n, specs, pair_bits, real_flags = _check_layer(
        re, im, specs, gate_mats, pair_bits, real_flags, num_qubits)
    batch = 1 if re is None else re.numel() >> n
    if re is not None:
        device = re.device
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return apply_fused_layer_reference(re, im, specs, gate_mats,
                                           real_flags=real_flags,
                                           num_qubits=n, device=device)
    if re is not None and not specs:
        return re, im
    for name, plane in (("re", re), ("im", im)):
        if plane is None:
            continue
        _check_plane(name, plane, n, device, re.shape)
    launches = pass_schedule(n, specs, im is not None, F32_RULE)
    gen_zero = re is None
    if gen_zero:
        re = torch.empty(1 << n, dtype=torch.float32, device=device)
    if isinstance(gate_mats, torch.Tensor):
        gate_mats = gate_mats.detach().cpu().numpy()
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = build()
    global LAUNCHES, INIT_LAUNCHES, BATCHED_LAUNCHES
    for k, launch in enumerate(launches):
        params = launch_params(n, launch, gate_mats, real_flags,
                               gen_zero and k == 0, batch)
        LAUNCHES += 1
        INIT_LAUNCHES += gen_zero and k == 0
        BATCHED_LAUNCHES += batch > 1
        err = lib.rocq_fused_pass(
            re.data_ptr(), None if im is None else im.data_ptr(),
            params.ctypes.data, stream)
        if err != 0:
            raise RuntimeError(f"fused_sv kernel launch failed: cudaError_t "
                               f"{err} (n={n}, batch={batch}, pair_bits="
                               f"{pair_bits}, {len(specs)} gates)")
    return re, im


def _check_plane(name: str, plane: torch.Tensor, n: int, device,
                 shape=None):
    """A plane the kernel may take: contiguous float32 of ``shape`` (that
    of ``re``: ``(2^n,)`` or ``(b, 2^n)``; default ``(2^n,)``) on
    ``device``."""
    if plane.dtype != torch.float32 or not plane.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor")
    if shape is None:
        shape = (1 << n,)
    batch = plane.numel() >> n
    if (plane.device != device or plane.shape != shape
            or plane.dim() not in (1, 2) or batch < 1
            or plane.numel() != batch << n):
        raise ValueError(f"{name} must be a ({1 << n},) or (b, {1 << n}) "
                         f"plane shaped as re on {device}, got "
                         f"{tuple(plane.shape)}")
    if plane.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         f"kernel moves float4s)")


def init_zero(n: int, device=None) -> torch.Tensor:
    """|0...0> as a new ``(2^n,)`` float32 plane on ``device`` (default
    the current CUDA device): the fill kernel on CUDA, :func:`_zero_plane`
    on the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return _zero_plane(n, device)
    plane = torch.empty(1 << n, dtype=torch.float32, device=device)
    lib = build()
    global ZERO_LAUNCHES
    ZERO_LAUNCHES += 1
    err = lib.rocq_init_zero(plane.data_ptr(), n,
                             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sv init kernel launch failed: "
                           f"cudaError_t {err} (n={n})")
    return plane


def _zero_plane(n: int, device) -> torch.Tensor:
    plane = torch.zeros(1 << n, dtype=torch.float32, device=device)
    plane[0] = 1.0
    return plane


def apply_fused_layer_reference(re, im, specs, gate_mats, pair_bits=(),
                                real_flags=None, num_qubits=None,
                                device=None):
    """Plain-torch version of :func:`apply_fused_layer`: applies the specs
    in order to the full planes (``(2^n,)`` or a ``(b, 2^n)`` batch)
    through strided views, with no notion of the kernel's local set
    (``pair_bits`` is accepted and ignored). Returns new planes; the inputs
    are not modified."""
    specs = _normalize_specs(specs)
    if real_flags is not None and im is None and not all(real_flags):
        raise ValueError("real-plane mode (im=None) requires every gate "
                         "matrix to be real")
    if re is None:
        if im is not None or num_qubits is None:
            raise ValueError("re=None requires im=None and num_qubits")
        re = _zero_plane(int(num_qubits),
                         device if device is not None else "cpu")
    else:
        re = re.clone()
    im = None if im is None else im.clone()
    n = num_qubits_of(re)
    if isinstance(gate_mats, torch.Tensor):
        gate_mats = gate_mats.detach().cpu().numpy()
    # coefficients as Python floats (float32 values, as the kernel reads)
    mats = np.asarray(gate_mats, np.float32).astype(np.float64).tolist()
    x_mat = [[[0.0, 0.0], [1.0, 0.0]], [[1.0, 0.0], [0.0, 0.0]]]
    for spec, m in zip(specs, mats):
        kind = spec[0]
        if kind == "D2":
            _ref_diag(re, im, n, spec[1], spec[2], m)
        elif kind == "U":
            _ref_pair(re, im, n, spec[1], None, m)
        else:
            _ref_pair(re, im, n, spec[2], spec[1],
                      x_mat if kind == "CNOT" else m)
    return re, im


def _views(re, im, n, bits_desc):
    """Views exposing ``bits_desc``; a batch folds into the top axis."""
    dims = view_dims(re, bits_desc)
    return re.view(dims), None if im is None else im.view(dims)


def _ref_pair(re, im, n, target, control, m):
    """2x2 ``m`` on ``target`` where ``control`` (if any) is 1, in place."""
    bits = [target] if control is None else [target, control]
    desc = sorted(bits, reverse=True)
    v_re, v_im = _views(re, im, n, desc)
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    idx = [slice(None)] * (2 * len(desc) + 1)
    if control is not None:
        idx[axis[control]] = 1
    idx0, idx1 = list(idx), list(idx)
    idx0[axis[target]] = 0
    idx1[axis[target]] = 1
    idx0, idx1 = tuple(idx0), tuple(idx1)
    x0r, x1r = v_re[idx0].clone(), v_re[idx1].clone()
    if v_im is None:
        v_re[idx0] = m[0][0][0] * x0r + m[0][1][0] * x1r
        v_re[idx1] = m[1][0][0] * x0r + m[1][1][0] * x1r
        return
    x0i, x1i = v_im[idx0].clone(), v_im[idx1].clone()
    for row, dst in ((0, idx0), (1, idx1)):
        (ar, ai), (br, bi) = m[row]
        v_re[dst] = ar * x0r - ai * x0i + br * x1r - bi * x1i
        v_im[dst] = ar * x0i + ai * x0r + br * x1i + bi * x1r


def _ref_diag(re, im, n, a, b, m):
    """Multiply each amplitude by ``m[bit_a][bit_b]`` (complex), in place."""
    desc = sorted({a, b}, reverse=True)
    v_re, v_im = _views(re, im, n, desc)
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    for ba in (0, 1):
        for bb in (0, 1):
            if a == b and ba != bb:
                continue
            idx = [slice(None)] * (2 * len(desc) + 1)
            idx[axis[a]] = ba
            idx[axis[b]] = bb
            idx = tuple(idx)
            dr, di = m[ba][bb]
            if v_im is None:
                v_re[idx] *= dr
                continue
            xr, xi = v_re[idx].clone(), v_im[idx].clone()
            v_re[idx] = dr * xr - di * xi
            v_im[idx] = dr * xi + di * xr
