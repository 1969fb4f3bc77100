"""Sharded state vectors over a device mesh.

Counterpart of ``rocquantum_tpu/parallel/sharded.py`` (the reference's
multi-GPU state: MULTI_GPU_GUIDE.md:19-78; rocsvSwapIndexBits's count/pack
kernels and rcclAlltoallv, swap_kernels.hip:46-114). The ``2^n``
amplitudes are cut into ``2^M`` shards: the top M index bits select the
shard, with the ``dcn`` bits above the ``sv`` bits on a multislice mesh. A
:class:`ShardedState` keeps, on each distinct device of the mesh, the rows
of one ``(k, 2^L)`` tensor (L = n - M): one row per shard the device holds
(times the batch elements it holds, for a batched state). A gate on local
bits is then one batched call per device, whatever k is.

Where the JAX package lets XLA partition the program, every collective
here is explicit, issued with torch copies (``copy_`` between cards rides
peer to peer; within a card it is a copy in device memory):

* :func:`permute_bits` with bits crossing the local/global boundary is the
  reference's pack + all-to-all: a local permute puts the outgoing bits on
  top of the local index, one block all-to-all (chunk ``j`` of shard ``s``
  to chunk ``s`` of shard ``j``, with any relabel among global bits folded
  into the same round), and a closing local permute. A relabel among
  global bits only is a collective-permute of whole shards;
* readouts reduce per-shard float64 partials, summed in shard order on the
  device of shard 0 (the all-reduce);
* only a full read-back gathers (:func:`gather`).

Each round adds one to its entry of :data:`COUNTS` (JAX's collective
names, :func:`count_collectives`) and its bytes to :data:`BYTES_MOVED`:
the bytes whose source and destination cards differ: shards that share a
device exchange within its memory and cross no boundary, unless the mesh
repeats one device throughout (virtual shards), where each shard stands
for a card. An exchange round is also the span ``rq.exchange``
(utils/profiling), timed on every device of the mesh; the readouts count
their plane passes (``readout_passes``) and give each Pauli term a span
``rq.expval.term``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..ops import fused_sv, pairsim
from ..ops import gates as _g
from ..ops import statevec as sv
from ..utils import profiling
from .mesh import BATCH_AXIS, DCN_AXIS, SV_AXIS, Mesh

_F64 = torch.float64

COUNTS: Dict[str, int] = {"all-to-all": 0, "all-gather": 0, "all-reduce": 0,
                          "collective-permute": 0, "reduce-scatter": 0}
BYTES_MOVED = 0


def reset_collectives():
    """Set every collective count and the byte counter to 0."""
    global BYTES_MOVED
    for k in COUNTS:
        COUNTS[k] = 0
    BYTES_MOVED = 0


def count_collectives() -> dict:
    """Rounds of each collective issued since :func:`reset_collectives`
    (the JAX package counts them in compiled HLO text)."""
    return dict(COUNTS)


def _count(op: str, nbytes: int):
    global BYTES_MOVED
    COUNTS[op] += 1
    BYTES_MOVED += int(nbytes)


def _nbytes(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else x.numel() * x.element_size()


def on_device(device: torch.device):
    """A context that makes ``device`` current (a CUDA kernel launches on
    the current device's stream), or nothing for a CPU device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Sharding descriptor
# ---------------------------------------------------------------------------

def _amp_axes(mesh: Mesh, axis_name: str = SV_AXIS) -> Tuple[str, ...]:
    """Mesh axes the amplitude index spans: (dcn, sv) on multislice
    meshes, just ``axis_name`` otherwise."""
    if DCN_AXIS in mesh.axis_names and axis_name == SV_AXIS:
        return (DCN_AXIS, axis_name)
    return (axis_name,)


def num_global_qubits(mesh: Mesh, axis_name: str = SV_AXIS) -> int:
    """M = log2(P): the number of shard-selecting (global) index bits."""
    size = 1
    for a in _amp_axes(mesh, axis_name):
        size *= mesh.shape[a]
    return (size - 1).bit_length()


class StateSharding:
    """Where the cells of a sharded state live: cell ``(block, shard)`` is
    shard ``shard`` of batch block ``block`` (one block unless ``batch``
    and the mesh has a ``dp`` axis; other axes hold replicas, of which the
    first is used)."""

    def __init__(self, mesh: Mesh, axis_name: str = SV_AXIS,
                 batch: bool = False):
        if axis_name not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no "
                             f"{axis_name!r} axis")
        self.mesh, self.axis_name, self.batch = mesh, axis_name, batch
        amp = _amp_axes(mesh, axis_name)
        names = list(mesh.axis_names)
        has_dp = BATCH_AXIS in names and BATCH_AXIS not in amp
        order = ([BATCH_AXIS] if has_dp else []) + list(amp) + [
            a for a in names if a not in amp and a != BATCH_AXIS]
        grid = np.transpose(mesh.devices, [names.index(a) for a in order])
        grid = grid if has_dp else grid[None]
        if not batch:
            grid = grid[:1]
        self.num_shards = int(np.prod([mesh.shape[a] for a in amp]))
        if self.num_shards & (self.num_shards - 1):
            raise ValueError(f"the amplitude axes {amp} hold "
                             f"{self.num_shards} devices, not a power of two")
        self.n_global = (self.num_shards - 1).bit_length()
        self.blocks = grid.shape[0]
        grid = grid.reshape(self.blocks, self.num_shards, -1)[:, :, 0]
        self.grid = [[grid[b, s] for s in range(self.num_shards)]
                     for b in range(self.blocks)]
        # the distinct devices in first-use order, with their cells
        self.parts: List[Tuple[torch.device, List[Tuple[int, int]]]] = []
        self.loc: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for b in range(self.blocks):
            for s in range(self.num_shards):
                dev = self.grid[b][s]
                for i, (d, cells) in enumerate(self.parts):
                    if d == dev:
                        break
                else:
                    self.parts.append((dev, []))
                    i = len(self.parts) - 1
                self.loc[(b, s)] = (i, len(self.parts[i][1]))
                self.parts[i][1].append((b, s))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices, in the order of :attr:`parts`."""
        return tuple(d for d, _ in self.parts)

    def card(self, block: int, shard: int):
        """The card that holds cell ``(block, shard)``, for counting the
        bytes that cross cards: its device's index in :attr:`parts`, or,
        on a mesh that repeats one device (virtual shards, each standing
        for a card of its own), the cell itself."""
        if len(self.parts) == 1:
            return (block, shard)
        return self.loc[(block, shard)][0]

    def _key(self):
        return (self.mesh, self.axis_name, self.batch)

    def __eq__(self, other):
        return isinstance(other, StateSharding) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"StateSharding({self.mesh.shape}, shards={self.num_shards}, "
                f"blocks={self.blocks})")


def state_sharding(mesh: Mesh, axis_name: str = SV_AXIS,
                   batch: bool = False) -> StateSharding:
    """The sharding of a flat ``(2^n,)`` state (``batch``: a ``(b, 2^n)``
    state, its batch over the mesh's ``dp`` axis when it has one)."""
    return StateSharding(mesh, axis_name, batch)


def check_sharding(sharding, state=None) -> None:
    """Raise unless ``sharding`` is None or a :class:`StateSharding`
    (TypeError) and, with ``state``, the one that state carries
    (ValueError)."""
    if sharding is None:
        return
    if not isinstance(sharding, StateSharding):
        raise TypeError(f"sharding is a parallel.state_sharding, not "
                        f"{type(sharding).__name__}")
    if state is not None and (not isinstance(state, ShardedState)
                              or state.sharding != sharding):
        raise ValueError(f"the state is not sharded as {sharding!r}")


# ---------------------------------------------------------------------------
# The sharded state
# ---------------------------------------------------------------------------

Planes = Tuple[Optional[torch.Tensor], ...]


class ShardedState:
    """A ``(2^n,)`` state, or ``(b, 2^n)`` for a batch, cut into cells.

    ``parts[i]`` is the tuple of planes on ``sharding.parts[i]``'s device:
    one complex tensor, a float pair ``(re, im)`` (``im`` None for a real
    state) or the df64 engine's four hi/lo planes, each ``(rows, 2^L)``,
    the rows of cell k being ``[k * nb, (k + 1) * nb)`` (nb = b / blocks,
    1 unbatched)."""

    def __init__(self, sharding: StateSharding, num_qubits: int,
                 batch_size: Optional[int], parts: List[Planes]):
        if num_qubits <= sharding.n_global:
            raise ValueError(f"a {num_qubits}-bit state has no local bits "
                             f"over {sharding.num_shards} shards")
        self.sharding = sharding
        self.num_qubits = num_qubits
        self.batch_size = batch_size  # None: unbatched
        self.parts = list(parts)

    @property
    def batched(self) -> bool:
        return self.batch_size is not None

    @property
    def n_local(self) -> int:
        return self.num_qubits - self.sharding.n_global

    @property
    def rows_per_cell(self) -> int:
        return 1 if self.batch_size is None \
            else self.batch_size // self.sharding.blocks

    @property
    def device(self) -> torch.device:
        """The device of cell (0, 0), where reductions land."""
        return self.sharding.grid[0][0]

    def replace(self, parts: List[Planes]) -> "ShardedState":
        return ShardedState(self.sharding, self.num_qubits, self.batch_size,
                            parts)

    def map(self, fn) -> "ShardedState":
        """A new state with ``fn(planes)`` on every part, each with its
        device current."""
        out = []
        for (dev, _), planes in zip(self.sharding.parts, self.parts):
            with on_device(dev):
                out.append(tuple(fn(planes)))
        return self.replace(out)

    def cells(self):
        """(block, shard, planes of the cell's rows) for every cell, in
        (block, shard) order."""
        nb = self.rows_per_cell
        for b in range(self.sharding.blocks):
            for s in range(self.sharding.num_shards):
                i, k = self.sharding.loc[(b, s)]
                yield b, s, tuple(None if p is None else p[k * nb:(k + 1) * nb]
                                  for p in self.parts[i])

    def pairs(self):
        """:meth:`cells` with each cell's planes as a float pair ``(re,
        im_or_None)`` (a complex plane as views of its parts)."""
        for b, s, planes in self.cells():
            yield b, s, _as_pair(planes)


def _as_pair(planes: Planes):
    if planes[0].is_complex():
        return planes[0].real, planes[0].imag
    return planes[0], planes[1]


def _zeros(sharding: StateSharding, n: int, dtype, planes: str,
           batch_size: Optional[int]) -> ShardedState:
    """|0...0> in every element: ``planes`` "complex" (one tensor of
    ``dtype``), "pair" (float ``(re, zeros)``) or "real" (``(re, None)``).
    A complex64 part comes from the fill kernel (on CUDA) written over the
    part as float32 pairs, then its column 0 is set per row."""
    L = n - sharding.n_global
    nb = 1 if batch_size is None else batch_size // sharding.blocks
    if batch_size is not None and batch_size % sharding.blocks:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{sharding.blocks} blocks")
    parts = []
    for dev, cells in sharding.parts:
        rows = len(cells) * nb
        bits = L + 1 + (rows - 1).bit_length()
        if dtype == torch.complex64 and (1 << bits) == 2 * rows << L:
            with on_device(dev):
                plane = fused_sv.init_zero(bits, dev)
            t = torch.view_as_complex(plane.view(rows, 1 << L, 2))
        else:
            t = torch.zeros((rows, 1 << L), dtype=dtype, device=dev)
        t[:, 0] = torch.tensor([float(s == 0) for _, s in cells
                                for _ in range(nb)]).to(dev)
        parts.append((t,) if planes == "complex" else
                     (t, None if planes == "real" else torch.zeros_like(t)))
    return ShardedState(sharding, n, batch_size, parts)


def init_state(num_qubits: int, sharding: StateSharding, dtype=None,
               planes: str = "complex",
               batch_size: Optional[int] = None) -> ShardedState:
    """|0...0> born sharded: each device fills its rows. ``dtype`` is the
    tensor type (complex for "complex" planes, the float type of "pair" and
    "real" planes; default: the precision's)."""
    if dtype is None:
        dtype = config.complex_dtype() if planes == "complex" \
            else config.real_dtype()
    return _zeros(sharding, num_qubits, dtype, planes, batch_size)


def sharded_init_state(num_qubits: int, mesh: Mesh,
                       axis_name: str = SV_AXIS, dtype=None) -> ShardedState:
    """|0...0> as a sharded complex state (rocsvInitializeDistributedState,
    hipStateVec.h:105): no host round trip."""
    return init_state(num_qubits, state_sharding(mesh, axis_name), dtype)


def shard_state(state, mesh: Mesh, axis_name: str = SV_AXIS
                ) -> ShardedState:
    """Place a ``(2^n,)`` (or ``(b, 2^n)``) tensor, or a tuple of planes of
    that shape, onto the mesh (rocsvAllocateDistributedState + scatter)."""
    planes = tuple(state) if isinstance(state, (tuple, list)) else (state,)
    x = planes[0]
    batched = x.dim() == 2
    n = sv.num_qubits_of(x)
    sharding = state_sharding(mesh, axis_name, batch=batched)
    L = n - sharding.n_global
    b = x.shape[0] if batched else None
    nb = 1 if b is None else b // sharding.blocks
    parts = []
    for dev, cells in sharding.parts:
        out = []
        for p in planes:
            if p is None:
                out.append(None)
                continue
            v = p.reshape(sharding.blocks, nb, sharding.num_shards, 1 << L)
            out.append(torch.cat([v[blk, :, s] for blk, s in cells]).to(dev))
        parts.append(tuple(out))
    return ShardedState(sharding, n, b, parts)


def gather(state: ShardedState) -> Planes:
    """The whole state as planes on the device of cell (0, 0): ``(2^n,)``,
    or ``(b, 2^n)`` for a batch (one all-gather)."""
    nb, L = state.rows_per_cell, state.n_local
    dev = state.device
    home = state.sharding.card(0, 0)
    out = []
    moved = 0
    for k, p0 in enumerate(state.parts[0]):
        if p0 is None:
            out.append(None)
            continue
        full = torch.empty((state.sharding.blocks * nb,
                            state.sharding.num_shards << L),
                           dtype=p0.dtype, device=dev)
        for b, s, planes in state.cells():
            full[b * nb:(b + 1) * nb, s << L:(s + 1) << L].copy_(planes[k])
            if state.sharding.card(b, s) != home:
                moved += _nbytes(planes[k])
        out.append(full if state.batched else full[0])
    _count("all-gather", moved)
    return tuple(out)


def gather_slice(state: ShardedState, start: int, size: int) -> Planes:
    """Amplitudes ``[start, start + size)`` (of each element) as planes on
    the device of cell (0, 0), read from the shards that hold them."""
    L = state.n_local
    home = state.sharding.card(0, 0)
    blocks: List[list] = [[] for _ in range(state.sharding.blocks)]
    moved = 0
    for b, s, planes in state.cells():
        lo, hi = max(start, s << L), min(start + size, (s + 1) << L)
        if lo < hi:
            pieces = [None if p is None else p[:, lo - (s << L):hi - (s << L)]
                      for p in planes]
            if state.sharding.card(b, s) != home:
                moved += sum(_nbytes(p) for p in pieces)
            blocks[b].append([None if p is None else p.to(state.device)
                              for p in pieces])
    out = []
    for k, p0 in enumerate(state.parts[0]):
        if p0 is None:
            out.append(None)
            continue
        full = torch.cat([torch.cat([c[k] for c in blk], dim=-1)
                          for blk in blocks])
        out.append(full if state.batched else full[0])
    _count("all-gather", moved)
    return tuple(out)


# ---------------------------------------------------------------------------
# Relabels: local permutes, the all-to-all, collective-permutes
# ---------------------------------------------------------------------------

def _local_permute(state: ShardedState, moves) -> ShardedState:
    """Relabel local bits on every part: new bit d takes old bit s for each
    (d, s) of ``moves`` (one copy per plane; the rows ride along)."""
    dsts = [d for d, _ in moves]
    srcs = [s for _, s in moves]
    return state.map(lambda planes: (
        None if p is None else sv.permute_index_bits(p, dsts, srcs)
        for p in planes))


def permute_bits(state: ShardedState, dsts: Sequence[int],
                 srcs: Sequence[int]) -> ShardedState:
    """Relabel index bits: new bit ``dsts[i]`` takes the value of old bit
    ``srcs[i]`` (``dsts`` and ``srcs`` the same set). Local bits only: a
    local permute. Across the boundary: a local permute that puts the m
    outgoing bits on top of the local index, one block all-to-all round
    (2^m chunks a shard) and a closing local permute. Global bits only:
    the same block copies with whole shards as chunks, one
    collective-permute. A round that crosses the boundary, its local
    permutes included, is the span ``rq.exchange``."""
    n, L = state.num_qubits, state.n_local
    src_of = list(range(n))
    for d, s in zip(dsts, srcs):
        src_of[int(d)] = int(s)
    if sorted(src_of) != list(range(n)):
        raise ValueError(f"not a permutation: {tuple(dsts)} <- {tuple(srcs)}")
    if not any(src_of[g] != g for g in range(L, n)):
        return _relabel(state, src_of, [], [])
    with profiling.span("rq.exchange", devices=state.sharding.devices):
        return _relabel(state, src_of,
                        [src_of[g] for g in range(L, n) if src_of[g] < L],
                        [src_of[d] for d in range(L) if src_of[d] >= L])


def _relabel(state: ShardedState, src_of, out_vals, in_src
             ) -> ShardedState:
    """:func:`permute_bits` given ``src_of`` (new bit -> old bit), the
    local bits that leave (``out_vals``, in the order of the global bits
    they go to) and the global bits that come in (``in_src``)."""
    n, L, m = state.num_qubits, state.n_local, len(out_vals)
    # (a) the outgoing local bits to the top m local positions, the bits
    # they displace into the positions they leave
    pos = list(range(L))  # pos[p]: the old local bit at local position p
    displaced = [p for p in range(L - m, L) if p not in out_vals]
    vacated = sorted(v for v in out_vals if v < L - m)
    for j, v in enumerate(out_vals):
        pos[L - m + j] = v
    for p, v in zip(vacated, displaced):
        pos[p] = v
    pre = [(p, pos[p]) for p in range(L) if pos[p] != p]
    if pre:
        state = _local_permute(state, pre)
    # (b) the block copies: chunk bit j holds out_vals[j]; afterwards it
    # holds old global bit in_src[j], and new global bit g holds old
    # global bit src_of[g] or the chunk bit of src_of[g]
    if m or any(src_of[g] != g for g in range(L, n)):
        state = _exchange(state, src_of, out_vals, in_src)
    # (c) the closing local permute
    cur = {pos[p]: p for p in range(L - m)}
    for j, G in enumerate(in_src):
        cur[G] = L - m + j
    post = [(d, cur[src_of[d]]) for d in range(L) if cur[src_of[d]] != d]
    if post:
        state = _local_permute(state, post)
    return state


def _exchange(state: ShardedState, src_of, out_vals, in_src
              ) -> ShardedState:
    """Step (b) of :func:`permute_bits`: every chunk of every new shard
    copied from the chunk of the old shard that holds it (an all-to-all
    round when bits cross the boundary, else a collective-permute). The
    bytes counted are those copied between cards
    (:meth:`StateSharding.card`)."""
    n, L, m = state.num_qubits, state.n_local, len(out_vals)
    s_from_t, c_from_t = [], []
    for g in range(L, n):
        if src_of[g] >= L:
            s_from_t.append((src_of[g] - L, g - L))
        else:
            c_from_t.append((out_vals.index(src_of[g]), g - L))
    s_from_c = [(G - L, j) for j, G in enumerate(in_src)]
    chunk = 1 << (L - m)
    nb = state.rows_per_cell
    new = [[None if p is None else torch.empty_like(p) for p in part]
           for part in state.parts]
    moved = 0
    for b in range(state.sharding.blocks):
        for t in range(state.sharding.num_shards):
            it, kt = state.sharding.loc[(b, t)]
            s_base = 0
            for gs, gt in s_from_t:
                s_base |= ((t >> gt) & 1) << gs
            c_src = 0
            for j, gt in c_from_t:
                c_src |= ((t >> gt) & 1) << j
            for c in range(1 << m):
                s = s_base
                for gs, j in s_from_c:
                    s |= ((c >> j) & 1) << gs
                i_s, ks = state.sharding.loc[(b, s)]
                for k, p in enumerate(state.parts[i_s]):
                    if p is None:
                        continue
                    piece = p[ks * nb:(ks + 1) * nb,
                              c_src * chunk:(c_src + 1) * chunk]
                    new[it][k][kt * nb:(kt + 1) * nb,
                               c * chunk:(c + 1) * chunk].copy_(piece)
                    if state.sharding.card(b, s) != \
                            state.sharding.card(b, t):
                        moved += _nbytes(piece)
    _count("all-to-all" if m else "collective-permute", moved)
    return state.replace([tuple(p) for p in new])


def swap_index_bits_sharded(state: ShardedState, q1: int, q2: int,
                            mesh: Optional[Mesh] = None,
                            axis_name: str = SV_AXIS) -> ShardedState:
    """Exchange index bits q1 and q2 of a sharded state (local-local: a
    local permute; local-global: the all-to-all; global-global: a
    collective-permute). ``mesh`` and ``axis_name`` are the JAX package's
    arguments; the state carries its own sharding."""
    if q1 == q2:
        return state
    return permute_bits(state, (q1, q2), (q2, q1))


# ---------------------------------------------------------------------------
# Readouts: per-cell float64 partials, one all-reduce
# ---------------------------------------------------------------------------

def _reduce(state: ShardedState, partials) -> torch.Tensor:
    """Sum ``partials[(block, shard)]`` (``(nb, ...)`` float64) over the
    shards of each block, in shard order, on the device of cell (0, 0):
    ``(b, ...)`` for a batch, else the one row."""
    dev = state.device
    home = state.sharding.card(0, 0)
    rows = []
    moved = 0
    for b in range(state.sharding.blocks):
        acc = None
        for s in range(state.sharding.num_shards):
            x = partials[(b, s)]
            if state.sharding.card(b, s) != home:
                moved += _nbytes(x)
            if x.device != dev:
                x = x.to(dev)
            acc = x if acc is None else acc + x
        rows.append(acc)
    _count("all-reduce", moved)
    out = torch.cat(rows) if len(rows) > 1 else rows[0]
    return out if state.batched else out[0]


def norm2(state: ShardedState) -> torch.Tensor:
    """Sum |amp|^2 (of each element), float64."""
    return _reduce(state, {(b, s): pairsim.norm2_pair(re, im)
                           for b, s, (re, im) in state.pairs()})


def _bit(s: int, q: int, L: int) -> int:
    return (s >> (q - L)) & 1


def prob_one(state: ShardedState, qubit: int) -> torch.Tensor:
    """P(index bit ``qubit`` = 1) (of each element), float64."""
    L = state.n_local
    partials = {}
    for b, s, (re, im) in state.pairs():
        if qubit < L:
            partials[(b, s)] = pairsim.prob_one_pair(re, im, qubit)
        else:
            partials[(b, s)] = pairsim.norm2_pair(re, im) * _bit(s, qubit, L)
    return _reduce(state, partials)


def _outcome_rows(state: ShardedState, outcome, b: int) -> List[int]:
    """The outcome each row of a cell of block ``b`` is projected on."""
    nb = state.rows_per_cell
    if np.ndim(outcome) == 0:
        return [int(outcome)] * nb
    o = np.asarray(outcome).reshape(-1)
    return [int(v) for v in o[b * nb:(b + 1) * nb]]


def project(state: ShardedState, qubit: int, outcome) -> ShardedState:
    """Zero, in place, the amplitudes whose index bit ``qubit`` differs
    from ``outcome`` (one outcome, or one per element of a batch)."""
    L = state.n_local
    for b, s, planes in state.cells():
        for j, o in enumerate(_outcome_rows(state, outcome, b)):
            for p in planes:
                if p is None:
                    continue
                row = p[j]
                if qubit >= L:
                    if _bit(s, qubit, L) != o:
                        row.zero_()
                else:
                    row.view(-1, 2, 1 << qubit)[:, 1 - o].zero_()
    return state


def scale(state: ShardedState, factor) -> ShardedState:
    """Multiply, in place, every element by ``factor`` (a float, or one
    float per element of a batch)."""
    nb = state.rows_per_cell
    f = torch.as_tensor(np.broadcast_to(
        np.asarray(factor, np.float64).reshape(-1),
        (state.batch_size or 1,)).copy())
    for b, s, planes in state.cells():
        fb = f[b * nb:(b + 1) * nb, None]
        for p in planes:
            if p is not None:
                p.mul_(fb.to(device=p.device, dtype=p.real.dtype))
    return state


def collapse(state: ShardedState, qubit: int, outcome) -> ShardedState:
    """Project onto ``qubit = outcome`` and renormalize (in place; each
    element's norm guarded by ``config.eps()``), as pairsim.collapse_pair."""
    project(state, qubit, outcome)
    norm = torch.sqrt(norm2(state)).clamp(min=config.eps())
    return scale(state, (1.0 / norm).cpu().numpy())


def marginal_probs(state: ShardedState, qubits: Sequence[int]
                   ) -> torch.Tensor:
    """Marginal over index bits ``qubits`` (``qubits[0]`` the least
    significant bit of the outcome), float64: ``(2^k,)``, or ``(b, 2^k)``
    for a batch."""
    qubits = [int(q) for q in qubits]
    if len(set(qubits)) != len(qubits):
        raise ValueError(f"duplicate qubits: {qubits}")
    L = state.n_local
    local = [(j, q) for j, q in enumerate(qubits) if q < L]
    k = len(qubits)
    # output index of each local-marginal index (global bits added per cell)
    idx = np.zeros(1 << len(local), np.int64)
    for i in range(1 << len(local)):
        for jl, (j, _) in enumerate(local):
            idx[i] |= ((i >> jl) & 1) << j
    partials = {}
    for b, s, (re, im) in state.pairs():
        if local:
            marg = pairsim.marginal_probs_pair(re, im, [q for _, q in local])
        else:
            marg = pairsim.norm2_pair(re, im)[:, None]
        g = 0
        for j, q in enumerate(qubits):
            if q >= L:
                g |= _bit(s, q, L) << j
        out = torch.zeros(marg.shape[:-1] + (1 << k,), dtype=_F64,
                          device=marg.device)
        out[:, torch.as_tensor(idx | g, device=marg.device)] = marg
        partials[(b, s)] = out
    return _reduce(state, partials)


def _pauli_split(term, L: int):
    """(local ops in order, the global flip mask, phase(s)) of a Pauli
    string: P|s, l> = phase(s) |s ^ flip> (P_local |l>)."""
    local, mats = [], {}
    for ch, q in term:
        q = int(q)
        if ch == "I":
            continue
        if q < L:
            local.append((ch, q))
        else:
            mats[q] = _g.PAULI[ch] @ mats.get(q, np.eye(2))
    flip = 0
    for q, m in mats.items():
        flip |= int(abs(m[0, 1]) > 0.5) << (q - L)

    def phase(s: int) -> complex:
        f = 1.0 + 0j
        for q, m in mats.items():
            x = (s >> (q - L)) & 1
            off = abs(m[0, 1]) > 0.5
            f *= m[x ^ int(off), x]
        return f

    return local, flip, phase


def expval_terms(state: ShardedState, terms, coeffs) -> torch.Tensor:
    """Sum_k coeffs[k] <P_k> for Pauli strings on index bits, float64 (of
    each element). A term with X or Y on global bits pairs each shard with
    the shard its flip maps it to (rows fetched from another device count
    as one collective-permute for the term)."""
    L = state.n_local
    cells = {(b, s): pair for b, s, pair in state.pairs()}
    partials = {(b, s): torch.zeros(state.rows_per_cell, dtype=_F64,
                                    device=re.device)
                for (b, s), (re, _) in cells.items()}
    for term, c in zip(terms, coeffs):
        with profiling.span("rq.expval.term"):
            _term_partials(state, cells, partials, term, c)
    return _reduce(state, partials)


def _dot64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum(x * y) into float64 over the last axis, counted as the readout
    passes it makes (pairsim: a product, a sum, the sum's cast)."""
    pairsim._passes()
    return pairsim._sum64(x * y)


def _term_partials(state: ShardedState, cells, partials, term, c):
    """Add ``c <term>`` of every cell to ``partials``."""
    local, flip, phase = _pauli_split(term, state.n_local)
    fetched = 0
    for (b, s), (re, im) in cells.items():
        ph = phase(s)
        if not flip and not ph.imag:
            v = pairsim.expval_pauli_string_pair(re, im, local) * ph.real
        else:
            pre, pim = re, im
            for ch, q in local:
                pre, pim = pairsim._apply_pauli(pre, pim, ch, q)
            are, aim = cells[(b, s ^ flip)]
            if state.sharding.card(b, s ^ flip) != \
                    state.sharding.card(b, s):
                fetched += _nbytes(are) + _nbytes(aim)
            if are.device != re.device:
                pairsim._passes(1 if aim is None else 2)
                are = are.to(re.device)
                aim = None if aim is None else aim.to(re.device)
            # Re(phase(s) <psi_{s ^ flip}| P_local psi_s>)
            real = _dot64(are, pre)
            imag = torch.zeros_like(real)
            if aim is not None and pim is not None:
                real = real + _dot64(aim, pim)
            if pim is not None:
                imag = imag + _dot64(are, pim)
            if aim is not None:
                imag = imag - _dot64(aim, pre)
            v = real * ph.real - imag * ph.imag
        partials[(b, s)] = partials[(b, s)] + float(c) * v
    if fetched:
        _count("collective-permute", fetched)


def take(state: ShardedState, index: torch.Tensor) -> Planes:
    """Entries ``index`` (global flat indices, int64) of an unbatched
    state as float64 ``(re, im_or_None)`` on the device of cell (0, 0):
    each shard contributes the entries it holds (one all-reduce)."""
    L = state.n_local
    partials = {}
    real = True
    for b, s, (re, im) in state.pairs():
        idx = index.to(re.device)
        mine = (idx >> L) == s
        local = (idx & ((1 << L) - 1))[mine]
        vals = torch.zeros((1, 2) + idx.shape, dtype=_F64, device=re.device)
        vals[0, 0, mine] = re[0].take(local).to(_F64)
        if im is not None:
            real = False
            vals[0, 1, mine] = im[0].take(local).to(_F64)
        partials[(b, s)] = vals
    out = _reduce(state, partials)
    return out[0], None if real else out[1]
