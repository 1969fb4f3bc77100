"""Circuit IR -> fused-kernel passes on a float-pair or flat complex state.

The pair and flat paths of ``rocquantum_tpu/compiler/interpreter.py``. A
gate list is planned once per circuit structure (the passes of
compiler/passes.py, then the kernel-pass planner of ops/relabel.py) and the
plan is cached by the IR's structural key; a run builds the gate
coefficients on the host from the parameter values and replays the plan
eagerly. There is no jit: PyTorch runs each kernel pass as it is issued.

The pair state is two flat ``(2^n,)`` float32 planes ``(re, im)``, and
``(re, None)`` while the circuit stays real: runs of kernel-eligible gates
(PallasBlocks) go through the fused kernel (ops/fused_sv.py) with no complex
tensor in between; every other item converts to complex64 locally and runs
in plain torch (ops/statevec.py), as the JAX package leaves it to XLA.

The flat state is one ``(2^n,)`` complex64 tensor (:func:`execute`,
:func:`compile_ir`): it is split into float32 planes at the first
PallasBlock of a run of blocks and joined after it, and every other item
runs on it in plain torch. A complex128 flat state runs op by op, exactly.
A batched flat state, ``(b, 2^n)`` (``compile_ir(..., batched=True)``, where
the JAX package vmaps ``execute``), runs the same plan on every element:
its planes go through the batched fused kernel, one launch per pass for
the whole batch, and every other item through the batch-aware functions of
ops/statevec.py.

In double precision the state is a float64 pair, with two engines:
:func:`compile_df64_fused_ir` (the double-float engine, ``set_precision
("df64")``) splits it into hi/lo float32 planes at entry, runs the same plan
with PallasBlocks through the df64 kernel (ops/fused_df64.py) and every
other item op by op in df64 arithmetic (ops/df64.py), and promotes back to
float64 at exit; :func:`run_ops_f64` (``set_precision("double")``)
applies every op exactly on complex128 in plain torch.

A sharded state (parallel/sharded.py: one ``(k, 2^L)`` tensor of shard
rows a device) runs through :func:`run_sharded`: the plan is made on the
L local bits, a run of local items goes to each device once (every shard
row of it in one batched kernel launch a pass; df64 row by row), a
diagonal touching global bits runs on each shard as its own diagonal on
local bits, and SWAP_BITS / PERMUTE_BITS across the boundary are
all-to-all rounds (``compile_ir(sharding=...)``,
``compile_df64_fused_ir(sharding=...)``, :func:`run_ops_f64_sharded`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import df64 as dfm
from ..ops import fused_df64
from ..ops import fused_sv
from ..ops import gates as _g
from ..ops import relabel
from ..ops import statevec as sv
from ..parallel import sharded
from ..utils.cache import BoundedCache
from .ir import CircuitIR, GateOp, ParamRef
from .passes import (DiagBlock, FusedBlock, PallasBlock, consolidate_high,
                     consolidate_low, fuse_diagonals, fuse_pallas_runs,
                     is_diagonal, plan_fusion)
from .sharded_schedule import PERMUTE_BITS, SWAP_BITS, permutation_of

# Smallest state the flush routes through the fused kernel. The JAX package
# engages its kernels from n = 15 on; the port keeps the same threshold so
# the two make the same plans and the same (re, None) realness decisions.
KERNEL_MIN_QUBITS = 15

# Named gates that carry implicit control structure.
_IMPLICIT_CTRL = {"CNOT": "X", "CX": "X", "CZ": "Z",
                  "CRX": "RX", "CRY": "RY", "CRZ": "RZ",
                  "MCX": "X", "CCX": "X", "TOFFOLI": "X", "CSWAP": "SWAP"}

_ADJOINT_NAME = {"S": "SDG", "SDG": "S", "T": "TDG", "TDG": "T"}


def _host_params(params) -> Optional[np.ndarray]:
    """The parameter vector as host float64 values (one device read when
    it lives on the GPU)."""
    if params is None:
        return None
    if isinstance(params, torch.Tensor):
        params = params.detach().cpu().numpy()
    return np.asarray(params, np.float64).reshape(-1)


def _resolve_params(op: GateOp, params):
    return tuple(float(params[p.index]) if isinstance(p, ParamRef)
                 else float(p) for p in op.params)


def _split_op(op: GateOp):
    """Normalize an op to (base_name, controls, targets)."""
    name = op.name.upper()
    controls = list(op.controls)
    targets = list(op.targets)
    if name in _IMPLICIT_CTRL:
        base = _IMPLICIT_CTRL[name]
        if not controls:
            # CNOT/CZ/CRX emitted as targets=[control, target] without an
            # explicit control list (DSL style): peel controls off targets.
            n_tgt = 2 if base == "SWAP" else 1
            controls, targets = targets[:-n_tgt], targets[-n_tgt:]
        return base, controls, targets
    return name, controls, targets


def _base_matrix(op: GateOp, params) -> np.ndarray:
    """The (uncontrolled) unitary of ``op`` as a host complex128 array."""
    base, _, _ = _split_op(op)
    if base == "D2M":
        # matrix holds diagonal VALUES d[bit_t0, bit_t1], not a gate matrix
        m = np.asarray(op.matrix, np.complex128)
        if op.is_adjoint:
            m = np.conj(m)
        return np.diag([m[0, 0], m[1, 0], m[0, 1], m[1, 1]])
    if op.matrix is not None:
        mat = np.asarray(op.matrix, np.complex128)
    else:
        if op.is_adjoint and base in _ADJOINT_NAME:
            return _g.gate_matrix(_ADJOINT_NAME[base])
        mat = _g.gate_matrix(base, _resolve_params(op, params))
    if op.is_adjoint:
        mat = np.conj(mat).T
    return mat


_DIAG_VECS = {"Z": np.array([1, -1], np.complex128),
              "S": np.array([1, 1j]), "SDG": np.array([1, -1j]),
              "T": np.array([1, np.exp(1j * np.pi / 4)]),
              "TDG": np.array([1, np.exp(-1j * np.pi / 4)])}


def _diag_vector(op: GateOp, params) -> np.ndarray:
    """(2,) diagonal of the op's base gate (controls handled by caller)."""
    base, _, _ = _split_op(op)
    if base in _DIAG_VECS:
        d = _DIAG_VECS[base].astype(np.complex128)
    elif base == "RZ":
        (theta,) = _resolve_params(op, params)
        d = np.array([np.exp(-0.5j * theta), np.exp(0.5j * theta)])
    elif base in ("P", "PHASE"):
        (lam,) = _resolve_params(op, params)
        d = np.array([1.0, np.exp(1j * lam)], np.complex128)
    else:
        raise ValueError(f"gate {op.name} is not diagonal")
    if op.is_adjoint:
        d = np.conj(d)
    return d


def _phase_factor(state, values, desc):
    """Multiply ``state`` (or each element of a batch) by a factor tensor
    over the exposed qubits ``desc`` (descending)."""
    dims = sv.view_dims(state, desc)
    bshape = [1] * len(dims)
    for j in range(len(desc)):
        bshape[2 * j + 1] = 2
    f = torch.as_tensor(values, dtype=state.dtype, device=state.device)
    return (state.view(dims) * f.reshape(bshape)).reshape(state.shape)


def _diag_factor(op: GateOp, params):
    """(qubits in descending order, the op's diagonal as a complex128
    ``(2,) * k`` factor over them) of a diagonal op."""
    base, controls, targets = _split_op(op)
    if base in ("D2M", "RZZ"):
        if base == "D2M":
            m = np.asarray(op.matrix, np.complex128)
            if op.is_adjoint:
                m = np.conj(m)
        else:
            (theta,) = _resolve_params(op, params)
            if op.is_adjoint:
                theta = -theta
            em, ep = np.exp(-0.5j * theta), np.exp(0.5j * theta)
            m = np.array([[em, ep], [ep, em]])
        # factor axes follow DESCENDING qubit order
        return sorted(targets, reverse=True), \
            (m if targets[0] > targets[1] else m.T)
    d = _diag_vector(op, params)
    qubits = list(controls) + list(targets)
    desc = sorted(qubits, reverse=True)
    k = len(desc)
    # 1 everywhere except the all-controls-one slice, which carries the
    # target diagonal
    f = np.ones((2,) * k, np.complex128)
    idx = tuple(1 if desc[j] in set(controls) else slice(None)
                for j in range(k))
    f[idx] = d
    return desc, f


def _apply_diag_block(state: torch.Tensor, block: DiagBlock,
                      params) -> torch.Tensor:
    """Multiply every member's phase factor into the complex state."""
    for op in block.ops:
        desc, f = _diag_factor(op, params)
        state = _phase_factor(state, f, desc)
    return state


# 1q gates whose matrices are purely real: the kernel's real-plane mode and
# its cheaper real-matrix arithmetic depend on this static fact
_REAL_1Q = {"X", "H", "RY", "Z", "I", "ID"}


def _has_real_matrix(op: GateOp) -> bool:
    if op.matrix is not None:
        return bool(np.allclose(np.imag(np.asarray(op.matrix)), 0.0))
    return op.name.upper() in _REAL_1Q


# Parametrized gates the double-precision engines treat as complex at any
# angle (the JAX package's float64 row builders, pairsim.gate_rows)
_COMPLEX_ROWS = {"RX", "RZ", "P", "PHASE", "U3", "RZZ"}


def _real_flag(op: GateOp, m: np.ndarray, exact: bool) -> bool:
    """Whether the kernel may treat ``m``, the op's 2x2 (or D2 values), as
    real. ``exact`` is the double-precision rule of the JAX package's df64
    specs: no imaginary part at all, decided on the base gate (RY and the
    real fixed gates, under a control too); else the single-precision
    rule, by name or within float32 noise."""
    if not exact:
        return _has_real_matrix(op)
    return _split_op(op)[0] not in _COMPLEX_ROWS and not np.any(np.imag(m))


_D2_BASES = set(_DIAG_VECS) | {"RZ", "P", "PHASE"}


def _pack(m: np.ndarray) -> np.ndarray:
    return np.stack([np.real(m), np.imag(m)], axis=-1).astype(np.float32)


def _block_matrices(block: PallasBlock, params, exact_real: bool = False):
    """(kinds, supports, mats, real_flags) for a PallasBlock's ops, with
    each gate's 2x2 as a host complex128 matrix: kind "U" (dense 1q
    matrix), "CNOT" (control, target), "CU" (controlled dense 1q) or "D2" —
    a two-qubit diagonal given as the 2x2 of diagonal entries d[bit_a,
    bit_b]. ``exact_real`` selects the double-precision realness rule
    (:func:`_real_flag`)."""
    mats, kinds, supports, real_flags = [], [], [], []
    for op in block.ops:
        base, controls, targets = _split_op(op)
        if base == "D2M":
            m = np.asarray(op.matrix, np.complex128)
            if op.is_adjoint:
                m = np.conj(m)
            kinds.append("D2")
            supports.append((targets[0], targets[1]))
            mats.append(m)
            real_flags.append(_real_flag(op, m, exact_real))
        elif base == "X" and len(controls) == 1 and op.matrix is None:
            kinds.append("CNOT")
            supports.append((controls[0], targets[0]))
            mats.append(np.eye(2))  # placeholder, unused by the CNOT path
            real_flags.append(True)
        elif (op.matrix is None and len(controls) == 1
              and base in _D2_BASES):
            d = _diag_vector(op, params)
            kinds.append("D2")
            supports.append((controls[0], targets[0]))
            mats.append(np.stack([np.ones(2), d]))
            real_flags.append(base == "Z")  # CZ is the only real member
        elif (op.matrix is None and not controls and len(targets) == 1
              and base in _D2_BASES):
            # plain 1q diagonal as D2(q, q): resolved per block at any qubit
            d = _diag_vector(op, params)
            kinds.append("D2")
            supports.append((targets[0], targets[0]))
            mats.append(np.array([[d[0], d[0]], [d[1], d[1]]]))
            real_flags.append(base == "Z")
        elif op.matrix is None and base == "RZZ" and not controls:
            (theta,) = _resolve_params(op, params)
            if op.is_adjoint:
                theta = -theta
            em, ep = np.exp(-0.5j * theta), np.exp(0.5j * theta)
            kinds.append("D2")
            supports.append((targets[0], targets[1]))
            mats.append(np.array([[em, ep], [ep, em]]))
            real_flags.append(False)
        else:
            if len(controls) == 1 and len(targets) == 1:
                kinds.append("CU")
                supports.append((controls[0], targets[0]))
            else:
                kinds.append("U")
                supports.append((targets[0],))
            m = _base_matrix(op, params)
            mats.append(m)
            real_flags.append(_real_flag(op, m, exact_real))
    return kinds, supports, mats, real_flags


def pallas_block_specs(block: PallasBlock, params):
    """(kinds, supports, gate_mats, real_flags) for a PallasBlock's ops
    (see :func:`_block_matrices`); ``gate_mats`` is a host float32
    (K, 2, 2, 2) array [k, row, col, re/im]."""
    kinds, supports, mats, real_flags = _block_matrices(block, params)
    return kinds, supports, np.stack([_pack(m) for m in mats]), real_flags


def pallas_block_specs_df64(block: PallasBlock, params):
    """:func:`pallas_block_specs` for the df64 kernel: the same kinds and
    supports, every matrix built in complex128 and split hi/lo into a
    (K, 2, 2, 4) float32 array [k, row, col, (re_hi, re_lo, im_hi,
    im_lo)]."""
    kinds, supports, mats, real_flags = _block_matrices(block, params,
                                                        exact_real=True)
    return kinds, supports, fused_df64.pack_gate_mats_df64(mats), real_flags


def _spec_anchors(kinds, supports, limit):
    """Per-gate ANCHOR qubits — what must fit the kernel window or the
    pass's pair set. Diagonals (D2) anchor nothing; a CNOT/CU control at or
    above ``limit`` is a per-block scalar, so only its target anchors."""
    anchors = []
    for k, s in zip(kinds, supports):
        if k == "D2":
            anchors.append(())
        elif k in ("CNOT", "CU") and s[0] >= limit:
            anchors.append((s[1],))
        else:
            anchors.append(tuple(s))
    return anchors


def _classify_spec(op: GateOp):
    """Structure-only (kind, support) for one kernel-eligible op — the
    twin of :func:`pallas_block_specs`'s branch order without building any
    matrix (parameter values never change a plan)."""
    base, controls, targets = _split_op(op)
    if base == "D2M":
        return "D2", (targets[0], targets[1])
    if base == "X" and len(controls) == 1 and op.matrix is None:
        return "CNOT", (controls[0], targets[0])
    if op.matrix is None and len(controls) == 1 and base in _D2_BASES:
        return "D2", (controls[0], targets[0])
    if (op.matrix is None and not controls and len(targets) == 1
            and base in _D2_BASES):
        return "D2", (targets[0], targets[0])
    if op.matrix is None and base == "RZZ" and not controls:
        return "D2", (targets[0], targets[1])
    if len(controls) == 1 and len(targets) == 1:
        return "CU", (controls[0], targets[0])
    return "U", (targets[0],)


@functools.lru_cache(maxsize=1024)
def _block_plan(n: int, kinds: tuple, supports: tuple, reach: int,
                max_pairs: int, window: int):
    """Kernel passes for one block's specs (structure only, cached): the
    low ``reach`` bits need no pairing and up to ``max_pairs`` bits above
    them ride as pair bits; each pass names its pair bits from ``window``
    up (the kernel's window: bits below it are local anyway)."""
    anchors = _spec_anchors(kinds, supports, reach)
    if all(q < reach for a in anchors for q in a):
        # unanchored bits resolve per block in the kernel: one pass
        return (relabel.KernelPass(tuple(range(len(kinds))), supports),)
    return tuple(
        relabel.KernelPass(p.gate_idx, p.positions,
                           tuple(q for q in p.pair_bits if q >= window))
        for p in relabel.plan_full_layer(n, supports, reach,
                                         pair_ok=n > reach,
                                         max_pairs=max_pairs,
                                         anchors=anchors))


def kernel_plan(n: int, kinds, supports, kernel=fused_sv,
                complex_carry: bool = False):
    """The passes of one block's specs on the fused kernel of module
    ``kernel`` (ops/fused_sv.py or ops/fused_df64.py, each with its own
    geometry) for a real or complex carry."""
    reach, pairs = kernel.plan_geometry(n, complex_carry)
    return _block_plan(n, tuple(kinds), tuple(tuple(s) for s in supports),
                       reach, pairs, kernel.window_bits(n))


def block_pass_count(block: PallasBlock, n: int, kernel=fused_sv) -> int:
    """Planned kernel passes of one block on an n-qubit state (real
    carry)."""
    kinds, supports = zip(*(_classify_spec(op) for op in block.ops))
    return len(kernel_plan(n, kinds, supports, kernel))


def _run_pallas_specs(re, im, kinds, supports, gm, real_flags,
                      num_qubits: int, device=None):
    """Run prepared gate specs through the fused kernel in planned passes.
    ``im=None`` is the real plane (all-real gates only); ``re=None`` starts
    the first pass from |0...0> on ``device``."""
    plan = kernel_plan(num_qubits, kinds, supports,
                       complex_carry=im is not None)
    return relabel.execute_plan(re, im, plan, gm, num_qubits, kinds=kinds,
                                real_flags=real_flags, device=device)


def _apply_pallas_block_pair(re, im, block: PallasBlock, params,
                             num_qubits: int, device=None):
    """Run one PallasBlock on a (re, im) float32 state. A complex gate
    entering a real carry materializes the imaginary plane first."""
    kinds, supports, gm, real_flags = pallas_block_specs(block, params)
    if not all(real_flags):
        if re is None:
            re = init_real(num_qubits, device)
        if im is None:
            im = torch.zeros_like(re)
    return _run_pallas_specs(re, im, kinds, supports, gm, real_flags,
                             num_qubits, device=device)


def _run_pallas_specs_df64(planes, kinds, supports, gm, real_flags,
                           num_qubits: int):
    """Run prepared df64 gate specs through the df64 kernel in planned
    passes on the df64 kernel's own geometry."""
    plan = kernel_plan(num_qubits, kinds, supports, fused_df64)
    for item in plan:
        idx = list(item.gate_idx)
        specs = tuple((kinds[i],) + tuple(p)
                      for i, p in zip(idx, item.positions))
        planes = fused_df64.apply_fused_layer_df64(
            *planes, specs, gm[idx], pair_bits=item.pair_bits,
            real_flags=tuple(real_flags[i] for i in idx))
    return planes


def _complex_planes(planes):
    """df64 planes with the imaginary pair materialized (zeros for a real
    carry)."""
    rh, rl, ih, il = planes
    if ih is None:
        ih, il = torch.zeros_like(rh), torch.zeros_like(rl)
    return rh, rl, ih, il


def _apply_pallas_block_df64(planes, block: PallasBlock, params,
                             num_qubits: int):
    """Run one PallasBlock on df64 planes. A complex gate entering a real
    carry materializes the imaginary planes first."""
    kinds, supports, gm, real_flags = pallas_block_specs_df64(block, params)
    if not all(real_flags):
        planes = _complex_planes(planes)
    return _run_pallas_specs_df64(planes, kinds, supports, gm, real_flags,
                                  num_qubits)


def run_items_df64(planes, items: Sequence, params, n: int):
    """Execute planned items on df64 planes: PallasBlocks through the df64
    kernel, every other item op by op (ops/df64.apply_op_df64), as the JAX
    package's execute_df64 does."""
    params = _host_params(params)
    for item in items:
        if isinstance(item, PallasBlock):
            planes = _apply_pallas_block_df64(planes, item, params, n)
            continue
        planes = _complex_planes(planes)
        members = item.ops if isinstance(item, (DiagBlock, FusedBlock)) \
            else [item]
        for op in members:
            planes = dfm.apply_op_df64(planes, op, params)
    return planes


def execute_df64(planes, ops: Sequence, params=None, fuse: bool = True,
                 max_fuse: int = 2):
    """Apply ``ops`` to the df64 state ``(re_hi, re_lo, im_hi, im_lo)``;
    ``im_hi = im_lo = None`` declares it real (2-plane kernel passes while
    every gate is real). Returns planes with the same convention."""
    n = sv.num_qubits_of(planes[0])
    return run_items_df64(planes, plan_items(ops, n, fuse, max_fuse), params,
                          n)


def run_ops_f64(re, im, ops: Sequence, params=None):
    """The exact double-precision engine: every op in order on the
    complex128 state, in plain torch (the JAX package runs it as plain XLA,
    ``pairsim.compile_pair_ir``); ``(b, 2^n)`` planes run every op on each
    element. Returns the full float64 pair."""
    state = torch.complex(re, im if im is not None else torch.zeros_like(re))
    return sv.state_to_parts(run_ops_exact(state, ops, params))


def apply_op(state: torch.Tensor, op: GateOp, params=None) -> torch.Tensor:
    """Apply one GateOp to a complex state."""
    if op.name == SWAP_BITS:
        return sv.swap_index_bits(state, op.targets[0], op.targets[1])
    if op.name == PERMUTE_BITS:
        return sv.permute_index_bits(state, *permutation_of(op))
    _, controls, targets = _split_op(op)
    return sv.apply_controlled_matrix(state, _base_matrix(op, params),
                                      controls, targets)


def _np_apply_rows(acc: np.ndarray, mat: np.ndarray, local, k: int):
    """numpy: left-apply ``mat`` on the row-index bits ``local`` of acc."""
    m = len(local)
    tin = acc.reshape((2,) * k + (acc.shape[1],))
    mt = mat.reshape((2,) * (2 * m))
    row_axis = {k - 1 - q: i for i, q in enumerate(local)}
    labels = list(range(k + 1))
    row_label = [k + 1 + i for i in range(m)]
    mat_labels = ([row_label[m - 1 - j] for j in range(m)]
                  + [k - 1 - local[m - 1 - j] for j in range(m)])
    out_labels = [row_label[row_axis[a]] if a in row_axis else a
                  for a in range(k)] + [k]
    out = np.einsum(mt, mat_labels, tin, labels, out_labels)
    return out.reshape(acc.shape)


def _fused_matrix(block: FusedBlock, params) -> np.ndarray:
    """Multiply the block's member unitaries into one dense matrix over
    block.qubits, on the host (analog of GateFusion's host-side products,
    GateFusion.cpp:89-156, generalized and qubit-order-correct)."""
    pos = {q: i for i, q in enumerate(block.qubits)}
    k = len(block.qubits)
    acc = np.eye(1 << k, dtype=np.complex128)
    for op in block.ops:
        _, controls, targets = _split_op(op)
        mat = _base_matrix(op, params)
        if controls:
            m = mat.shape[0]
            full = np.eye(m << len(controls), dtype=np.complex128)
            full[-m:, -m:] = mat
            mat = full
            targets = targets + controls
        acc = _np_apply_rows(acc, mat, [pos[q] for q in targets], k)
    return acc


def init_real(n: int, device=None) -> torch.Tensor:
    """|0...0> as one real float32 plane (on CUDA, the fill kernel)."""
    return fused_sv.init_zero(n, device)


def init_pair(n: int, device=None):
    """|0...0> as a (re, im) float32 pair."""
    re = init_real(n, device)
    return re, torch.zeros_like(re)


def init_real64(n: int, device) -> torch.Tensor:
    """|0...0> as one real float64 plane."""
    re = torch.zeros(1 << n, dtype=torch.float64, device=device)
    re[0] = 1.0
    return re


def plan_items(ops: Sequence, n: int, fuse: bool = True,
               max_fuse: int = 2, every_run: bool = False,
               kernel: bool = True, low_width: int = 0,
               high_width: int = 0) -> list:
    """The structure-only plan of a gate list: PallasBlocks for the fused
    kernel (``kernel`` and n >= KERNEL_MIN_QUBITS), then DiagBlocks and
    FusedBlocks, then (widths > 0) the runs on the lowest ``low_width`` and
    the highest ``high_width`` qubits merged into dense blocks
    (passes.consolidate_low/high).

    A run of kernel-eligible gates becomes a block as the JAX package's
    flush decides it (at least 6 gates, out-of-window gates split off when
    that plans fewer passes), or, with ``every_run``, whatever its length
    and qubits: the gradient's backward sweep (autodiff.py) runs each
    one-gate and each short parameter-free step on the kernel."""
    items = list(ops)
    if kernel and n >= KERNEL_MIN_QUBITS:
        if every_run:
            items = fuse_pallas_runs(items, n - 1, min_gates=1,
                                     num_qubits=n)
        else:
            items = fuse_pallas_runs(items, n - 1, num_qubits=n,
                                     relabel_reach=fused_sv.window_bits(n))
    if fuse:
        items = fuse_diagonals(items)
        items = plan_fusion(items, max_fuse=max_fuse)
    if low_width:
        items = consolidate_low(items, low_width)
    if high_width:
        items = consolidate_high(items, high_width, n)
    return items


def _apply_item(state: torch.Tensor, item, params) -> torch.Tensor:
    """Apply one planned item other than a PallasBlock to a complex
    state."""
    if isinstance(item, DiagBlock):
        return _apply_diag_block(state, item, params)
    if isinstance(item, FusedBlock):
        return sv.apply_matrix(state, _fused_matrix(item, params),
                               list(item.qubits))
    return apply_op(state, item, params)


def run_items(re, im, items: Sequence, params, n: int, device=None):
    """Execute planned items on a float-pair state; see execute_pair."""
    params = _host_params(params)
    if re is None and not (items and isinstance(items[0], PallasBlock)):
        re = init_real(n, device)
    for item in items:
        if isinstance(item, PallasBlock):
            re, im = _apply_pallas_block_pair(re, im, item, params, n,
                                              device=device)
            continue
        if im is None:
            im = torch.zeros_like(re)
        state = _apply_item(torch.complex(re, im), item, params)
        re = state.real.contiguous()
        im = state.imag.contiguous()
    return re, im


def execute_pair(re, im, ops: Sequence, params=None, fuse: bool = True,
                 max_fuse: int = 2, num_qubits: Optional[int] = None,
                 device=None):
    """Apply ``ops`` to the float-pair state ``(re, im)``.

    ``im=None`` declares the state real: all-real PallasBlocks run the
    kernel's real-plane mode, and the first complex gate materializes a
    zero imaginary plane. Returns ``(re, None)`` only if the state stayed
    real. ``re=None`` (with ``im=None``, ``num_qubits`` and ``device``)
    starts from |0...0>: the first kernel pass generates it when the plan
    starts with a PallasBlock. On CUDA the kernel passes update the planes
    in place."""
    if re is None and num_qubits is None:
        raise ValueError("execute_pair(re=None, ...) requires num_qubits")
    n = num_qubits if re is None else sv.num_qubits_of(re)
    if re is not None:
        device = re.device
    return run_items(re, im, plan_items(ops, n, fuse, max_fuse), params, n,
                     device=device)


def run_flat(state: torch.Tensor, items: Sequence, params) -> torch.Tensor:
    """Execute planned items on a flat complex64 state. The state is split
    into float32 planes (``sv.state_to_parts``) at the first PallasBlock
    and joined (``sv.parts_to_state``) at the next other item or at the
    end, so a run of blocks pays one split and one join however many
    kernel passes it plans; every other item runs on the complex state."""
    params = _host_params(params)
    n = sv.num_qubits_of(state)
    planes = None
    for item in items:
        if isinstance(item, PallasBlock):
            if planes is None:
                planes, state = sv.state_to_parts(state), None
            planes = _apply_pallas_block_pair(*planes, item, params, n)
            continue
        if planes is not None:
            state, planes = sv.parts_to_state(*planes), None
        state = _apply_item(state, item, params)
    return state if planes is None else sv.parts_to_state(*planes)


def run_ops_exact(state: torch.Tensor, ops: Sequence,
                  params=None) -> torch.Tensor:
    """Every op in order on the complex state, in plain torch: the path of
    a complex128 state, which never reaches the float32 kernel."""
    params = _host_params(params)
    for op in ops:
        state = apply_op(state, op, params)
    return state


def execute(state, ops: Sequence, params=None, fuse: bool = True,
            max_fuse: int = 2, low_width: int = 0, high_width: int = 0,
            sharding=None):
    """Apply ``ops`` to a flat complex state and return the new state.

    A complex64 state is planned by :func:`plan_items` (with ``fuse``, runs
    of kernel-eligible gates become PallasBlocks from n =
    KERNEL_MIN_QUBITS on) and run by :func:`run_flat`: on CUDA the blocks
    launch the fused kernel, on the CPU its plain version. ``low_width`` /
    ``high_width`` > 0 also merge runs on the lowest / highest qubits into
    one dense block each (a matmul). A complex128 state runs every op
    exactly (:func:`run_ops_exact`). A :class:`~..parallel.sharded.
    ShardedState` runs sharded (:func:`run_sharded_flat`; no high block).
    ``sharding``, the JAX package's argument, is optional here, since the
    state carries its own; given, it must be that one."""
    sharded.check_sharding(sharding, state)
    if isinstance(state, sharded.ShardedState):
        return run_sharded_flat(state, ops, params, fuse, max_fuse,
                                low_width)
    if state.dtype != torch.complex64:
        return run_ops_exact(state, ops, params)
    items = plan_items(ops, sv.num_qubits_of(state), fuse, max_fuse,
                       kernel=fuse, low_width=low_width,
                       high_width=high_width)
    return run_flat(state, items, params)


# widest dense block of the low and high consolidation (a 2^9-wide matmul)
_MAX_LOW_WIDTH = 9
_MAX_HIGH_WIDTH = 9


def default_widths(n: int, sharded: bool = False):
    """(low_width, high_width) of :func:`compile_ir` for an n-qubit
    circuit: 9 each, as far as n allows. A sharded circuit merges no high
    block: the top index bits select the shard."""
    low = min(_MAX_LOW_WIDTH, n)
    if sharded:
        return low, 0
    return low, min(_MAX_HIGH_WIDTH, n - low)


def parametrize(ops: Sequence[GateOp]):
    """Rewrite concrete float params into ParamRef slots, returning
    (rewritten_ops, param_values), so circuits that differ only in angles
    share one plan."""
    new_ops, values = [], []
    for op in ops:
        new_params = []
        for p in op.params:
            if isinstance(p, ParamRef):
                new_params.append(p)
            else:
                new_params.append(ParamRef(len(values)))
                values.append(float(p))
        new_ops.append(dataclasses.replace(op, params=tuple(new_params)))
    return new_ops, values


_PLAN_CACHE = BoundedCache()


def _plan_key(ir: CircuitIR, *extra):
    """Structural cache key of an IR plus the concrete parameter values the
    plan bakes in."""
    baked = tuple(float(p) for op in ir.ops for p in op.params
                  if not isinstance(p, ParamRef))
    return (ir.structural_key(), baked) + extra


def compile_pair32_ir(ir: CircuitIR, fuse: bool = True, max_fuse: int = 2,
                      every_run: bool = False):
    """Return ``run((re, im_or_None), params, device=None) -> (re,
    im_or_None)`` for this IR: the plan is made once and cached by
    structural key (plus any concrete parameter values, which the plan
    bakes in). ``device`` places a state started from ``re=None``;
    ``every_run`` is :func:`plan_items`'."""
    key = _plan_key(ir, fuse, max_fuse, every_run)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached
    n = ir.num_qubits
    items = plan_items(list(ir.ops), n, fuse, max_fuse, every_run)

    def run(pair, params, device=None):
        re, im = pair
        return run_items(re, im, items, params, n,
                         device=device if re is None else re.device)

    _PLAN_CACHE[key] = run
    return run


def compile_ir(ir: CircuitIR, fuse: bool = True, max_fuse: int = 2,
               low_width: Optional[int] = None,
               high_width: Optional[int] = None, batched: bool = False,
               sharding=None, batch_sharding=None):
    """Return ``f(state, params) -> state`` for this IR over flat complex
    states (:func:`execute`; widths default to :func:`default_widths`),
    cached by structural key plus the concrete parameter values the plan
    bakes in, so two IRs that differ only in angles never share a plan. The
    complex64 plan is made at the first call; a complex128 state runs every
    op exactly. ``batched`` takes ``(b, 2^n)`` states and runs the circuit
    on every element (the reference's ``batchSize``, hipStateVec.h:61),
    kernel passes included: one launch per pass for the whole batch. The
    input state is not modified.

    With ``sharding`` (a ``parallel.state_sharding``) ``f`` takes and
    returns a :class:`~..parallel.sharded.ShardedState` of that sharding:
    kernel blocks are planned on its local bits and run once per device
    over the rows of its shards (:func:`run_sharded_flat`). The port's
    descriptor carries the batch, so ``batch_sharding``, the JAX package's
    name for the batched layout, is the same argument: pass either, or both
    equal."""
    if batch_sharding is not None:
        if sharding is not None and sharding != batch_sharding:
            raise ValueError(f"sharding {sharding!r} and batch_sharding "
                             f"{batch_sharding!r} differ")
        sharding = batch_sharding
    sharded.check_sharding(sharding)
    layout = sharding
    dlw, dhw = default_widths(ir.num_qubits, sharded=layout is not None)
    low_width = dlw if low_width is None else low_width
    high_width = dhw if high_width is None else high_width
    key = _plan_key(ir, "flat", fuse, max_fuse, low_width, high_width,
                    batched, layout)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached
    n = ir.num_qubits
    ops = list(ir.ops)
    plan = []

    def run(state, params=None):
        if layout is not None:
            sharded.check_sharding(layout, state)
            if state.batched != batched or state.num_qubits != n:
                raise ValueError(f"a sharded {n}-qubit circuit takes a "
                                 f"{'batched ' if batched else ''}"
                                 f"{n}-qubit ShardedState")
            return run_sharded_flat(state, ops, params, fuse, max_fuse,
                                    low_width, plan)
        if sv.num_qubits_of(state) != n:
            raise ValueError(f"state has {sv.num_qubits_of(state)} qubits, "
                             f"the circuit {n}")
        if state.dim() != 1 + batched:
            raise ValueError(f"a {'batched' if batched else 'flat'} circuit "
                             f"takes {'(b, 2^n)' if batched else '(2^n,)'} "
                             f"states, got {tuple(state.shape)}")
        if state.dtype != torch.complex64:
            return run_ops_exact(state, ops, params)
        if not plan:
            plan.append(plan_items(ops, n, fuse, max_fuse, kernel=fuse,
                                   low_width=low_width,
                                   high_width=high_width))
        return run_flat(state, plan[0], params)

    _PLAN_CACHE[key] = run
    return run


def compile_df64_fused_ir(ir: CircuitIR, fuse: bool = True,
                          max_fuse: int = 2, sharding=None):
    """Return ``run((re, im_or_None), params) -> (re, im_or_None)`` over
    float64 planes through the double-float engine: the pair is split into
    hi/lo float32 planes at entry (exact to ~2^-49 relative), runs the
    cached plan with PallasBlocks on the df64 kernel, and is promoted back
    to float64 at exit. ``im=None`` carries a real state at half the
    traffic; the output is ``(re, None)`` only if it stayed real.

    With ``sharding``, ``run(state, params)`` takes and returns a
    :class:`~..parallel.sharded.ShardedState` of float64 pairs (gates
    already localized by the scheduler): the plan is made on the local
    bits and every shard runs it, one df64 kernel launch per shard a
    pass."""
    sharded.check_sharding(sharding)
    key = _plan_key(ir, fuse, max_fuse, "df64", sharding)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached
    n = ir.num_qubits
    if sharding is not None:
        n_loc = n - sharding.n_global
        items = plan_items(list(ir.ops), n_loc, fuse, max_fuse)

        def run_sharded_df64(state, params):
            sharded.check_sharding(sharding, state)
            state = state.map(lambda p: dfm.state_from_pair_f64(*p))
            state = run_sharded(state, items, params, _df64_rows(n_loc))
            return state.map(lambda p: dfm.state_to_pair_f64(p))

        _PLAN_CACHE[key] = run_sharded_df64
        return run_sharded_df64
    items = plan_items(list(ir.ops), n, fuse, max_fuse)

    def run(pair, params):
        planes = dfm.state_from_pair_f64(*pair)
        return dfm.state_to_pair_f64(run_items_df64(planes, items, params,
                                                    n))

    _PLAN_CACHE[key] = run
    return run


# ---------------------------------------------------------------------------
# Sharded execution (parallel/sharded.py states)
# ---------------------------------------------------------------------------

def _members(item) -> list:
    return list(item.ops) if isinstance(
        item, (DiagBlock, FusedBlock, PallasBlock)) else [item]


def _item_qubits(item) -> set:
    if isinstance(item, (DiagBlock, FusedBlock, PallasBlock)):
        return set(item.qubits)
    return set(item.targets) | set(item.controls)


def _complex_rows(planes, items, params):
    """A run of local items on a complex part, every row at once: a
    complex64 part through :func:`run_flat` (one batched kernel launch a
    pass over the rows), a complex128 part op by op, exactly."""
    (t,) = planes
    if t.dtype == torch.complex64:
        return (run_flat(t, items, params),)
    return (run_ops_exact(t, [op for it in items for op in _members(it)],
                          params),)


def _df64_rows(n_loc: int, per_op: bool = False):
    """A run of local items on a part of df64 planes ``(rh, rl, ih, il)``,
    row by row (the df64 kernel has no batch dimension: one launch per
    shard a pass). ``per_op`` runs raw ops as :func:`dfm.compile_df64_ir`
    does, keeping a real carry through real gates."""
    def run(planes, items, params):
        def one(row):
            if not per_op:
                return run_items_df64(row, items, params, n_loc)
            for op in items:
                if row[2] is None and op.name not in (SWAP_BITS,
                                                      PERMUTE_BITS) \
                        and np.any(_base_matrix(op, params).imag):
                    row = _complex_planes(row)
                row = dfm.apply_op_df64(row, op, params)
            return row

        outs = [one(tuple(None if p is None else p[r] for p in planes))
                for r in range(planes[0].shape[0])]
        return tuple(None if outs[0][k] is None
                     else torch.stack([o[k] for o in outs])
                     for k in range(len(outs[0])))
    return run


def _shard_diagonal(op: GateOp, params, shard: int, n_loc: int) -> GateOp:
    """A diagonal op on one shard: its factor with the shard's global bits
    fixed, as a diagonal UNITARY on its local qubits (on qubit 0 when it
    has none: a phase)."""
    desc, f = _diag_factor(op, params)
    f = f[tuple((shard >> (q - n_loc)) & 1 if q >= n_loc else slice(None)
                for q in desc)]
    local = [q for q in desc if q < n_loc]
    if not local:
        local, f = [0], np.full(2, f)
    # f's axes descend, so its flat index has local[-1] as bit 0
    return GateOp("UNITARY", tuple(reversed(local)), (), (),
                  np.diag(np.asarray(f).reshape(-1)))


def _apply_rows(planes, r0: int, r1: int, op: GateOp, params, run):
    """``op`` on rows [r0, r1) of a part, in place; a real carry that the
    op makes complex gets zero imaginary planes for the whole part
    first."""
    new = run(tuple(None if p is None else p[r0:r1] for p in planes), [op],
              params)
    planes = tuple(torch.zeros_like(planes[0]) if p is None and x is not None
                   else p for p, x in zip(planes, new))
    for p, x in zip(planes, new):
        if x is not None:
            p[r0:r1].copy_(x)
    return planes


def _global_op(state, op: GateOp, params, run, n_loc: int):
    """One op that touches global bits: a relabel (sharded.permute_bits),
    a diagonal (each shard its own diagonal, no communication), or a gate
    no scheduler localized (its global qubits relabelled onto free local
    bits and back: two all-to-all rounds)."""
    if op.name == SWAP_BITS:
        a, b = op.targets
        return sharded.permute_bits(state, (a, b), (b, a))
    if op.name == PERMUTE_BITS:
        return sharded.permute_bits(state, *permutation_of(op))
    qubits = set(op.targets) | set(op.controls)
    if is_diagonal(op):
        nb = state.rows_per_cell
        parts = list(state.parts)
        for (b, s), (i, k) in state.sharding.loc.items():
            with sharded.on_device(state.sharding.parts[i][0]):
                parts[i] = _apply_rows(parts[i], k * nb, (k + 1) * nb,
                                       _shard_diagonal(op, params, s, n_loc),
                                       params, run)
        return state.replace(parts)
    glob = sorted(q for q in qubits if q >= n_loc)
    free = [p for p in range(n_loc - 1, -1, -1) if p not in qubits]
    if len(free) < len(glob):
        raise ValueError(f"gate support {sorted(qubits)} exceeds the local "
                         f"region ({n_loc} qubits)")
    swap = dict(zip(glob, free))
    swap.update({f: g for g, f in swap.items()})
    dsts = tuple(swap)
    srcs = tuple(swap[d] for d in dsts)
    state = sharded.permute_bits(state, dsts, srcs)
    local = GateOp(op.name, tuple(swap.get(q, q) for q in op.targets),
                   tuple(swap.get(q, q) for q in op.controls), op.params,
                   op.matrix, op.is_adjoint)
    state = state.map(lambda p: run(p, [local], params))
    return sharded.permute_bits(state, dsts, srcs)


def run_sharded(state, items: Sequence, params, run):
    """Execute planned items (or raw ops) on a ShardedState. Runs of items
    on local bits go to ``run(planes, items, params)`` once per part (every
    shard of a device in one call); an item touching global bits is taken
    op by op (:func:`_global_op`)."""
    params = _host_params(params)
    n_loc = state.n_local
    pending: list = []

    def drain(state):
        if pending:
            batch = list(pending)
            pending.clear()
            state = state.map(lambda p: run(p, batch, params))
        return state

    for item in items:
        if all(q < n_loc for q in _item_qubits(item)):
            pending.append(item)
            continue
        state = drain(state)
        for op in _members(item):
            if all(q < n_loc for q in _item_qubits(op)):
                state = state.map(lambda p: run(p, [op], params))
            else:
                state = _global_op(state, op, params, run, n_loc)
    return drain(state)


def run_sharded_flat(state, ops: Sequence, params=None, fuse: bool = True,
                     max_fuse: int = 2, low_width: int = 0, plan=None):
    """:func:`execute` on a complex ShardedState: a complex64 state is
    planned on its local bits (kernel blocks from n_loc =
    KERNEL_MIN_QUBITS on, the low block capped at n_loc) and run by
    :func:`run_sharded`; a complex128 one runs op by op. ``plan`` (a list)
    caches the plan across calls."""
    if state.parts[0][0].dtype != torch.complex64:
        return run_sharded(state, ops, params, _complex_rows)
    n_loc = state.n_local
    if plan is None or not plan:
        items = plan_items(ops, n_loc, fuse, max_fuse, kernel=fuse,
                           low_width=min(low_width, n_loc))
        if plan is not None:
            plan.append(items)
    else:
        items = plan[0]
    return run_sharded(state, items, params, _complex_rows)


def run_ops_f64_sharded(state, ops: Sequence, params=None):
    """:func:`run_ops_f64` on a ShardedState of float64 pairs: every op
    exactly on complex128, returned as full pairs."""
    state = state.map(lambda p: (torch.complex(
        p[0], p[1] if p[1] is not None else torch.zeros_like(p[0])),))
    state = run_sharded(state, ops, params, _complex_rows)
    return state.map(lambda p: sv.state_to_parts(p[0]))


def clear_cache():
    _PLAN_CACHE.clear()
    _block_plan.cache_clear()
