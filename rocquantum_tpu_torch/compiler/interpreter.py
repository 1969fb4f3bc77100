"""Circuit IR -> fused-kernel passes on a float-pair state.

The pair path of ``rocquantum_tpu/compiler/interpreter.py``. A gate list is
planned once per circuit structure (the passes of compiler/passes.py, then
the kernel-pass planner of ops/relabel.py) and the plan is cached by the
IR's structural key; a run builds the gate coefficients on the host from the
parameter values and replays the plan eagerly. There is no jit: PyTorch
runs each kernel pass as it is issued.

The state is a pair of flat ``(2^n,)`` float32 planes ``(re, im)``, and
``(re, None)`` while the circuit stays real: runs of kernel-eligible gates
(PallasBlocks) go through the fused kernel (ops/fused_sv.py) with no complex
tensor in between; every other item converts to complex64 locally and runs
in plain torch (ops/statevec.py), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import fused_sv
from ..ops import gates as _g
from ..ops import relabel
from ..ops import statevec as sv
from .ir import CircuitIR, GateOp, ParamRef
from .passes import (DiagBlock, FusedBlock, PallasBlock, fuse_diagonals,
                     fuse_pallas_runs, plan_fusion)

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
    """Multiply ``state`` by a factor tensor over the exposed qubits
    ``desc`` (descending)."""
    n = sv.num_qubits_of(state)
    dims = sv.exposed_view_dims(n, desc)
    bshape = [1] * len(dims)
    for j in range(len(desc)):
        bshape[2 * j + 1] = 2
    f = torch.as_tensor(values, dtype=state.dtype, device=state.device)
    return (state.view(dims) * f.reshape(bshape)).reshape(-1)


def _apply_diag_block(state: torch.Tensor, block: DiagBlock,
                      params) -> torch.Tensor:
    """Multiply every member's phase factor into the complex state."""
    for op in block.ops:
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
            d2 = m if targets[0] > targets[1] else m.T
            state = _phase_factor(state, d2, sorted(targets, reverse=True))
            continue
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
        state = _phase_factor(state, f, desc)
    return state


# 1q gates whose matrices are purely real: the kernel's real-plane mode and
# its cheaper real-matrix arithmetic depend on this static fact
_REAL_1Q = {"X", "H", "RY", "Z", "I", "ID"}


def _has_real_matrix(op: GateOp) -> bool:
    if op.matrix is not None:
        return bool(np.allclose(np.imag(np.asarray(op.matrix)), 0.0))
    return op.name.upper() in _REAL_1Q


_D2_BASES = set(_DIAG_VECS) | {"RZ", "P", "PHASE"}


def _pack(m: np.ndarray) -> np.ndarray:
    return np.stack([np.real(m), np.imag(m)], axis=-1).astype(np.float32)


_EYE_PACKED = _pack(np.eye(2))


def pallas_block_specs(block: PallasBlock, params):
    """(kinds, supports, gate_mats, real_flags) for a PallasBlock's ops:
    kind "U" (dense 1q matrix), "CNOT" (control, target), "CU" (controlled
    dense 1q) or "D2" — a two-qubit diagonal packed as the 2x2 of diagonal
    entries d[bit_a, bit_b]. ``gate_mats`` is a host float32 (K, 2, 2, 2)
    array [k, row, col, re/im]."""
    mats, kinds, supports, real_flags = [], [], [], []
    for op in block.ops:
        base, controls, targets = _split_op(op)
        if base == "D2M":
            m = np.asarray(op.matrix, np.complex128)
            if op.is_adjoint:
                m = np.conj(m)
            kinds.append("D2")
            supports.append((targets[0], targets[1]))
            mats.append(_pack(m))
            real_flags.append(_has_real_matrix(op))
        elif base == "X" and len(controls) == 1 and op.matrix is None:
            kinds.append("CNOT")
            supports.append((controls[0], targets[0]))
            mats.append(_EYE_PACKED)  # placeholder, unused by the CNOT path
            real_flags.append(True)
        elif (op.matrix is None and len(controls) == 1
              and base in _D2_BASES):
            d = _diag_vector(op, params)
            kinds.append("D2")
            supports.append((controls[0], targets[0]))
            mats.append(_pack(np.stack([np.ones(2), d])))
            real_flags.append(base == "Z")  # CZ is the only real member
        elif (op.matrix is None and not controls and len(targets) == 1
              and base in _D2_BASES):
            # plain 1q diagonal as D2(q, q): resolved per block at any qubit
            d = _diag_vector(op, params)
            kinds.append("D2")
            supports.append((targets[0], targets[0]))
            mats.append(_pack(np.array([[d[0], d[0]], [d[1], d[1]]])))
            real_flags.append(base == "Z")
        elif op.matrix is None and base == "RZZ" and not controls:
            (theta,) = _resolve_params(op, params)
            if op.is_adjoint:
                theta = -theta
            em, ep = np.exp(-0.5j * theta), np.exp(0.5j * theta)
            kinds.append("D2")
            supports.append((targets[0], targets[1]))
            mats.append(_pack(np.array([[em, ep], [ep, em]])))
            real_flags.append(False)
        elif len(controls) == 1 and len(targets) == 1:
            kinds.append("CU")
            supports.append((controls[0], targets[0]))
            mats.append(_pack(_base_matrix(op, params)))
            real_flags.append(_has_real_matrix(op))
        else:
            kinds.append("U")
            supports.append((targets[0],))
            mats.append(_pack(_base_matrix(op, params)))
            real_flags.append(_has_real_matrix(op))
    return kinds, supports, np.stack(mats), real_flags


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
def _block_plan(n: int, kinds: tuple, supports: tuple):
    """Kernel passes for one block's specs (structure only, cached)."""
    reach = fused_sv.window_bits(n)
    anchors = _spec_anchors(kinds, supports, reach)
    if all(q < reach for a in anchors for q in a):
        # unanchored bits resolve per block in the kernel: one pass
        return (relabel.KernelPass(tuple(range(len(kinds))), supports),)
    return tuple(relabel.plan_full_layer(n, supports, reach,
                                         pair_ok=n > reach, anchors=anchors))


def block_pass_count(block: PallasBlock, n: int) -> int:
    """Planned kernel passes of one block on an n-qubit state."""
    kinds, supports = zip(*(_classify_spec(op) for op in block.ops))
    return len(_block_plan(n, tuple(kinds), tuple(supports)))


def _run_pallas_specs(re, im, kinds, supports, gm, real_flags,
                      num_qubits: int, device=None):
    """Run prepared gate specs through the fused kernel in planned passes.
    ``im=None`` is the real plane (all-real gates only); ``re=None`` starts
    the first pass from |0...0> on ``device``."""
    plan = _block_plan(num_qubits, tuple(kinds),
                       tuple(tuple(s) for s in supports))
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


def apply_op(state: torch.Tensor, op: GateOp, params=None) -> torch.Tensor:
    """Apply one GateOp to a complex state."""
    if op.name == "SWAP_BITS":
        return sv.swap_index_bits(state, op.targets[0], op.targets[1])
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
    """|0...0> as one real float32 plane. On CUDA the fused kernel writes
    it (its start-from-|0...0> mode with an empty gate list)."""
    re, _ = fused_sv.apply_fused_layer(
        None, None, (), np.zeros((0, 2, 2, 2), np.float32), num_qubits=n,
        device=device)
    return re


def init_pair(n: int, device=None):
    """|0...0> as a (re, im) float32 pair."""
    re = init_real(n, device)
    return re, torch.zeros_like(re)


def plan_items(ops: Sequence, n: int, fuse: bool = True,
               max_fuse: int = 2) -> list:
    """The structure-only plan of a gate list: PallasBlocks for the fused
    kernel (n >= KERNEL_MIN_QUBITS), then DiagBlocks and FusedBlocks."""
    items = list(ops)
    if n >= KERNEL_MIN_QUBITS:
        items = fuse_pallas_runs(items, n - 1, num_qubits=n,
                                 relabel_reach=fused_sv.window_bits(n))
    if fuse:
        items = fuse_diagonals(items)
        items = plan_fusion(items, max_fuse=max_fuse)
    return items


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
        state = torch.complex(re, im)
        if isinstance(item, DiagBlock):
            state = _apply_diag_block(state, item, params)
        elif isinstance(item, FusedBlock):
            state = sv.apply_matrix(state, _fused_matrix(item, params),
                                    list(item.qubits))
        else:
            state = apply_op(state, item, params)
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


class _PlanCache:
    """Bounded LRU map from circuit structure to its compiled run."""

    def __init__(self, maxsize: int = 256):
        self._maxsize = maxsize
        self._data: OrderedDict = OrderedDict()

    def get(self, key):
        if key not in self._data:
            return None
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key, value):
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self._maxsize:
            self._data.popitem(last=False)

    def clear(self):
        self._data.clear()


_PLAN_CACHE = _PlanCache()


def compile_pair32_ir(ir: CircuitIR, fuse: bool = True, max_fuse: int = 2):
    """Return ``run((re, im_or_None), params, device=None) -> (re,
    im_or_None)`` for this IR: the plan is made once and cached by
    structural key (plus any concrete parameter values, which the plan
    bakes in). ``device`` places a state started from ``re=None``."""
    baked = tuple(float(p) for op in ir.ops for p in op.params
                  if not isinstance(p, ParamRef))
    key = (ir.structural_key(), baked, fuse, max_fuse)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached
    n = ir.num_qubits
    items = plan_items(list(ir.ops), n, fuse, max_fuse)

    def run(pair, params, device=None):
        re, im = pair
        return run_items(re, im, items, params, n,
                         device=device if re is None else re.device)

    _PLAN_CACHE.put(key, run)
    return run


def clear_cache():
    _PLAN_CACHE.clear()
    _block_plan.cache_clear()
