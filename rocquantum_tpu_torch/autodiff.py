"""Reversible (O(1)-memory) adjoint differentiation on the float-pair state.

Counterpart of ``rocquantum_tpu/autodiff.py``. Quantum circuits are
unitary, so the backward sweep RECONSTRUCTS the intermediate states by
applying inverse gates instead of storing them: two live states (the
walked-back ket and the cotangent) whatever the depth.

On the port's real planes a unitary U acting on ``(re, im)`` is a real
orthogonal map, whose transpose is U^dagger on the same planes. So the
cotangent ``bra = (dE/dre, dE/dim)`` walks back with the same U^dagger as
the ket (no conjugation around it, as JAX's complex cotangents need):

    ket    <- U_k^dagger ket
    grad_k  = Re <bra | dU_k/dtheta | ket>     (both planes, float64 sums)
    bra    <- U_k^dagger bra

Every U^dagger step runs the same engine as the forward pass. In single
precision that is the fused kernel (``compile_pair32_ir`` on the adjoint
ops, every eligible run a kernel block) for each maximal run of
parameter-free gates; plans are cached by structure. A parameterized gate
of at most two targets on CUDA float32 planes takes one launch of the
adjoint step kernel (``ops/adjoint_step.py``): ``U^dagger`` on the ket,
the gate's ``M`` in float64 and ``U^dagger`` on the bra in one pass. Other
parameterized gates, and every gate on CPU planes, run their step as two
one-gate kernel steps (planned with the gate's parameters renumbered from
0, so the one-gate steps of an ansatz share one plan per (gate, qubit))
around plain-torch sums (:func:`_correlation`). In double precision
(``"double"`` and ``"df64"``) both directions run the exact complex128
engine (``interpreter.run_ops_f64``), as the JAX package differentiates
its exact float64 pair engine.

Each gate's step forms the (2^m, 2^m) matrix ``M_ac = sum_r conj(bra[r,
a]) ket[r, c]`` over its m targets (where every control is 1) on the
device, into one float64 buffer of the request; ``grad = d/dtheta Re
sum_ac U_ac M_ac`` is one host autograd call over the gates' matrices,
built once a request in batches of one gate name (``ops/gates.
gate_matrices_t``; their ``U^dagger`` are the kernel's), so shared
parameters and U3's three accumulate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .compiler.interpreter import (_ADJOINT_NAME, _host_params, _split_op,
                                   compile_pair32_ir, init_real, init_real64,
                                   run_ops_f64)
from .compiler.ir import CircuitIR, GateOp, ParamRef
from .ops import adjoint_step
from .ops import gates as _g
from .ops import pairsim
from .ops import statevec as sv
from .utils import profiling

_F64 = torch.float64


def _is_parameterized(op: GateOp) -> bool:
    return any(isinstance(p, ParamRef) for p in op.params)


def _adjoint_group(group):
    return [dataclasses.replace(o, is_adjoint=not o.is_adjoint)
            for o in reversed(group)]


def _param_value(p, params: torch.Tensor) -> torch.Tensor:
    if isinstance(p, ParamRef):
        return params[p.index]
    return p


def _base_matrix_t(op: GateOp, params: torch.Tensor) -> torch.Tensor:
    """The (uncontrolled) unitary of ``op`` as a complex128 CPU tensor,
    differentiable in ``params`` (``ParamRef`` slots) and in tensor-valued
    op parameters: the twin of ``interpreter._base_matrix``."""
    base, _, _ = _split_op(op)
    if base == "D2M":
        m = torch.as_tensor(op.matrix).to(torch.complex128)
        if op.is_adjoint:
            m = m.conj()
        return torch.diag(torch.stack([m[0, 0], m[1, 0], m[0, 1], m[1, 1]]))
    if op.matrix is not None:
        mat = torch.as_tensor(op.matrix).to(torch.complex128)
    else:
        if op.is_adjoint and base in _ADJOINT_NAME:
            return _g.gate_matrix_t(_ADJOINT_NAME[base])
        mat = _g.gate_matrix_t(base, [_param_value(p, params)
                                      for p in op.params])
    if op.is_adjoint:
        mat = mat.conj().T
    return mat


def _target_views(plane, n: int, controls, targets):
    """Views of ``plane`` for each basis index a of the targets (targets[0]
    the least significant bit of a), where every control is 1."""
    qubits = sorted(set(controls) | set(targets), reverse=True)
    axis = {q: 2 * i + 1 for i, q in enumerate(qubits)}
    v = plane.view(sv.exposed_view_dims(n, qubits))
    views = []
    for a in range(1 << len(targets)):
        idx = [slice(None)] * v.dim()
        for c in controls:
            idx[axis[c]] = 1
        for j, t in enumerate(targets):
            idx[axis[t]] = (a >> j) & 1
        views.append(v[tuple(idx)])
    return views


def _dot(x, y) -> torch.Tensor:
    return torch.sum(x * y, dtype=_F64)


def _correlation(bra, ket, controls, targets) -> torch.Tensor:
    """(2, 2^m, 2^m) float64 device tensor: the real and imaginary parts
    of ``M_ac = sum_r conj(bra[r, a]) ket[r, c]`` over the m ``targets``,
    on the amplitudes where every control is 1. A None plane is zero."""
    n = sv.num_qubits_of(ket[0])
    br, bi = (None if p is None else _target_views(p, n, controls, targets)
              for p in bra)
    kr, ki = (None if p is None else _target_views(p, n, controls, targets)
              for p in ket)
    size = 1 << len(targets)
    zero = torch.zeros((), dtype=_F64, device=ket[0].device)
    m_re, m_im = [], []
    for a in range(size):
        for c in range(size):
            # conj(b) k = (br kr + bi ki) + i (br ki - bi kr)
            re = _dot(br[a], kr[c])
            im = zero
            if bi is not None and ki is not None:
                re = re + _dot(bi[a], ki[c])
            if ki is not None:
                im = im + _dot(br[a], ki[c])
            if bi is not None:
                im = im - _dot(bi[a], kr[c])
            m_re.append(re)
            m_im.append(im)
    return torch.stack([torch.stack(m_re), torch.stack(m_im)]).view(
        2, size, size)


class _ParamStep(NamedTuple):
    """A parameterized gate's backward step: the gate, its parameter
    slots, controls and targets, and its adjoint step kernel plan (None
    where the kernel does not take it)."""

    op: GateOp
    slots: np.ndarray
    controls: list
    targets: list
    plan: Optional[adjoint_step.StepPlan]


class _GateTable:
    """The parameterized gates of a sweep, last first, grouped by base
    name for one batched build of their matrices a request."""

    def __init__(self, gates: Sequence[_ParamStep]):
        self.ops = [g.op for g in gates]
        self.size = max([4] + [1 << len(g.targets) for g in gates])
        self.swaps = np.array([g.plan is not None and g.plan.swap
                               for g in gates], bool)
        groups, self.rest = {}, []
        for row, op in enumerate(self.ops):
            base, _, _ = _split_op(op)
            if op.matrix is not None or not _g.is_parameterized(base):
                self.rest.append(row)
                continue
            groups.setdefault((base, op.is_adjoint), []).append(row)
        self.groups = []
        for (base, adjoint), rows in groups.items():
            params = [self.ops[r].params for r in rows]
            ref = np.array([[isinstance(p, ParamRef) for p in ps]
                            for ps in params])
            slots = np.array([[p.index if isinstance(p, ParamRef) else 0
                               for p in ps] for ps in params])
            fixed = np.array([[0.0 if isinstance(p, ParamRef) else float(p)
                               for p in ps] for ps in params])
            self.groups.append((base, adjoint, torch.tensor(rows),
                                torch.tensor(ref), torch.tensor(slots),
                                torch.tensor(fixed, dtype=_F64)))

    def __len__(self) -> int:
        return len(self.ops)

    def matrices(self, theta: torch.Tensor) -> torch.Tensor:
        """``(P, size, size)`` complex128: each gate's (uncontrolled)
        unitary at ``theta`` (float64), differentiable in it; a gate of
        fewer targets in the top-left corner, the rest 0."""
        out = torch.zeros((len(self.ops), self.size, self.size),
                          dtype=torch.complex128)
        for base, adjoint, rows, ref, slots, fixed in self.groups:
            u = _g.gate_matrices_t(base, torch.where(ref, theta[slots],
                                                     fixed))
            if adjoint:
                u = u.conj().transpose(-1, -2)
            d = u.shape[-1]
            out[rows, :d, :d] = u
        for row in self.rest:
            u = _base_matrix_t(self.ops[row], theta)
            d = u.shape[-1]
            out[row, :d, :d] = u
        return out


class _Sweep:
    """The forward run and the backward steps of one gate list on one
    engine, planned at the first backward and kept."""

    def __init__(self, ops: Sequence[GateOp], num_qubits: int, device,
                 exact: bool):
        self.ops = list(ops)
        self.n = num_qubits
        self.device = torch.device(device)
        self.exact = exact
        self._steps = None
        self.table = None
        if not exact:
            self._forward = compile_pair32_ir(CircuitIR(num_qubits, self.ops))

    def forward(self, values: np.ndarray):
        if self.exact:
            re = init_real64(self.n, self.device)
            return run_ops_f64(re, torch.zeros_like(re), self.ops, values)
        re = init_real(self.n, self.device)
        return tuple(self._forward((re, None), values))

    def _runner(self, ops):
        """``run(pair, values) -> pair`` for a step's (adjoint) ops."""
        if self.exact:
            return lambda pair, values: run_ops_f64(*pair, ops, values)
        fn = compile_pair32_ir(CircuitIR(self.n, ops), every_run=True)
        return lambda pair, values: tuple(fn(pair, values))

    def steps(self):
        """Backward steps, last gate first: ``(run, None)`` for a maximal
        run of parameter-free gates, ``(run, gate)`` for a parameterized
        gate (a :class:`_ParamStep`), whose adjoint runs with its
        parameters renumbered from 0. Also sets :attr:`table`."""
        if self._steps is not None:
            return self._steps
        steps = []
        idx = len(self.ops) - 1
        while idx >= 0:
            if not _is_parameterized(self.ops[idx]):
                j = idx
                while j >= 0 and not _is_parameterized(self.ops[j]):
                    j -= 1
                steps.append((self._runner(
                    _adjoint_group(self.ops[j + 1:idx + 1])), None))
                idx = j
                continue
            op = self.ops[idx]
            slots, params = [], []
            for p in op.params:
                if isinstance(p, ParamRef):
                    params.append(ParamRef(len(slots)))
                    slots.append(p.index)
                else:
                    params.append(p)
            adj = dataclasses.replace(op, params=tuple(params),
                                      is_adjoint=not op.is_adjoint)
            _, controls, targets = _split_op(op)
            plan = None
            if not self.exact and self.n >= 2 and \
                    len(targets) <= adjoint_step.MAX_TARGETS:
                plan = adjoint_step.plan(self.n, controls, targets)
            steps.append((self._runner([adj]),
                          _ParamStep(op, np.asarray(slots), controls,
                                     targets, plan)))
            idx -= 1
        self.table = _GateTable([g for _, g in steps if g is not None])
        self._steps = steps
        return steps


def _own(plane):
    return None if plane is None else plane.clone()


class ReversibleExecute(torch.autograd.Function):
    """``(params, sweep) -> (re, im_or_None)``: the sweep's gate list run
    from |0...0>; the backward walks it back (module docstring). Saves
    only the output planes and the parameter vector."""

    @staticmethod
    def forward(ctx, params, sweep):
        values = _host_params(params)
        re, im = sweep.forward(values)
        ctx.sweep = sweep
        ctx.save_for_backward(params, re, im)
        return re, im

    @staticmethod
    def backward(ctx, grad_re, grad_im):
        params, out_re, out_im = ctx.saved_tensors
        sweep = ctx.sweep
        values = _host_params(params)
        # the kernel passes update planes in place: walk own copies, so the
        # returned state and the incoming cotangent stay as they are
        ket = (out_re.clone(), _own(out_im))
        bra = (torch.zeros_like(out_re) if grad_re is None else
               grad_re.clone(), None if out_im is None else _own(grad_im))
        steps = sweep.steps()
        table = sweep.table
        theta = torch.tensor(values, dtype=_F64, requires_grad=True)
        with torch.enable_grad():
            us = table.matrices(theta)
        # one launch a step for what the adjoint step kernel takes
        kernel = (not sweep.exact and table.size == 4
                  and adjoint_step.takes(ket[0])
                  and adjoint_step.takes(bra[0]))
        if kernel:
            vs = adjoint_step.pack(
                us.detach().numpy().conj().transpose(0, 2, 1), table.swaps)
            work = adjoint_step.scratch(ket[0].device)
        mats = torch.zeros((len(table), 2, table.size, table.size),
                           dtype=_F64, device=ket[0].device)
        row = 0
        for run, gate in steps:
            if gate is None:
                ket = run(ket, values)
                bra = run(bra, values)
                continue
            profiling.count("adjoint_steps")
            if kernel and gate.plan is not None:
                ket, bra = adjoint_step.apply(ket, bra, vs[row], gate.plan,
                                              mats[row], work)
                profiling.count("adjoint_kernel_steps")
            else:
                ket = run(ket, values[gate.slots])
                m = _correlation(bra, ket, gate.controls, gate.targets)
                d = m.shape[-1]
                mats[row, :, :d, :d] = m
                bra = run(bra, values[gate.slots])
            row += 1
        return _param_grads(us, theta, mats).to(
            dtype=params.dtype, device=params.device), None


def _param_grads(us: torch.Tensor, theta: torch.Tensor,
                 mats: torch.Tensor) -> torch.Tensor:
    """d/dtheta of sum_k Re sum_ac U_k(theta)_ac M_k,ac, ``us`` the gates'
    matrices built from ``theta`` with their graph, ``mats`` every gate's
    ``(2, size, size)`` M (re, im): one host autograd call after one read
    of every M from the device."""
    if not len(us):
        return torch.zeros_like(theta)
    ms = mats.cpu()
    with torch.enable_grad():
        total = torch.sum(us.real * ms[:, 0] - us.imag * ms[:, 1])
        (grads,) = torch.autograd.grad(total, theta, allow_unused=True)
    return torch.zeros_like(theta) if grads is None else grads


def make_reversible_execute(ops: Sequence[GateOp], num_qubits: int,
                            device=None, exact: bool = False):
    """Build ``run(params) -> (re, im_or_None)``: the gate list from
    |0...0> with the O(1)-memory backward sweep.

    ``ops`` must be purely unitary GateOps (no measurement); parameters are
    ParamRef slots into ``params``, a float tensor autograd differentiates.
    ``exact`` selects the exact complex128 engine (double precision) over
    the fused-kernel float32 engine. The JAX package's ``run(state,
    params)`` starts from any state; the energy needs only |0...0>."""
    ops = list(ops)
    for op in ops:
        if op.matrix is None and op.name.upper() == "UNITARY":
            raise ValueError("UNITARY op requires a matrix")
    if device is None:
        from .api import default_device
        device = default_device()
    sweep = _Sweep(ops, num_qubits, device, exact)

    def run(params):
        return ReversibleExecute.apply(params, sweep)

    return run


def execute_plain(ops: Sequence[GateOp], params, num_qubits: int, device,
                  dtype):
    """The gate list from |0...0> op by op in plain torch on a ``dtype``
    complex state, differentiable in ``params`` and in tensor-valued op
    parameters (``_base_matrix_t``). The fallback for kernels that do host
    arithmetic on their parameters: the fused kernel takes its gate
    matrices by value from the host, so there is nothing of it to
    differentiate through."""
    state = torch.zeros(1 << num_qubits, dtype=dtype, device=device)
    state[0] = 1.0
    for op in ops:
        _, controls, targets = _split_op(op)
        mat = _base_matrix_t(op, params).to(device=device, dtype=dtype)
        state = sv.apply_controlled_matrix(state, mat, controls, targets)
    return state


def reversible_energy_fn(kernel_func, num_qubits: int, hamiltonian,
                         num_params: int, device=None, exact: bool = False):
    """Energy function whose gradient runs the O(1)-memory adjoint sweep
    (``api.make_energy_fn`` picks it)."""
    from .api import _Recorder

    rec = _Recorder(num_qubits)
    func = getattr(kernel_func, "__wrapped__", kernel_func)
    func(rec, *[ParamRef(i) for i in range(num_params)])
    # NB: concrete (fixed-angle) params stay concrete — re-parametrizing
    # them would allocate ParamRef indices colliding with the kernel's own
    # ParamRef(0..P-1) slots
    run = make_reversible_execute(rec.ops, num_qubits, device, exact)
    terms = tuple(tuple(t) for t, _ in hamiltonian.terms)
    coeffs = tuple(float(c) for _, c in hamiltonian.terms)

    def energy_rev(param_vec):
        re, im = run(param_vec)
        return pairsim.energy_pair(re, im, terms, coeffs)

    return energy_rev
