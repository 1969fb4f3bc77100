"""The float-pair state: readout (norms, Pauli expectations,
probabilities, measurement, sampling and slices), gate application and
compiled float64 pair programs.

Counterpart of ``rocquantum_tpu/ops/pairsim.py``, in plain torch on the
device that holds the state. The JAX package applies gates to the pair in
explicit real arithmetic (roll-and-mask passes), a workaround of the TPU's
float64 and complex128 limits; here a gate is ``statevec.apply_matrix`` on
each plane with the real and imaginary parts of its matrix, and a
compiled pair program is the exact engine
(``interpreter.run_ops_f64``). Every function takes the state as flat
``(2^n,)`` float32 or float64 planes ``(re, im)``; ``im=None`` is a real
state. Bit tests use strided views (no index arrays), and every reduction
accumulates in float64. ``collapse_pair`` guards its renormalization with
the precision's ``config.eps()``.

The planes may carry a leading batch axis, ``(b, 2^n)``: the readouts then
return one value (or row, or draw set) per element. The ``*_batched``
functions are the JAX package's batched double twins with its signatures
(``n`` and ``b`` given, checked against the planes). The JAX package keeps
a batched float64 state as one flat pair with the batch in padded top
index bits, a workaround of the TPU's 2-D float64 and int32-iota limits;
here the batch is the leading axis of ``(b, 2^n)`` planes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..utils import profiling
from ..utils.cache import BoundedCache
from . import gates as G
from . import statevec as sv
from .statevec import num_qubits_of

_F64 = torch.float64


def _passes(k: int = 1) -> None:
    """Count ``k`` readout passes: torch operations over a whole plane or
    a half-plane view (utils/profiling ``readout_passes``)."""
    profiling.count("readout_passes", k)


def _sum64(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """``torch.sum`` into float64: one pass, and one more for a plane of
    another dtype, which the sum casts to float64 first."""
    _passes(1 + (x.dtype != _F64))
    return torch.sum(x, dim=dim, dtype=_F64)


def _bit_view(x: torch.Tensor, q: int) -> torch.Tensor:
    """A plane as (batch..., high bits, bit q, low bits)."""
    n = num_qubits_of(x)
    return x.view(x.shape[:-1] + (1 << (n - 1 - q), 2, 1 << q))


def _bit_halves(x: torch.Tensor, q: int):
    """(bit q = 0, bit q = 1) strided views of a plane."""
    v = _bit_view(x, q)
    return v[..., 0, :], v[..., 1, :]


def probs_pair(re: torch.Tensor, im: Optional[torch.Tensor]) -> torch.Tensor:
    """|amplitude|^2 in the planes' dtype."""
    _passes(1 if im is None else 3)
    return re * re if im is None else re * re + im * im


def norm2_pair(re, im) -> torch.Tensor:
    return _sum64(probs_pair(re, im))


def expval_pauli_product_z_pair(re, im, qubits: Sequence[int]
                                ) -> torch.Tensor:
    """<Z...Z>: probabilities with the sign of the parity of ``qubits``."""
    s = probs_pair(re, im)
    for q in sorted(set(int(q) for q in qubits)):
        _, one = _bit_halves(s, q)
        _passes()
        one.neg_()
    return _sum64(s)


def _apply_pauli(pre, pim, ch: str, q: int):
    """P|phi> for one Pauli on qubit q, on float planes (pim may be None
    for a real phi and X/Z)."""
    if ch == "Z":
        _passes(2 if pim is None else 4)  # a clone and a sign flip a plane
        pre = pre.clone()
        _bit_halves(pre, q)[1].neg_()
        if pim is not None:
            pim = pim.clone()
            _bit_halves(pim, q)[1].neg_()
        return pre, pim
    def flip(x):
        _passes()
        return _bit_view(x, q).flip(-2).reshape(x.shape)

    if ch == "X":
        return flip(pre), None if pim is None else flip(pim)
    # Y = [[0, -i], [i, 0]]: new_0 = -i x_1, new_1 = i x_0
    if pim is None:
        _passes()
        pim = torch.zeros_like(pre)
    new_re = flip(pim)
    new_im = flip(pre)
    _passes(2)
    _bit_halves(new_re, q)[1].neg_()
    _bit_halves(new_im, q)[0].neg_()
    return new_re, new_im


def expval_pauli_string_pair(re, im, ops: Sequence[tuple]) -> torch.Tensor:
    """<psi| P |psi> for a Pauli string [(char, qubit), ...]: apply P to a
    copy, then Re<psi|phi> = sum(re*phi_re + im*phi_im)."""
    if all(ch in ("I", "Z") for ch, _ in ops):
        zs = [q for ch, q in ops if ch == "Z"]
        return expval_pauli_product_z_pair(re, im, zs) if zs \
            else norm2_pair(re, im)
    pre, pim = re, im
    for ch, q in ops:
        if ch != "I":
            pre, pim = _apply_pauli(pre, pim, ch, int(q))
    _passes()
    total = _sum64(re * pre)
    if im is not None and pim is not None:
        _passes()
        total = total + _sum64(im * pim)
    return total


def expval_terms_pair(re, im, terms, coeffs) -> torch.Tensor:
    """Sum_k coeffs[k] * <P_k> for PauliOperator-style terms
    [((char, qubit), ...), ...], as a float64 tensor: 0-d, or ``(b,)`` for
    a batch."""
    total = torch.zeros(re.shape[:-1], dtype=_F64, device=re.device)
    for term, c in zip(terms, coeffs):
        with profiling.span("rq.expval.term"):
            ev = norm2_pair(re, im) if len(term) == 0 \
                else expval_pauli_string_pair(re, im, term)
            total = total + float(c) * ev
    return total


def hamiltonian_pair(re, im, terms, coeffs):
    """H|psi> = sum_k coeffs[k] P_k |psi> as planes in the state's dtype,
    accumulated one term at a time: two planes for the sum (one while the
    state is real, whose imaginary part is then not formed) and one or two
    for the term in hand."""
    h_re = torch.zeros_like(re)
    h_im = None if im is None else torch.zeros_like(im)
    for term, c in zip(terms, coeffs):
        pre, pim = re, im
        for ch, q in term:
            if ch != "I":
                pre, pim = _apply_pauli(pre, pim, ch, int(q))
        h_re.add_(pre, alpha=float(c))
        if h_im is not None and pim is not None:
            h_im.add_(pim, alpha=float(c))
        del pre, pim
    return h_re, h_im


class _Energy(torch.autograd.Function):
    """<psi|H|psi> with the cotangent that jax.grad forms for it:
    dE/d(re, im) = 2 H|psi> on the planes. Autograd does not trace the
    readout (each term's copies would be saved, about two planes a term);
    the backward builds H|psi> from the saved planes instead."""

    @staticmethod
    def forward(ctx, re, im, terms, coeffs):
        ctx.save_for_backward(re, im)
        ctx.terms, ctx.coeffs = terms, coeffs
        return expval_terms_pair(re, im, terms, coeffs)

    @staticmethod
    def backward(ctx, grad):
        re, im = ctx.saved_tensors
        h_re, h_im = hamiltonian_pair(re, im, ctx.terms, ctx.coeffs)
        scale = (2 * grad).to(re.dtype)
        h_re.mul_(scale)
        if h_im is not None:
            h_im.mul_(scale)
        return h_re, h_im, None, None


def energy_pair(re, im, terms, coeffs) -> torch.Tensor:
    """:func:`expval_terms_pair` as a float64 0-d tensor that autograd
    differentiates with respect to the planes (:class:`_Energy`)."""
    return _Energy.apply(re, im, tuple(tuple(t) for t in terms),
                         tuple(float(c) for c in coeffs))


def prob_one_pair(re, im, qubit: int) -> torch.Tensor:
    """P(qubit = 1) (of each element)."""
    _, one = _bit_halves(probs_pair(re, im), qubit)
    return _sum64(one, dim=(-2, -1))


def collapse_pair(re, im, qubit: int, outcome: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Project onto ``qubit = outcome`` and renormalize; a real state stays
    real (``im`` None in, None out)."""
    re = re.clone()
    im = None if im is None else im.clone()
    for plane in (re, im):
        if plane is not None:
            _bit_halves(plane, qubit)[1 - int(outcome)].zero_()
    norm = float(torch.sqrt(norm2_pair(re, im)))
    inv = 1.0 / max(norm, config.eps())
    re.mul_(inv)
    if im is not None:
        im.mul_(inv)
    return re, im


_CHUNK = 1 << 22  # amplitudes per step of the general marginal


def marginal_probs_pair(re, im, qubits: Sequence[int]) -> torch.Tensor:
    """Marginal probability vector over ``qubits`` (qubits[0] = least
    significant bit of the outcome index), accumulated in float64; ``(b,
    2^k)`` rows for a batch. The full register in order is the |amp|^2
    vector itself."""
    qubits = [int(q) for q in qubits]
    n = num_qubits_of(re)
    p = probs_pair(re, im)
    if qubits == list(range(n)):
        _passes()
        return p.to(_F64)
    # the chunks' casts and scatter-adds: two passes over the plane
    _passes(2)
    k = len(qubits)
    out = torch.zeros(re.shape[:-1] + (1 << k,), dtype=_F64,
                      device=re.device)
    for start in range(0, 1 << n, _CHUNK):
        stop = min(start + _CHUNK, 1 << n)
        idx = torch.arange(start, stop, dtype=torch.int64, device=re.device)
        bins = torch.zeros_like(idx)
        for j, q in enumerate(qubits):
            bins |= ((idx >> q) & 1) << j
        out.index_add_(-1, bins, p[..., start:stop].to(_F64))
    return out


def sample_pair(re, im, qubits: Sequence[int], shots: int,
                generator: torch.Generator) -> torch.Tensor:
    """Draw ``shots`` outcomes (int32, as the JAX package's draws) from the
    marginal over ``qubits``; ``(b, shots)`` for a batch."""
    return sample_marginal(marginal_probs_pair(re, im, qubits), shots,
                           generator)


def sample_marginal(marg: torch.Tensor, shots: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Draw ``shots`` outcomes (int32) from a probability vector by
    inverse-CDF search on its device; from each row of ``(b, K)``
    probabilities, independently, into ``(b, shots)``, in one call."""
    _passes()
    cdf = torch.cumsum(marg, -1)
    u = torch.rand(marg.shape[:-1] + (shots,), generator=generator,
                   dtype=_F64, device=marg.device) * cdf[..., -1:]
    out = torch.searchsorted(cdf, u, right=True, out_int32=True)
    return out.clamp_(max=cdf.shape[-1] - 1)


def slice_pair(re, im, start: int, size: int):
    """(re, im) of amplitudes [start, start+size) (of each element); im
    None for a real state."""
    return (re[..., start:start + size],
            None if im is None else im[..., start:start + size])


# ---------------------------------------------------------------------------
# Batched double twins (the JAX package's signatures, pairsim.py:549-727)
# ---------------------------------------------------------------------------

def _batched(re, n: int, b: int):
    if tuple(re.shape) != (b, 1 << n):
        raise ValueError(f"expected ({b}, {1 << n}) planes, got "
                         f"{tuple(re.shape)}")


def init_pair_batched(n: int, b: int, dtype=None, device=None):
    """|0...0> in each of b elements, as ``(b, 2^n)`` planes."""
    re = torch.zeros((b, 1 << n), dtype=dtype or config.real_dtype(),
                     device=device)
    re[:, 0] = 1.0
    return re, torch.zeros_like(re)


def prob_one_pair_batched(re, im, qubit: int, n: int, b: int):
    """Per-element P(qubit = 1), ``(b,)``."""
    _batched(re, n, b)
    return prob_one_pair(re, im, qubit)


def collapse_pair_batched(re, im, qubit: int, outcomes, n: int, b: int):
    """Project element k onto ``qubit = outcomes[k]`` and renormalize each
    element (its norm guarded by ``config.eps()``)."""
    _batched(re, n, b)
    want = torch.as_tensor(outcomes, device=re.device).to(torch.int64)
    keep = (torch.arange(2, device=re.device) == want.reshape(b, 1)).view(
        b, 1, 2, 1)
    re = (_bit_view(re, qubit) * keep).reshape(re.shape)
    im = None if im is None else \
        (_bit_view(im, qubit) * keep).reshape(im.shape)
    inv = 1.0 / torch.sqrt(norm2_pair(re, im)).clamp(min=config.eps())
    inv = inv.to(re.dtype).reshape(b, 1)
    return re * inv, None if im is None else im * inv


def expval_terms_pair_batched(re, im, terms, coeffs, n: int, b: int):
    """Per-element sum_k coeffs[k] * <P_k>, ``(b,)``."""
    _batched(re, n, b)
    return expval_terms_pair(re, im, terms, coeffs)


def marginal_probs_pair_batched(re, im, qubits, n: int, b: int):
    """Per-element marginals, ``(b, 2^len(qubits))``, in float64."""
    _batched(re, n, b)
    return marginal_probs_pair(re, im, qubits)


def sample_pair_batched(re, im, qubits, shots: int, generator, n: int,
                        b: int):
    """Per-element draws, ``(b, shots)`` int32."""
    _batched(re, n, b)
    return sample_pair(re, im, qubits, shots, generator)


def slice_pair_batched(re, im, start: int, size: int, n: int, b: int):
    """Per-element amplitude slices, a ``(b, size)`` pair."""
    _batched(re, n, b)
    return slice_pair(re, im, start, size)


def statevector_pair_batched(re, im, n: int, b: int):
    """The ``(b, 2^n)`` readback rows."""
    _batched(re, n, b)
    return re, im


# ---------------------------------------------------------------------------
# Gate application and compiled pair programs (the fp64 engine's surface)
# ---------------------------------------------------------------------------

def init_pair(n: int, dtype=None, device=None):
    """|0...0> as a flat float pair (``dtype`` defaults to the precision's
    real type, ``device`` to the card; a float32 plane is written by the
    fill kernel on CUDA, as the JAX package writes it with its Pallas
    fill)."""
    dtype = dtype or config.real_dtype()
    if device is None:
        device = sv._default_device()
    if dtype == torch.float32:
        from ..compiler.interpreter import init_real
        re = init_real(n, device)
    else:
        re = torch.zeros(1 << n, dtype=dtype, device=device)
        re[0] = 1.0
    return re, torch.zeros_like(re)


def _rows_from_matrix(m):
    """Nested Python-float rows ``(re, im_or_None)`` of a square host
    matrix; ``im`` is None when every imaginary part is exactly 0."""
    m = np.asarray(m, np.complex128)
    if not np.any(m.imag):
        return m.real.tolist(), None
    return m.real.tolist(), m.imag.tolist()


def gate_rows(name: str, params=(), dtype=None):
    """``(re, im_or_None)`` scalar rows (nested Python floats) of a named
    gate's matrix, CNOT/CX as X. ``dtype``, the JAX package's row
    precision, is accepted for its signature: the rows hold float64 values
    and :func:`apply_matrix_pair` casts them to the planes' dtype."""
    key = name.upper()
    if key in ("CNOT", "CX"):
        key = "X"
    return _rows_from_matrix(G.gate_matrix(key, params))


def op_rows_targets(op, params_resolved: Sequence = None, dtype=None):
    """Resolve a CircuitIR GateOp to ``(m_re, m_im_or_None, targets)``
    scalar rows with the controls embedded as the high matrix-index bits
    (appended to the targets): the identity except the all-controls-one
    block. ``params_resolved`` overrides ``op.params``; implicitly
    controlled names (CNOT, CZ, CRX, ..., CSWAP, the dsl form with the
    control in ``targets`` included) normalize as the interpreter's.
    ``dtype`` as in :func:`gate_rows`."""
    from ..compiler.interpreter import _base_matrix, _split_op
    if params_resolved is not None:
        op = dataclasses.replace(op, params=tuple(params_resolved))
    _, ctrls, tgts = _split_op(op)
    m = _base_matrix(op, None)
    if ctrls:
        full = np.eye(m.shape[0] << len(ctrls), dtype=np.complex128)
        full[-m.shape[0]:, -m.shape[0]:] = m
        m = full
    return _rows_from_matrix(m) + (list(tgts) + list(ctrls),)


def apply_matrix_pair(re: torch.Tensor, im: Optional[torch.Tensor],
                      m_re, m_im, targets: Sequence[int]):
    """A dense m-qubit matrix given as real and imaginary rows (nested
    floats, arrays or CPU tensors) on the pair: ``re' = M_re re - M_im
    im``, ``im' = M_re im + M_im re``. ``m_im=None`` marks a real matrix (half the
    products); ``im=None`` a real state, which stays real under one."""
    mr = torch.as_tensor(m_re, dtype=re.dtype).to(re.device)
    a = sv.apply_matrix(re, mr, targets)
    b = None if im is None else sv.apply_matrix(im, mr, targets)
    if m_im is None:
        return a, b
    mi = torch.as_tensor(m_im, dtype=re.dtype).to(re.device)
    d = sv.apply_matrix(re, mi, targets)
    if im is None:
        return a, d
    return a - sv.apply_matrix(im, mi, targets), b + d


def apply_op_pair(re: torch.Tensor, im: Optional[torch.Tensor], op,
                  params_resolved: Sequence = None):
    """Apply one CircuitIR GateOp (relabels and ``D2M`` diagonals
    included) to the pair exactly, on complex values; returns the full
    pair."""
    from ..compiler.interpreter import run_ops_f64
    if params_resolved is not None:
        op = dataclasses.replace(op, params=tuple(params_resolved))
    return run_ops_f64(re, im, [op])


_PAIR_EXEC_CACHE = BoundedCache()


def compile_pair_ir(ir, sharding=None):
    """``f(re, im, params) -> (re, im)`` for a CircuitIR: every op in
    order, exactly, through ``interpreter.run_ops_f64`` (the float64 twin
    of ``compile_ir``, without fusion, as in the JAX package), cached by
    structural key plus the concrete parameters the IR bakes in; ``params``
    are the ParamRef values. With ``sharding`` the program is ``f(state,
    params) -> state`` on a ShardedState of float64 pairs
    (``interpreter.run_ops_f64_sharded``: the same ops on every shard,
    relabels across the local/global boundary as all-to-all rounds)."""
    from ..compiler.interpreter import (_plan_key, run_ops_f64,
                                        run_ops_f64_sharded)
    from ..parallel import sharded
    sharded.check_sharding(sharding)
    key = _plan_key(ir, "pair", sharding)
    fn = _PAIR_EXEC_CACHE.get(key)
    if fn is not None:
        return fn
    ops = list(ir.ops)
    if sharding is not None:
        def run_sharded(state, params=None):
            sharded.check_sharding(sharding, state)
            return run_ops_f64_sharded(state, ops, params)

        fn = run_sharded
    else:
        def run(re, im, params=None):
            return run_ops_f64(re, im, ops, params)

        fn = run
    _PAIR_EXEC_CACHE[key] = fn
    return fn
