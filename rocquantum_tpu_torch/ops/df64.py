"""Double-float (df64) arithmetic on torch tensors: float64-grade values
carried as hi/lo float32 pairs.

Counterpart of ``rocquantum_tpu/ops/df64.py``. A float64 plane is held as
two float32 planes with ``x = hi + lo`` and ``|lo| <= ulp(hi) / 2`` (about
49 bits of mantissa); products and sums run as error-free transformations
(two-sum, two-prod) on float32, so each gate is accurate to ~2^-48
relative. The CUDA kernel (csrc/fused_df64.cu) computes the error terms
with float32 FMA and round-to-nearest intrinsics; here they are computed
through float64, as the JAX package does on the CPU: exact for float32
operands on any device, and immune to FMA contraction because every torch
operation rounds on its own.

A df64 state is four flat ``(2^n,)`` float32 planes ``(re_hi, re_lo,
im_hi, im_lo)``; ``im_hi = im_lo = None`` carries a real state.
:func:`apply_op_df64` is the per-op path for flush items that are not
kernel blocks; gate coefficients are built on the host in numpy complex128
and split hi/lo there.

The readout twins (:func:`norm2_df64`, :func:`expval_terms_df64`,
:func:`prob_one_df64`, :func:`sample_df64`, ...) promote the planes to
float64 through :func:`state_to_pair_f64` and read them with the float64
readout of ``ops/pairsim.py``, which sums in float64.
:func:`compile_df64_ir` runs a CircuitIR op by op on df64 planes (the
twin of the exact engine, with no kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.cache import BoundedCache
from . import pairsim
from .statevec import (exposed_view_dims, num_qubits_of, permute_index_bits,
                       swap_index_bits)

_F32 = torch.float32
_F64 = torch.float64

# A df value is a pair (hi, lo) of float32 tensors; in a product the
# second operand may be a pair of float32-representable Python floats (a
# gate coefficient split on the host).
DF = Tuple


def _f64(x):
    return x.to(_F64) if isinstance(x, torch.Tensor) else float(x)


# ---------------------------------------------------------------------------
# Error-free transformations (float32 values, error terms via float64)
# ---------------------------------------------------------------------------

def two_sum(a: torch.Tensor, b: torch.Tensor) -> DF:
    """s + e == a + b, s = fl(a + b)."""
    s = a + b
    return s, ((_f64(a) + _f64(b)) - _f64(s)).to(_F32)


def quick_two_sum(a: torch.Tensor, b: torch.Tensor) -> DF:
    """two_sum under the precondition |a| >= |b| (or a == 0); the float64
    route makes it the same computation."""
    return two_sum(a, b)


def two_prod(a: torch.Tensor, b) -> DF:
    """p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    return p, (_f64(a) * _f64(b) - _f64(p)).to(_F32)


# ---------------------------------------------------------------------------
# df64 arithmetic on (hi, lo) pairs
# ---------------------------------------------------------------------------

def df_add(x: DF, y: DF) -> DF:
    """Accurate double-float add (QD "ieee_add"), robust under
    cancellation."""
    s, e = two_sum(x[0], y[0])
    t, f = two_sum(x[1], y[1])
    s, e = quick_two_sum(s, e + t)
    return quick_two_sum(s, e + f)


def df_neg(x: DF) -> DF:
    return -x[0], -x[1]


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    """Double-float product (QD mul): the exact product of the hi parts
    plus the two cross terms (lo * lo is below the result's ulp)."""
    p, e = two_prod(x[0], y[0])
    return quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def df_select(mask: torch.Tensor, x: DF, y: DF) -> DF:
    """Elementwise select (movement only, exact)."""
    return torch.where(mask, x[0], y[0]), torch.where(mask, x[1], y[1])


# ---------------------------------------------------------------------------
# Splits and promotion
# ---------------------------------------------------------------------------

def split_f64_host(v) -> Tuple[float, float]:
    """A float64 scalar as an exact (hi, lo) pair of float32-representable
    Python floats."""
    v = np.float64(v)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return float(hi), float(lo)


def promote_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The float64 value hi + lo."""
    return hi.to(_F64) + lo.to(_F64)


def split_plane_f64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float64 plane as (hi, lo) float32 planes (correctly rounded)."""
    hi = x.to(_F32)
    return hi, (x - hi.to(_F64)).to(_F32)


def state_from_pair_f64(re: torch.Tensor, im: Optional[torch.Tensor]):
    """Float64 pair ``(re, im)`` -> df64 planes; ``im=None`` gives the real
    carry ``(re_hi, re_lo, None, None)``."""
    rh, rl = split_plane_f64(re)
    if im is None:
        return rh, rl, None, None
    ih, il = split_plane_f64(im)
    return rh, rl, ih, il


def state_to_pair_f64(planes):
    """df64 planes -> the float64 pair ``(re, im)`` (``im`` None for the
    real carry)."""
    rh, rl, ih, il = planes
    return promote_f64(rh, rl), None if ih is None else promote_f64(ih, il)


# ---------------------------------------------------------------------------
# Per-op gate application
# ---------------------------------------------------------------------------

def _split_entries(m: np.ndarray):
    """(re, im) nested lists of (hi, lo) pairs, None for an exact zero."""
    def part(x):
        return [[None if x[i, j] == 0 else split_f64_host(x[i, j])
                 for j in range(x.shape[1])] for i in range(x.shape[0])]
    return part(m.real), part(m.imag)


def _apply_real_rows(xs, rows):
    """out_r = sum_c rows[r][c] * xs[c] in df64, over the nonzero entries in
    XOR order (c = r ^ d, d ascending), as the JAX per-op path sums."""
    dim = len(rows)
    out = []
    for r in range(dim):
        acc = None
        for d in range(dim):
            coef = rows[r][r ^ d]
            if coef is None:
                continue
            term = df_mul(xs[r ^ d], coef)
            acc = term if acc is None else df_add(acc, term)
        if acc is None:
            acc = (torch.zeros_like(xs[0][0]), torch.zeros_like(xs[0][1]))
        out.append(acc)
    return out


def apply_matrix_df64(planes, matrix: np.ndarray, targets: Sequence[int],
                      controls: Sequence[int] = ()):
    """Apply a dense ``2^m x 2^m`` complex matrix to ``targets`` (where
    every control is 1) on df64 planes; returns new planes. ``targets[0]``
    is the least significant bit of the matrix index. A real carry
    (``planes[2] is None``) takes real matrices only."""
    rh, rl, ih, il = planes
    matrix = np.asarray(matrix, np.complex128)
    targets = [int(t) for t in targets]
    controls = [int(c) for c in controls]
    m = len(targets)
    if matrix.shape != (1 << m, 1 << m):
        raise ValueError(f"matrix shape {matrix.shape} != {(1 << m, 1 << m)}")
    real_mat = not np.any(matrix.imag)
    if ih is None and not real_mat:
        raise ValueError("the real carry (im planes None) takes real "
                         "matrices only")
    n = num_qubits_of(rh)
    desc = sorted(targets + controls, reverse=True)
    axis = {q: 2 * i + 1 for i, q in enumerate(desc)}
    dims = exposed_view_dims(n, desc)

    def index(c):
        idx = [slice(None)] * len(dims)
        for q in controls:
            idx[axis[q]] = 1
        for j, q in enumerate(targets):
            idx[axis[q]] = (c >> j) & 1
        return tuple(idx)

    idxs = [index(c) for c in range(1 << m)]
    out = [None if p is None else p.clone() for p in planes]
    views = [None if p is None else p.view(dims) for p in planes]
    outv = [None if p is None else p.view(dims) for p in out]

    def gather(hi, lo):
        return [(views[hi][i], views[lo][i]) for i in idxs]

    m_re, m_im = _split_entries(matrix)
    a = _apply_real_rows(gather(0, 1), m_re)
    results = [(0, 1, a)]
    if ih is not None:
        b = _apply_real_rows(gather(2, 3), m_re)
        if real_mat:
            results.append((2, 3, b))
        else:
            c = _apply_real_rows(gather(2, 3), m_im)
            d = _apply_real_rows(gather(0, 1), m_im)
            results = [(0, 1, [df_sub(x, y) for x, y in zip(a, c)]),
                       (2, 3, [df_add(x, y) for x, y in zip(b, d)])]
    for hi, lo, rows in results:
        for i, (vh, vl) in zip(idxs, rows):
            outv[hi][i] = vh
            outv[lo][i] = vl
    return tuple(out)


def apply_op_df64(planes, op, params=None):
    """Apply one GateOp to df64 planes (the per-op path of the df64 flush);
    ``params`` is the flush's host parameter vector."""
    # imported here: the interpreter imports this module
    from ..compiler.interpreter import _base_matrix, _split_op
    from ..compiler.sharded_schedule import (PERMUTE_BITS, SWAP_BITS,
                                             permutation_of)
    if op.name == SWAP_BITS:
        a, b = op.targets
        return tuple(None if p is None else swap_index_bits(p, a, b)
                     for p in planes)
    if op.name == PERMUTE_BITS:
        dsts, srcs = permutation_of(op)
        return tuple(None if p is None else permute_index_bits(p, dsts, srcs)
                     for p in planes)
    _, controls, targets = _split_op(op)
    return apply_matrix_df64(planes, _base_matrix(op, params), targets,
                             controls)


# ---------------------------------------------------------------------------
# State and readout twins (promote to float64, then the pair readout)
# ---------------------------------------------------------------------------

def init_df64(n: int, device=None):
    """|0...0> as four distinct float32 planes on ``device`` (default: the
    CUDA device)."""
    if device is None:
        from ..api import default_device
        device = default_device()
    planes = tuple(torch.zeros(1 << n, dtype=_F32, device=device)
                   for _ in range(4))
    planes[0][0] = 1.0
    return planes


def norm2_df64(planes) -> torch.Tensor:
    return pairsim.norm2_pair(*state_to_pair_f64(planes))


def probs_df64(planes) -> torch.Tensor:
    """|amplitude|^2 in float64."""
    return pairsim.probs_pair(*state_to_pair_f64(planes))


def expval_pauli_product_z_df64(planes, qubits: Sequence[int]
                                ) -> torch.Tensor:
    return pairsim.expval_pauli_product_z_pair(*state_to_pair_f64(planes),
                                               qubits)


def expval_pauli_string_df64(planes, ops: Sequence[tuple]) -> torch.Tensor:
    """<psi| P |psi> on the promoted state (a Pauli's entries are exact in
    either form)."""
    return pairsim.expval_pauli_string_pair(*state_to_pair_f64(planes), ops)


def expval_terms_df64(planes, terms, coeffs) -> torch.Tensor:
    """sum_k coeffs[k] * <P_k> (PauliOperator-style terms), float64."""
    return pairsim.expval_terms_pair(*state_to_pair_f64(planes), terms,
                                     coeffs)


def prob_one_df64(planes, qubit: int) -> torch.Tensor:
    return pairsim.prob_one_pair(*state_to_pair_f64(planes), qubit)


def collapse_df64(planes, qubit: int, outcome: int):
    """Project onto ``qubit = outcome`` and renormalize: the mask in df64
    (movement), the norm in float64, the inverse norm split into a (hi,
    lo) coefficient. A real carry stays real."""
    out = [None if p is None else p.clone() for p in planes]
    for p in out:
        if p is not None:
            pairsim._bit_halves(p, qubit)[1 - int(outcome)].zero_()
    norm = float(torch.sqrt(norm2_df64(out)))
    s = split_f64_host(1.0 / max(norm, 1e-12))
    rh, rl, ih, il = out
    a = df_mul((rh, rl), s)
    if ih is None:
        return a[0], a[1], None, None
    b = df_mul((ih, il), s)
    return a[0], a[1], b[0], b[1]


def sample_df64(planes, qubits: Sequence[int], shots: int,
                generator: torch.Generator) -> torch.Tensor:
    """``shots`` draws (int32) from the float64 marginal over ``qubits``,
    from ``generator`` (the simulator's, on the planes' device)."""
    return pairsim.sample_pair(*state_to_pair_f64(planes), qubits, shots,
                               generator)


# ---------------------------------------------------------------------------
# Compiled df64 programs
# ---------------------------------------------------------------------------

_DF64_EXEC_CACHE = BoundedCache()


def compile_df64_ir(ir, sharding=None):
    """``f(rh, rl, ih, il, params) -> planes`` for a CircuitIR: every op in
    order through :func:`apply_op_df64` (SWAP_BITS and PERMUTE_BITS as
    index-bit moves), cached by structural key plus the concrete parameters
    the IR bakes in; ``params`` are the ParamRef values. ``ih = il = None``
    carries a real state until the first complex gate."""
    if sharding is not None:
        raise NotImplementedError(
            "compile_df64_ir(sharding=...) needs the sharded engine, which "
            "this package does not have yet")
    # imported here: the interpreter imports this module
    from ..compiler.interpreter import (_base_matrix, _complex_planes,
                                        _host_params, _plan_key)
    from ..compiler.sharded_schedule import PERMUTE_BITS, SWAP_BITS
    key = _plan_key(ir)
    fn = _DF64_EXEC_CACHE.get(key)
    if fn is not None:
        return fn
    ops = list(ir.ops)

    def run(rh, rl, ih, il, params=None):
        planes = (rh, rl, ih, il)
        params = _host_params(params)
        for op in ops:
            if planes[2] is None and op.name not in (SWAP_BITS, PERMUTE_BITS) \
                    and np.any(_base_matrix(op, params).imag):
                planes = _complex_planes(planes)
            planes = apply_op_df64(planes, op, params)
        return planes

    _DF64_EXEC_CACHE[key] = run
    return run
