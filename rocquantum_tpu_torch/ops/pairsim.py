"""Readout on the float-pair state: norms, Pauli expectations,
probabilities, measurement, sampling and slices.

The readout subset of ``rocquantum_tpu/ops/pairsim.py``, in plain torch
on the device that holds the state. Every function takes the state as flat
``(2^n,)`` float32 or float64 planes ``(re, im)``; ``im=None`` is a real
state. Bit tests use strided views (no index arrays), and every reduction
accumulates in float64. ``collapse_pair`` guards its renormalization with
the precision's ``config.eps()``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import config
from .statevec import num_qubits_of

_F64 = torch.float64


def _bit_halves(x: torch.Tensor, q: int):
    """(bit q = 0, bit q = 1) strided views of a flat plane."""
    n = num_qubits_of(x)
    v = x.view(1 << (n - 1 - q), 2, 1 << q)
    return v[:, 0], v[:, 1]


def probs_pair(re: torch.Tensor, im: Optional[torch.Tensor]) -> torch.Tensor:
    """|amplitude|^2 in the planes' dtype."""
    return re * re if im is None else re * re + im * im


def norm2_pair(re, im) -> torch.Tensor:
    return torch.sum(probs_pair(re, im), dtype=_F64)


def expval_pauli_product_z_pair(re, im, qubits: Sequence[int]
                                ) -> torch.Tensor:
    """<Z...Z>: probabilities with the sign of the parity of ``qubits``."""
    s = probs_pair(re, im)
    for q in sorted(set(int(q) for q in qubits)):
        _, one = _bit_halves(s, q)
        one.neg_()
    return torch.sum(s, dtype=_F64)


def _apply_pauli(pre, pim, ch: str, q: int):
    """P|phi> for one Pauli on qubit q, on float planes (pim may be None
    for a real phi and X/Z)."""
    if ch == "Z":
        pre = pre.clone()
        _bit_halves(pre, q)[1].neg_()
        if pim is not None:
            pim = pim.clone()
            _bit_halves(pim, q)[1].neg_()
        return pre, pim
    n = num_qubits_of(pre)

    def flip(x):
        return x.view(1 << (n - 1 - q), 2, 1 << q).flip(1).reshape(-1)

    if ch == "X":
        return flip(pre), None if pim is None else flip(pim)
    # Y = [[0, -i], [i, 0]]: new_0 = -i x_1, new_1 = i x_0
    if pim is None:
        pim = torch.zeros_like(pre)
    new_re = flip(pim)
    new_im = flip(pre)
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
    total = torch.sum(re * pre, dtype=_F64)
    if im is not None and pim is not None:
        total = total + torch.sum(im * pim, dtype=_F64)
    return total


def expval_terms_pair(re, im, terms, coeffs) -> torch.Tensor:
    """Sum_k coeffs[k] * <P_k> for PauliOperator-style terms
    [((char, qubit), ...), ...], as a float64 scalar tensor."""
    total = torch.zeros((), dtype=_F64, device=re.device)
    for term, c in zip(terms, coeffs):
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
    """P(qubit = 1)."""
    _, one = _bit_halves(probs_pair(re, im), qubit)
    return torch.sum(one, dtype=_F64)


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
    significant bit of the outcome index), accumulated in float64. The
    full register in order is the |amp|^2 vector itself."""
    qubits = [int(q) for q in qubits]
    n = num_qubits_of(re)
    p = probs_pair(re, im)
    if qubits == list(range(n)):
        return p.to(_F64)
    k = len(qubits)
    out = torch.zeros(1 << k, dtype=_F64, device=re.device)
    for start in range(0, 1 << n, _CHUNK):
        stop = min(start + _CHUNK, 1 << n)
        idx = torch.arange(start, stop, dtype=torch.int64, device=re.device)
        bins = torch.zeros_like(idx)
        for j, q in enumerate(qubits):
            bins |= ((idx >> q) & 1) << j
        out.index_add_(0, bins, p[start:stop].to(_F64))
    return out


def sample_pair(re, im, qubits: Sequence[int], shots: int,
                generator: torch.Generator) -> torch.Tensor:
    """Draw ``shots`` outcomes (int32, as the JAX package's draws) from the
    marginal over ``qubits``."""
    return sample_marginal(marginal_probs_pair(re, im, qubits), shots,
                           generator)


def sample_marginal(marg: torch.Tensor, shots: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Draw ``shots`` outcomes (int32) from a probability vector by
    inverse-CDF search on its device."""
    cdf = torch.cumsum(marg, 0)
    u = torch.rand(shots, generator=generator, dtype=_F64,
                   device=marg.device) * cdf[-1]
    out = torch.searchsorted(cdf, u, right=True, out_int32=True)
    return out.clamp_(max=cdf.numel() - 1)


def slice_pair(re, im, start: int, size: int):
    """(re, im) of amplitudes [start, start+size); im None for a real
    state."""
    return (re[start:start + size],
            None if im is None else im[start:start + size])
