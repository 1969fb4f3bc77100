"""The density matrix as float planes: the exact double engine and the
readout of every precision.

Counterpart of ``rocquantum_tpu/ops/pairdm.py``. rho is the flattened
``2^n x 2^n`` matrix, ``(4^n,)`` planes ``(re, im)`` with the ROW (ket)
index in the HIGH n bits (``im`` None while rho is real). Row ``r``,
column ``c`` is flat index ``r * 2^n + c``.

- The exact engine (``set_precision("double")``): ``U rho U†`` applies
  ``U`` at the row bits ``q + n`` and ``conj(U)`` at the column bits
  ``q``; a channel applies its dense superoperator on ``(q, q + n)``, or
  per Kraus term from three targets on. It runs on complex128 in plain
  torch, as ``interpreter.run_ops_f64`` does for a state vector.
- The readout reads only what it needs: a trace, a probability, a
  marginal or a ``<Z...Z>`` reads the 2^n diagonal entries, and a Pauli
  string P reads the 2^n entries ``rho[r ^ f, r]`` (f the X/Y mask), since
  ``Tr(P rho) = sum_r P[r, r ^ f] rho[r ^ f, r]``. Every sum accumulates
  in float64, in every precision (``purity`` alone reads every entry).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..compiler.interpreter import _base_matrix, _split_op
from . import gates as _g
from . import pairsim
from . import statevec as sv
from .density import channel_kraus, kraus_superoperator

_F64 = torch.float64


def num_qubits_of(re: torch.Tensor) -> int:
    """n of a ``(4^n,)`` rho plane."""
    n2 = sv.num_qubits_of(re)
    if n2 % 2:
        raise ValueError(f"density plane size {re.shape[-1]} is not 4**n")
    return n2 // 2


def to_complex(re: torch.Tensor, im: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.complex(re, im if im is not None else torch.zeros_like(re))


def to_planes(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return state.real.contiguous(), state.imag.contiguous()


# -- the exact engine (complex rho, plain torch) ------------------------------

def apply_op_dm(state: torch.Tensor, op, n: int, params=None) -> torch.Tensor:
    """rho' = U rho U† for one GateOp on logical qubits of the complex
    ``(4^n,)`` rho; controls embed on both sides (a controlled U conjugates
    to a controlled conj(U)). ``params`` resolves ParamRef slots."""
    _, controls, targets = _split_op(op)
    m = _base_matrix(op, params)
    state = sv.apply_controlled_matrix(state, m, [c + n for c in controls],
                                       [t + n for t in targets])
    return sv.apply_controlled_matrix(state, np.conj(m), controls, targets)


def apply_kraus_at_dm(state: torch.Tensor, kraus_ops: List,
                      row_pos: Sequence[int],
                      col_pos: Sequence[int]) -> torch.Tensor:
    """rho' = sum_i K_i rho K_i† with the row and column qubits at the flat
    bits ``row_pos`` and ``col_pos``: one dense superoperator for one or
    two qubits, per Kraus term from three on (the superoperator would be
    4^m x 4^m)."""
    row_pos, col_pos = list(row_pos), list(col_pos)
    if len(row_pos) >= 3:
        acc = None
        for k in kraus_ops:
            k = np.asarray(k, np.complex128)
            term = sv.apply_matrix(state, k, row_pos)
            term = sv.apply_matrix(term, np.conj(k), col_pos)
            acc = term if acc is None else acc + term
        return acc
    return sv.apply_matrix(state, kraus_superoperator(kraus_ops),
                           col_pos + row_pos)


def apply_op_pair_dm(re, im, op, n: int, params_resolved: Sequence = None):
    """:func:`apply_op_dm` on planes; ``params_resolved`` are the op's
    parameter values. Returns the full pair."""
    if params_resolved is not None:
        op = dataclasses.replace(op, params=tuple(params_resolved))
    return to_planes(apply_op_dm(to_complex(re, im), op, n))


def apply_kraus_at_pair_dm(re, im, kraus_ops: List, row_pos: Sequence[int],
                           col_pos: Sequence[int]):
    return to_planes(apply_kraus_at_dm(to_complex(re, im), kraus_ops,
                                       row_pos, col_pos))


def apply_kraus_pair_dm(re, im, kraus_ops: List, targets: Sequence[int],
                        n: int):
    """rho' = sum_i K_i rho K_i† on logical qubits (row bits at q + n)."""
    return apply_kraus_at_pair_dm(re, im, kraus_ops,
                                  [t + n for t in targets], list(targets))


def apply_channel_pair_dm(re, im, channel_type: str, prob: float,
                          targets: Sequence[int], n: int):
    """A named one-qubit channel on each target."""
    kraus = channel_kraus(channel_type, prob)
    state = to_complex(re, im)
    for t in targets:
        state = apply_kraus_at_dm(state, kraus, [t + n], [t])
    return to_planes(state)


# -- readout ------------------------------------------------------------------

def diagonal(re: torch.Tensor, n: int) -> torch.Tensor:
    """The 2^n diagonal entries of a rho plane (a strided view)."""
    return re.view(1 << n, 1 << n).diagonal()


def trace_pair_dm(re, n: int) -> torch.Tensor:
    return torch.sum(diagonal(re, n), dtype=_F64)


def purity_pair_dm(re, im) -> torch.Tensor:
    """Tr(rho^2) = sum_ij |rho_ij|^2 (rho Hermitian)."""
    return pairsim.norm2_pair(re, im)


def probabilities_pair_dm(re, n: int) -> torch.Tensor:
    """diag(rho) as a float64 vector of 2^n."""
    return diagonal(re, n).to(_F64)


def prob_one_pair_dm(re, qubit: int, n: int) -> torch.Tensor:
    """P(qubit = 1): the diagonal entries with the qubit's bit set."""
    probs = probabilities_pair_dm(re, n)
    return probs.view(1 << (n - 1 - qubit), 2, 1 << qubit)[:, 1].sum()


def collapse_pair_dm(re, im, qubit: int, outcome: int, n: int):
    """rho' = P rho P / Tr(P rho P): keep the entries whose row bit AND
    column bit at ``qubit`` equal ``outcome``; a real rho stays real."""
    a, b = 1 << (n - 1 - qubit), 1 << qubit
    drop = 1 - int(outcome)
    out = []
    for plane in (re, im):
        if plane is None:
            out.append(None)
            continue
        plane = plane.clone()
        view = plane.view(a, 2, b, a, 2, b)
        view[:, drop].zero_()
        view[:, :, :, :, drop].zero_()
        out.append(plane)
    inv = 1.0 / max(float(trace_pair_dm(out[0], n)), config.eps())
    for plane in out:
        if plane is not None:
            plane.mul_(inv)
    return out[0], out[1]


def marginal_probs(probs: torch.Tensor, qubits: Sequence[int],
                   n: int) -> torch.Tensor:
    """Marginal of a 2^n probability vector over ``qubits`` (qubits[0] the
    least significant bit of the outcome index)."""
    qubits = [int(q) for q in qubits]
    axes = [n - 1 - q for q in qubits]  # axis a of the (2,)*n view: bit n-1-a
    t = probs.reshape((2,) * n)
    drop = [a for a in range(n) if a not in axes]
    if drop:
        t = t.sum(dim=drop)
    kept = sorted(axes)
    k = len(qubits)
    return t.permute([kept.index(axes[k - 1 - j]) for j in range(k)]
                     ).reshape(-1)


def marginal_probs_pair_dm(re, qubits: Sequence[int], n: int) -> torch.Tensor:
    return marginal_probs(probabilities_pair_dm(re, n), qubits, n)


def sample_pair_dm(re, qubits: Sequence[int], shots: int,
                   generator: torch.Generator) -> torch.Tensor:
    """``shots`` outcomes over ``qubits`` (int32, as the JAX package's
    draws) from the diagonal's marginal."""
    n = num_qubits_of(re)
    return pairsim.sample_marginal(marginal_probs_pair_dm(re, qubits, n),
                                   shots, generator)


def _pauli_mask(ops: Sequence[tuple], n: int):
    """(f, s, c) with ``P[r, r ^ f] = c * (-1)^popcount(r & s)`` for the
    Pauli string ``ops`` (applied in order; a qubit may repeat)."""
    mats = {}
    for ch, q in ops:
        q = int(q)
        if not 0 <= q < n:
            raise ValueError(f"qubit {q} out of range for {n} qubits")
        if ch != "I":
            mats[q] = _g.PAULI[ch] @ mats.get(q, _g.I)
    f = s = 0
    c = 1.0 + 0j
    for q, m in mats.items():
        off = abs(m[0, 1]) > 0.5
        v0, v1 = (m[0, 1], m[1, 0]) if off else (m[0, 0], m[1, 1])
        f |= int(off) << q
        s |= int((v1 / v0).real < 0) << q
        c *= v0
    return f, s, c


def expval_pauli_string_pair_dm(re, im, ops: Sequence[tuple],
                                n: int) -> torch.Tensor:
    """Tr(P rho) from the 2^n entries ``rho[r ^ f, r]``, as a float64
    0-d tensor."""
    f, s, c = _pauli_mask(ops, n)
    r = torch.arange(1 << n, device=re.device)
    idx = ((r ^ f) << n) | r
    parity = torch.zeros_like(r)
    for q in range(n):
        if (s >> q) & 1:
            parity ^= (r >> q) & 1
    sign = (1 - 2 * parity).to(_F64)
    total = c.real * torch.sum(torch.take(re, idx).to(_F64) * sign)
    if c.imag != 0 and im is not None:
        total = total - c.imag * torch.sum(torch.take(im, idx).to(_F64)
                                           * sign)
    return total


def expval_pauli_product_z_pair_dm(re, qubits: Sequence[int],
                                   n: int) -> torch.Tensor:
    """Tr((Z...Z) rho): the diagonal signed by the parity of ``qubits``
    (a repeated qubit counts once, as in the JAX package)."""
    return expval_pauli_string_pair_dm(
        re, None, [("Z", q) for q in sorted(set(int(q) for q in qubits))], n)


def expval_terms_pair_dm(re, im, terms, coeffs, n: int) -> torch.Tensor:
    """Sum_k coeffs[k] * Tr(P_k rho) for PauliOperator-style terms, as a
    float64 0-d tensor."""
    total = torch.zeros((), dtype=_F64, device=re.device)
    for term, c in zip(terms, coeffs):
        if len(term) == 0:
            ev = trace_pair_dm(re, n)
        elif all(p == "Z" for p, _ in term):
            ev = expval_pauli_product_z_pair_dm(re, [q for _, q in term], n)
        else:
            ev = expval_pauli_string_pair_dm(re, im, term, n)
        total = total + float(c) * ev
    return total
