"""Density-matrix engine: Kraus channels, superoperators and their
factoring into fused-kernel gate kinds, and the flat complex-rho API.

Counterpart of ``rocquantum_tpu/ops/density.py`` (that module imports jax,
so the port keeps its own copy). The density engine holds rho as the
flattened ``2^n x 2^n`` matrix, a ``(4^n,)`` vector with the ROW (ket)
index in the HIGH n bits: rho is a 2n-qubit state, ``U rho U†`` applies
``U`` at the row bits ``q + n`` and ``conj(U)`` at the column bits ``q``,
and a channel is one superoperator ``S = sum_i K_i (x) conj(K_i)`` on the
bit pair ``(q, q + n)``.

- The host half: :func:`superop_kernel_ops` lowers a one-qubit channel to
  the gate kinds the fused kernels take, so a noise layer of
  ``DensityCircuit`` fuses into the passes of the gates around it
  (``DensityCircuit`` carries rho as float planes ``(re, im_or_None)``,
  which ops/pairdm.py reads out).
- The flat complex-rho API (hipDensityMat's functional surface, reference
  hipDensityMat.cpp): :func:`init_density`, :func:`apply_matrix_dm`,
  :func:`apply_gate_dm`, :func:`apply_kraus`, :func:`apply_channel` and the
  readouts take and return one flat complex tensor, complex64 under
  ``"single"`` and complex128 under ``"double"``, on the tensor's own
  device. They run in plain torch on ``statevec.apply_matrix`` (the JAX
  package runs them as plain XLA; ``DensityCircuit`` is the kernel path of
  noisy circuits). Readouts sum in float64 and return float64 tensors;
  draws are int32 from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..compiler.ir import GateOp
from . import gates as _g
from . import statevec as sv


def kraus_superoperator(kraus_ops: List) -> np.ndarray:
    """S = sum_i K_i (x) conj(K_i): the channel as one ``(4^m, 4^m)``
    complex128 matrix on the flattened rho's (row, col) index pair, row
    index high: ``rho'[r', c'] = sum_i K_i[r', r] conj(K_i)[c', c]
    rho[r, c]``."""
    s = None
    for k in kraus_ops:
        k = np.asarray(k, np.complex128)
        term = np.kron(k, np.conj(k))
        s = term if s is None else s + term
    return s


_CNOT01 = np.zeros((4, 4))
_CNOT01[[0, 3, 2, 1], [0, 1, 2, 3]] = 1.0  # ctrl = bit0, tgt = bit1


def superop_kernel_ops(s, q: int, qn: int) -> Optional[List[GateOp]]:
    """Factor a one-qubit channel's superoperator S (4x4 on the flat bits
    ``(q, qn)``, q the least significant) into fused-kernel ops:

        S = C . (|0><0|_qn (x) A0  +  |1><1|_qn (x) A1) . C,
        C = CNOT(ctrl=q, tgt=qn)

    which lowers to ``[CNOT, U(q, A0), CU(qn -> q, A1 A0^-1), CNOT]``. A
    diagonal S (the phase-flip family) is one ``D2M`` diagonal on ``(q,
    qn)``; an S of operator-Schmidt rank 1 (a unitary channel) is two plain
    ``U`` ops. Returns None when S does not factor (the caller applies it
    as one dense 4x4)."""
    s = np.asarray(s, np.complex128)
    if s.shape != (4, 4):
        return None
    if np.allclose(s, np.diag(np.diag(s)), atol=1e-14):
        v = np.diag(s)
        return [GateOp("D2M", (q, qn), (), (),
                       np.array([[v[0], v[2]], [v[1], v[3]]]))]
    m = s.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    u_, sig, vt = np.linalg.svd(m)
    if sig[1] < 1e-12 * max(sig[0], 1e-30):
        a = u_[:, 0].reshape(2, 2) * np.sqrt(sig[0])
        b = vt[0].reshape(2, 2) * np.sqrt(sig[0])
        return [GateOp("UNITARY", (q,), (), (), b),
                GateOp("UNITARY", (qn,), (), (), a)]
    sp = _CNOT01 @ s @ _CNOT01
    scale = max(np.max(np.abs(sp)), 1e-30)
    eq, df = np.ix_([0, 1], [0, 1]), np.ix_([2, 3], [2, 3])
    off = max(np.max(np.abs(sp[np.ix_([0, 1], [2, 3])])),
              np.max(np.abs(sp[np.ix_([2, 3], [0, 1])])))
    if off > 1e-12 * scale:
        return None
    a0, a1 = sp[eq], sp[df]
    cnot = GateOp("X", (qn,), (q,))
    ops = [cnot]
    if not np.allclose(a0, np.eye(2), atol=1e-14):
        ops.append(GateOp("UNITARY", (q,), (), (), a0))
    if not np.allclose(a1, a0, atol=1e-14):
        det = np.linalg.det(a0)
        if abs(det) < 1e-6 * scale * scale:
            return None  # A0 not invertible: keep the dense superop
        b = a1 @ np.linalg.inv(a0)
        ops.append(GateOp("UNITARY", (q,), (qn,), (), b))
    ops.append(cnot)
    return ops


def _chan(mats):
    return [np.asarray(m, dtype=np.complex128) for m in mats]


def bit_flip_kraus(p: float):
    return _chan([np.sqrt(1 - p) * _g.I, np.sqrt(p) * _g.X])


def phase_flip_kraus(p: float):
    return _chan([np.sqrt(1 - p) * _g.I, np.sqrt(p) * _g.Z])


def depolarizing_kraus(p: float):
    """sqrt(1-p) I and sqrt(p/3) X, Y, Z: each Bloch component shrinks by
    1 - 4p/3."""
    return _chan([np.sqrt(1 - p) * _g.I, np.sqrt(p / 3) * _g.X,
                  np.sqrt(p / 3) * _g.Y, np.sqrt(p / 3) * _g.Z])


def amplitude_damping_kraus(gamma: float):
    """K0 = diag(1, sqrt(1-gamma)), K1 = sqrt(gamma) sigma+."""
    k0 = np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=np.complex128)
    k1 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=np.complex128)
    return [k0, k1]


CHANNELS = {
    "bit_flip": bit_flip_kraus,
    "phase_flip": phase_flip_kraus,
    "depolarizing": depolarizing_kraus,
    "amplitude_damping": amplitude_damping_kraus,
}


def channel_kraus(channel_type: str, prob: float):
    """The Kraus operators of a named one-qubit channel."""
    try:
        return CHANNELS[channel_type.lower()](prob)
    except KeyError:
        raise ValueError(f"Unknown noise channel: {channel_type!r}. "
                         f"Supported: {sorted(CHANNELS)}") from None


def from_statevector(re: torch.Tensor, im: Optional[torch.Tensor] = None):
    """rho = |psi><psi|. Given one complex state (the JAX package's
    signature), the flat complex rho. Given a state's float planes ``(re,
    im_or_None)``, rho as flat planes ``(re, im_or_None)`` of the ``(4^n,)``
    view, row index high (``im`` None for a real state, which gives a real
    rho)."""
    if re.is_complex():
        if im is not None:
            raise ValueError("a complex state takes no imaginary plane")
        return torch.outer(re, re.conj()).reshape(-1)
    if im is None:
        return torch.outer(re, re).reshape(-1), None
    rho_re = torch.outer(re, re) + torch.outer(im, im)
    rho_im = torch.outer(im, re) - torch.outer(re, im)
    return rho_re.reshape(-1), rho_im.reshape(-1)


# -- the flat complex-rho API -------------------------------------------------

def num_qubits_of(rho: torch.Tensor) -> int:
    """n of a flat ``(4^n,)`` rho or its ``(2^n, 2^n)`` matrix."""
    size = rho.shape[-1] if rho.dim() == 1 \
        else rho.shape[-1] * rho.shape[-2]
    n2 = size.bit_length() - 1
    if (1 << n2) != size or n2 % 2:
        raise ValueError(f"density matrix size {size} is not 4**n")
    return n2 // 2


def init_density(num_qubits: int, dtype=None, device=None) -> torch.Tensor:
    """|0...0><0...0| as a flat complex tensor (``dtype`` defaults to the
    precision's complex type, ``device`` to the card)."""
    return sv.basis_state(2 * num_qubits, 0, dtype, device)


def to_matrix(rho: torch.Tensor) -> torch.Tensor:
    """The ``(2^n, 2^n)`` matrix view of a flat rho."""
    n = num_qubits_of(rho)
    return rho.reshape(1 << n, 1 << n)


def from_matrix(mat: torch.Tensor) -> torch.Tensor:
    return mat.reshape(-1)


def _matrix_on(rho: torch.Tensor, matrix) -> torch.Tensor:
    return torch.as_tensor(matrix, dtype=rho.dtype, device=rho.device)


def apply_matrix_dm(rho: torch.Tensor, matrix,
                    targets: Sequence[int]) -> torch.Tensor:
    """rho' = U rho U† (ideal-gate path, hipDensityMat.cpp:714-983)."""
    n = num_qubits_of(rho)
    matrix = _matrix_on(rho, matrix)
    rho = sv.apply_matrix(rho, matrix, [t + n for t in targets])
    return sv.apply_matrix(rho, matrix.conj().resolve_conj(), list(targets))


def apply_controlled_matrix_dm(rho: torch.Tensor, matrix,
                               controls: Sequence[int],
                               targets: Sequence[int]) -> torch.Tensor:
    """Controlled-U on rho: U where every control is 1, on the row bits,
    and conj(U) likewise on the column bits (hipDensityMat.cpp:837-983)."""
    n = num_qubits_of(rho)
    matrix = _matrix_on(rho, matrix)
    rho = sv.apply_controlled_matrix(rho, matrix, [c + n for c in controls],
                                     [t + n for t in targets])
    return sv.apply_controlled_matrix(rho, matrix.conj().resolve_conj(),
                                      list(controls), list(targets))


def apply_gate_dm(rho: torch.Tensor, name: str, targets: Sequence[int],
                  controls: Sequence[int] = (), params: Sequence = (),
                  adjoint: bool = False) -> torch.Tensor:
    """A named gate on rho; controlled names (CNOT, CZ, CRX, ..., CSWAP)
    without ``controls`` take theirs from the front of ``targets``
    (py_hip_density_mat.cpp:44-64)."""
    op = GateOp(name.upper(), tuple(targets), tuple(controls),
                tuple(float(p) for p in params), is_adjoint=adjoint)
    return pairdm.apply_op_dm(rho, op, num_qubits_of(rho))


def apply_kraus_at(rho2n: torch.Tensor, kraus_ops: List,
                   row_pos: Sequence[int],
                   col_pos: Sequence[int]) -> torch.Tensor:
    """rho' = sum_i K_i rho K_i† with the row and column qubits at the flat
    bits ``row_pos`` and ``col_pos`` of the 2n-bit view (anywhere, as after
    a relabel): one dense superoperator for one or two qubits, per Kraus
    term from three on, where the superoperator would be a 4^m x 4^m
    matrix (the JAX package keeps the superoperator up to three targets,
    ``_MAX_SUPEROP_TARGETS``, a limit of the TPU compiler)."""
    row_pos, col_pos = list(row_pos), list(col_pos)
    if len(row_pos) >= 3:
        acc = None
        for k in kraus_ops:
            k = np.asarray(k, np.complex128)
            term = sv.apply_matrix(rho2n, k, row_pos)
            term = sv.apply_matrix(term, np.conj(k), col_pos)
            acc = term if acc is None else acc + term
        return acc
    return sv.apply_matrix(rho2n, kraus_superoperator(kraus_ops),
                           col_pos + row_pos)


def apply_kraus(rho: torch.Tensor, kraus_ops: List,
                targets: Sequence[int]) -> torch.Tensor:
    """rho' = sum_i K_i rho K_i† on logical qubits (the generic channel
    entry, hipDensityMatApplyChannel, hipDensityMat.cpp:984), through
    :func:`apply_kraus_at`."""
    n = num_qubits_of(rho)
    return apply_kraus_at(rho, kraus_ops, [t + n for t in targets],
                          list(targets))


def apply_channel(rho: torch.Tensor, channel_type: str, prob: float,
                  targets: Sequence[int]) -> torch.Tensor:
    """A named one-qubit channel on each target qubit."""
    kraus = channel_kraus(channel_type, prob)
    for t in targets:
        rho = apply_kraus(rho, kraus, [t])
    return rho


def probabilities_dm(rho: torch.Tensor) -> torch.Tensor:
    """diag(rho), the computational-basis probabilities, as float64."""
    return pairdm.probabilities_pair_dm(rho.real, num_qubits_of(rho))


def trace_dm(rho: torch.Tensor) -> torch.Tensor:
    return pairdm.trace_pair_dm(rho.real, num_qubits_of(rho))


def purity(rho: torch.Tensor) -> torch.Tensor:
    """Tr(rho^2) = sum_ij |rho_ij|^2 for a Hermitian rho (the JAX
    package's single-precision purity sums Re(rho_ij^2), which is not
    Tr(rho^2) once rho has imaginary entries)."""
    return pairdm.purity_pair_dm(rho.real, rho.imag)


def marginal_probs_dm(rho: torch.Tensor,
                      qubits: Sequence[int]) -> torch.Tensor:
    """Marginal of diag(rho) over ``qubits`` (qubits[0] the least
    significant bit of the outcome index)."""
    return pairdm.marginal_probs_pair_dm(rho.real, qubits,
                                         num_qubits_of(rho))


def sample_dm(rho: torch.Tensor, qubits: Sequence[int], shots: int,
              generator: torch.Generator) -> torch.Tensor:
    """``shots`` int32 outcomes over ``qubits`` from diag(rho)."""
    return pairdm.sample_pair_dm(rho.real, qubits, shots, generator)


def prob_one_dm(rho: torch.Tensor, qubit: int) -> torch.Tensor:
    return pairdm.prob_one_pair_dm(rho.real, qubit, num_qubits_of(rho))


def collapse_dm(rho: torch.Tensor, qubit: int, outcome: int) -> torch.Tensor:
    """Project rho onto qubit = outcome and renormalize by the trace."""
    return torch.complex(*pairdm.collapse_pair_dm(
        rho.real, rho.imag, qubit, outcome, num_qubits_of(rho)))


def expval_z_dm(rho: torch.Tensor, qubit: int) -> torch.Tensor:
    """Tr(Z_q rho) (hipDensityMat.cpp:77-131, :447)."""
    return 1.0 - 2.0 * prob_one_dm(rho, qubit)


def expval_pauli_product_z_dm(rho: torch.Tensor,
                              qubits: Sequence[int]) -> torch.Tensor:
    """Tr((Z...Z) rho) from the parity-signed diagonal
    (hipDensityMat.cpp:514-613)."""
    return pairdm.expval_pauli_product_z_pair_dm(rho.real, qubits,
                                                 num_qubits_of(rho))


def expval_pauli_string_dm(rho: torch.Tensor,
                           ops: Sequence[tuple]) -> torch.Tensor:
    """Tr(P rho) for a Pauli string ``[(char, qubit), ...]``, from the 2^n
    entries ``rho[r ^ f, r]`` it needs."""
    return pairdm.expval_pauli_string_pair_dm(rho.real, rho.imag, ops,
                                              num_qubits_of(rho))


# imported last: pairdm imports this module's channels at its top
from . import pairdm  # noqa: E402
