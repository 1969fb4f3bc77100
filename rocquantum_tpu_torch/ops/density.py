"""Density-matrix host half: Kraus channels, superoperators and their
factoring into fused-kernel gate kinds.

Counterpart of the numpy half of ``rocquantum_tpu/ops/density.py`` (that
module imports jax, so the port keeps its own copy). The density engine
holds rho as the flattened ``2^n x 2^n`` matrix, a ``(4^n,)`` vector with
the ROW (ket) index in the HIGH n bits: rho is a 2n-qubit state, ``U rho
U†`` applies ``U`` at the row bits ``q + n`` and ``conj(U)`` at the column
bits ``q``, and a channel is one superoperator ``S = sum_i K_i (x)
conj(K_i)`` on the bit pair ``(q, q + n)``. The port carries rho as float
planes ``(re, im_or_None)`` like a state vector (ops/pairdm.py reads them
out); :func:`superop_kernel_ops` lowers a one-qubit channel to the gate
kinds the fused kernels take, so a noise layer fuses into the passes of
the gates around it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..compiler.ir import GateOp
from . import gates as _g


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
    """rho = |psi><psi| as flat planes ``(re, im_or_None)`` of the
    ``(4^n,)`` view, row index high, from a state's planes (``im`` None
    for a real state, which gives a real rho)."""
    if im is None:
        return torch.outer(re, re).reshape(-1), None
    rho_re = torch.outer(re, re) + torch.outer(im, im)
    rho_im = torch.outer(im, re) - torch.outer(re, im)
    return rho_re.reshape(-1), rho_im.reshape(-1)
