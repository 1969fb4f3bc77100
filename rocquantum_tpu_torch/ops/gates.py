"""Gate matrix library, as host numpy arrays (complex128).

Counterpart of ``rocquantum_tpu/ops/gates.py``. The port builds gate
coefficients on the host from the parameter values and ships them to the
device in one table per kernel pass, so the builders here are numpy.
:func:`gate_matrix_t` is their differentiable torch twin (the JAX package
gets one for free by tracing its builders): the gradient takes dU/dθ from
it, and so does the plain per-op energy of kernels that do host arithmetic
on their parameters.

Matrix convention for multi-target gates: for ``targets=[t0, t1, ...]`` the
row/column index has ``t0`` as the least significant bit.
"""

from __future__ import annotations

import numpy as np
import torch

_SQRT1_2 = 1.0 / np.sqrt(2.0)

I = np.eye(2, dtype=np.complex128)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H = np.array([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]],
             dtype=np.complex128)
S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
SDG = np.array([[1, 0], [0, -1j]], dtype=np.complex128)
T = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex128)
TDG = np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]], dtype=np.complex128)
SWAP = np.array([[1, 0, 0, 0],
                 [0, 0, 1, 0],
                 [0, 1, 0, 0],
                 [0, 0, 0, 1]], dtype=np.complex128)

PAULI = {"I": I, "X": X, "Y": Y, "Z": Z}


def rx(theta) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry(theta) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz(theta) -> np.ndarray:
    return np.diag([np.exp(-0.5j * theta),
                    np.exp(0.5j * theta)]).astype(np.complex128)


def phase(lam) -> np.ndarray:
    return np.diag([1.0, np.exp(1j * lam)]).astype(np.complex128)


def rzz(theta) -> np.ndarray:
    """exp(-i theta/2 Z@Z); the diagonal is [e^-, e^+, e^+, e^-] over
    (b1, b0)."""
    em, ep = np.exp(-0.5j * theta), np.exp(0.5j * theta)
    return np.diag([em, ep, ep, em]).astype(np.complex128)


def u3(theta, phi, lam) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -np.exp(1j * lam) * s],
                     [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c]],
                    dtype=np.complex128)


FIXED = {
    "I": I, "X": X, "Y": Y, "Z": Z, "H": H, "S": S, "SDG": SDG,
    "T": T, "TDG": TDG, "SWAP": SWAP,
}

PARAMETERIZED = {
    "RX": rx, "RY": ry, "RZ": rz, "P": phase, "PHASE": phase, "U3": u3,
    "RZZ": rzz,
}


def gate_matrix(name: str, params=()) -> np.ndarray:
    """The unitary of a named gate (its uncontrolled part)."""
    key = name.upper()
    if key in FIXED:
        return FIXED[key]
    if key in PARAMETERIZED:
        return PARAMETERIZED[key](*(float(p) for p in params))
    raise ValueError(f"Unknown gate name: {name}")


def is_parameterized(name: str) -> bool:
    return name.upper() in PARAMETERIZED


# -- differentiable twin (torch, complex128) ----------------------------------

_C128 = torch.complex128


def _angle(p) -> torch.Tensor:
    """A parameter as a float64 tensor (kept in autograd's graph when it
    is one)."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.float64)
    return torch.tensor(float(p), dtype=torch.float64)


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack([torch.as_tensor(e).to(_C128)
                                     for e in row]) for row in rows])


def _rx_t(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _mat([[c, -1j * s], [-1j * s, c]])


def _ry_t(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _mat([[c, -s], [s, c]])


def _rz_t(theta):
    zero = torch.zeros((), dtype=_C128)
    return _mat([[torch.exp(-0.5j * theta), zero],
                 [zero, torch.exp(0.5j * theta)]])


def _phase_t(lam):
    zero = torch.zeros((), dtype=_C128)
    return _mat([[torch.ones((), dtype=_C128), zero],
                 [zero, torch.exp(1j * lam)]])


def _rzz_t(theta):
    em, ep = torch.exp(-0.5j * theta), torch.exp(0.5j * theta)
    return torch.diag(torch.stack([em, ep, ep, em]))


def _u3_t(theta, phi, lam):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _mat([[c, -torch.exp(1j * lam) * s],
                 [torch.exp(1j * phi) * s, torch.exp(1j * (phi + lam)) * c]])


_PARAMETERIZED_T = {
    "RX": _rx_t, "RY": _ry_t, "RZ": _rz_t, "P": _phase_t, "PHASE": _phase_t,
    "U3": _u3_t, "RZZ": _rzz_t,
}


def gate_matrix_t(name: str, params=()) -> torch.Tensor:
    """:func:`gate_matrix` as a complex128 CPU tensor, differentiable in
    ``params`` (floats or tensors)."""
    key = name.upper()
    if key in FIXED:
        return torch.from_numpy(FIXED[key])
    if key in _PARAMETERIZED_T:
        return _PARAMETERIZED_T[key](*(_angle(p) for p in params))
    raise ValueError(f"Unknown gate name: {name}")
