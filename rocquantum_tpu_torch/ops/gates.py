"""Gate matrix library, as host numpy arrays (complex128).

Counterpart of ``rocquantum_tpu/ops/gates.py``. The port builds gate
coefficients on the host from the parameter values and ships them to the
device in one table per kernel pass, so the builders here are numpy.

Matrix convention for multi-target gates: for ``targets=[t0, t1, ...]`` the
row/column index has ``t0`` as the least significant bit.
"""

from __future__ import annotations

import numpy as np

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
