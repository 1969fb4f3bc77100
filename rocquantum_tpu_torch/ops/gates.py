"""Gate matrix library, as host numpy arrays (complex128).

Counterpart of ``rocquantum_tpu/ops/gates.py``. The port builds gate
coefficients on the host from the parameter values and ships them to the
device in one table per kernel pass, so the builders here are numpy.
:func:`gate_matrix_t` is their differentiable torch twin (the JAX package
gets one for free by tracing its builders): the gradient takes dU/dθ from
it, and so does the plain per-op energy of kernels that do host arithmetic
on their parameters. The ``*_parts`` builders (``PARAMETERIZED_PARTS``)
give a parameterized gate as real ``(re, im_or_None)`` torch matrices in
the precision's real dtype, also differentiable.

Matrix convention for multi-target gates: for ``targets=[t0, t1, ...]`` the
row/column index has ``t0`` as the least significant bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config

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
    """``(G, d, d)`` complex128 from rows of ``(G,)`` entries."""
    return torch.stack([torch.stack([e.to(_C128) for e in row], -1)
                        for row in rows], -2)


def _rx_t(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _mat([[c, -1j * s], [-1j * s, c]])


def _ry_t(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _mat([[c, -s], [s, c]])


def _rz_t(theta):
    zero = torch.zeros_like(theta)
    return _mat([[torch.exp(-0.5j * theta), zero],
                 [zero, torch.exp(0.5j * theta)]])


def _phase_t(lam):
    zero = torch.zeros_like(lam)
    return _mat([[torch.ones_like(lam), zero], [zero, torch.exp(1j * lam)]])


def _rzz_t(theta):
    em, ep = torch.exp(-0.5j * theta), torch.exp(0.5j * theta)
    return torch.diag_embed(torch.stack([em, ep, ep, em], -1))


def _u3_t(theta, phi, lam):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _mat([[c, -torch.exp(1j * lam) * s],
                 [torch.exp(1j * phi) * s, torch.exp(1j * (phi + lam)) * c]])


# batched differentiable builders: (G,) float64 angles -> (G, d, d)
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
        return _PARAMETERIZED_T[key](
            *(_angle(p).reshape(1) for p in params))[0]
    raise ValueError(f"Unknown gate name: {name}")


def gate_matrices_t(name: str, params: torch.Tensor) -> torch.Tensor:
    """:func:`gate_matrix_t` of a batch of one parameterized gate:
    ``params`` ``(G, p)`` float64 gives ``(G, d, d)`` complex128,
    differentiable in ``params``."""
    key = name.upper()
    if key not in _PARAMETERIZED_T:
        raise ValueError(f"Unknown parameterized gate name: {name}")
    return _PARAMETERIZED_T[key](*params.unbind(-1))


# -- (re, im) parts (torch, the precision's real dtype) -----------------------

def _real_angle(p) -> torch.Tensor:
    """A parameter as a tensor of the precision's real dtype (kept in
    autograd's graph when it is one)."""
    dtype = config.real_dtype()
    if isinstance(p, torch.Tensor):
        return p.to(dtype)
    return torch.tensor(float(p), dtype=dtype)


def _rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(row) for row in rows])


def rx_parts(theta):
    """(re, im) parts of RX."""
    theta = _real_angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _rows([[c, z], [z, c]]), _rows([[z, -s], [-s, z]])


def ry_parts(theta):
    """(re, None): RY is real."""
    theta = _real_angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _rows([[c, -s], [s, c]]), None


def rz_parts(theta):
    theta = _real_angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _rows([[c, z], [z, c]]), _rows([[-s, z], [z, s]])


def phase_parts(lam):
    lam = _real_angle(lam)
    one, z = torch.ones_like(lam), torch.zeros_like(lam)
    return (_rows([[one, z], [z, torch.cos(lam)]]),
            _rows([[z, z], [z, torch.sin(lam)]]))


def rzz_parts(theta):
    theta = _real_angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return (torch.diag(torch.stack([c, c, c, c])),
            torch.diag(torch.stack([-s, s, s, -s])))


def u3_parts(theta, phi, lam):
    """[[c, -e^{i lam} s], [e^{i phi} s, e^{i (phi+lam)} c]] in parts."""
    theta, phi, lam = (_real_angle(p) for p in (theta, phi, lam))
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    re = _rows([[c, -torch.cos(lam) * s],
                [torch.cos(phi) * s, torch.cos(phi + lam) * c]])
    im = _rows([[z, -torch.sin(lam) * s],
                [torch.sin(phi) * s, torch.sin(phi + lam) * c]])
    return re, im


# (re, im)-part builders of the parameterized gates; im=None marks a real
# matrix
PARAMETERIZED_PARTS = {
    "RX": rx_parts, "RY": ry_parts, "RZ": rz_parts, "P": phase_parts,
    "PHASE": phase_parts, "U3": u3_parts, "RZZ": rzz_parts,
}
