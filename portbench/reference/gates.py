"""The gates a benchmark circuit may use, by name, as the reference reads
them: a 2x2 matrix on a target, the same matrix under one control, or a
sequence of those.

A circuit is a list of ``(name, qubits, param)``: ``qubits`` a tuple
(``(target,)``, ``(control, target)``, or the two qubits of ``SWAP`` and
``RZZ``), ``param`` an index into the request's angles or None. The names
are those of the program's gate methods, upper-cased; what each gate does
is defined here, by its matrix, and nowhere else.
"""

import math

_ISQ2 = 1 / math.sqrt(2)


def _rx(t):
    c, s = math.cos(t / 2), math.sin(t / 2)
    return ((complex(c), complex(0, -s)), (complex(0, -s), complex(c)))


def _ry(t):
    c, s = math.cos(t / 2), math.sin(t / 2)
    return ((complex(c), complex(-s)), (complex(s), complex(c)))


def _rz(t):
    c, s = math.cos(t / 2), math.sin(t / 2)
    return ((complex(c, -s), 0j), (0j, complex(c, s)))


def _fixed(m):
    return lambda _t: m


_X = ((0j, 1 + 0j), (1 + 0j, 0j))
_Z = ((1 + 0j, 0j), (0j, -1 + 0j))

# one-qubit matrices, of the angle (ignored by the fixed gates)
MATRICES = {
    "X": _fixed(_X),
    "Y": _fixed(((0j, -1j), (1j, 0j))),
    "Z": _fixed(_Z),
    "H": _fixed(((_ISQ2 + 0j, _ISQ2 + 0j), (_ISQ2 + 0j, -_ISQ2 + 0j))),
    "S": _fixed(((1 + 0j, 0j), (0j, 1j))),
    "SDG": _fixed(((1 + 0j, 0j), (0j, -1j))),
    "T": _fixed(((1 + 0j, 0j), (0j, complex(_ISQ2, _ISQ2)))),
    "TDG": _fixed(((1 + 0j, 0j), (0j, complex(_ISQ2, -_ISQ2)))),
    "RX": _rx, "RY": _ry, "RZ": _rz,
}

# controlled gates: (control, target) -> the one-qubit gate on the target
CONTROLLED = {"CX": "X", "CZ": "Z", "CRX": "RX", "CRY": "RY", "CRZ": "RZ"}


def primitives(name, qubits, theta):
    """The gate as ``[(matrix, target, control or None)]``, applied in
    order; ``theta`` is its angle or None."""
    if name in MATRICES:
        (t,) = qubits
        return [(MATRICES[name](theta), t, None)]
    if name in CONTROLLED:
        c, t = qubits
        return [(MATRICES[CONTROLLED[name]](theta), t, c)]
    if name == "SWAP":
        a, b = qubits
        return [(_X, b, a), (_X, a, b), (_X, b, a)]
    if name == "RZZ":  # exp(-i theta/2 Z Z) = CX . RZ(theta) on b . CX
        a, b = qubits
        return [(_X, b, a), (_rz(theta), b, None), (_X, b, a)]
    raise ValueError(f"no reference for gate {name!r}")


def is_real(m):
    return not any(x.imag for row in m for x in row)


def is_diagonal(m):
    return m[0][1] == 0 and m[1][0] == 0


def is_flip(m):
    return m == _X
