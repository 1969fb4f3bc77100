"""Plain adjoint differentiation of a benchmark circuit's energy: the
reference a gradient request is held to.

It imports torch, numpy and the benchmark's own reference alone: nothing
of the program under test and nothing of JAX. The forward pass is
:func:`statevector.simulate`; ``bra = H psi`` is built term by term from
the Pauli strings; then, last gate first,

    ket   <- U_k^dagger ket
    g_k   += 2 Re <bra| dU_k/dtheta |ket>
    bra   <- U_k^dagger bra

with every operation in the state's dtype, so the same code run in a
lower precision is the benchmark's control. Every parameterized gate of
:mod:`gates` is a rotation R(t) = exp(-i t P / 2) on one of its
primitives (the one whose matrix moves with the angle), whose derivative
is R(t + pi) / 2; gates that share a parameter add into its entry.
"""

import math

import numpy as np
import torch

from portbench.reference import gates as ref_gates
from portbench.reference import statevector as sv

ROTATIONS = {"RX", "RY", "RZ", "CRX", "CRY", "CRZ", "RZZ"}


def dagger(m):
    """The conjugate transpose of a 2x2 matrix of nested tuples."""
    return tuple(tuple(m[c][r].conjugate() for c in range(2))
                 for r in range(2))


def _copy(state):
    return sv.State(state.n, [[None if p is None else p.clone() for p in blk]
                              for blk in state.blocks], state.dtype)


def _add(dst, coeff, src):
    """In place: ``dst <- dst + coeff src`` for a real ``coeff``."""
    for d, s in zip(dst.blocks, src.blocks):
        for k in range(2):
            if s[k] is None:
                continue
            if d[k] is None:
                d[k] = torch.zeros_like(s[k])
            d[k].add_(s[k], alpha=coeff)


def hamiltonian_times(state, terms):
    """``H psi`` for ``terms`` (``(coeff, ((pauli, qubit), ...))``), one
    Pauli string at a time on a copy of ``psi``."""
    out = sv.State(state.n, [[torch.zeros_like(blk[0]), None]
                             for blk in state.blocks], state.dtype)
    for coeff, term in terms:
        phi = _copy(state)
        for pauli, q in term:
            sv.apply(phi, ref_gates.MATRICES[pauli](None), q)
        _add(out, coeff, phi)
        del phi
    return out


def _dot(x, y, dtype):
    return float((x * y).sum(dtype=dtype))


def real_inner(a, b):
    """Re <a|b>, summed in the states' dtype."""
    total = 0.0
    for pa, pb in zip(a.blocks, b.blocks):
        for x, y in zip(pa, pb):
            if x is not None and y is not None:
                total += _dot(x, y, a.dtype)
    return total


def expectation(bra, m, ket, t, c=None):
    """Re <bra| m on qubit ``t`` (where qubit ``c``, if given, is 1, and
    nothing elsewhere) |ket>, for any 2x2 ``m``: sum over a, b of Re(m_ab
    conj(bra_a) ket_b), with conj(x) y = (xr yr + xi yi) + i (xr yi -
    xi yr)."""
    L = ket.local_bits
    halves = [[(None, None) if p is None else sv._part(p, L, t, c)
               for p in s.blocks[0]] for s in (bra, ket)]
    (br, bi), (kr, ki) = halves
    total = 0.0
    for a in range(2):
        for b in range(2):
            re, im = m[a][b].real, m[a][b].imag
            if re:
                total += re * _dot(br[a], kr[b], ket.dtype)
                if bi[a] is not None and ki[b] is not None:
                    total += re * _dot(bi[a], ki[b], ket.dtype)
            if im:
                if ki[b] is not None:
                    total -= im * _dot(br[a], ki[b], ket.dtype)
                if bi[a] is not None:
                    total += im * _dot(bi[a], kr[b], ket.dtype)
    return total


def gradient(n, gates, theta, terms, dtype, devices):
    """``(energy, grads)`` of ``sum_k c_k <psi(theta)| P_k |psi(theta)>``
    for the circuit ``gates`` (``(name, qubits, param)``): the energy a
    float, the gradient a float64 numpy array as long as ``theta``. One
    device's block only."""
    if len(devices) != 1:
        raise ValueError(f"the adjoint reference runs on one device, not "
                         f"{len(devices)}")
    ket = sv.simulate(n, gates, theta, dtype, devices)
    bra = hamiltonian_times(ket, terms)
    energy = real_inner(ket, bra)
    grads = np.zeros(len(theta), np.float64)
    for name, qubits, param in reversed(gates):
        angle = None if param is None else float(theta[param])
        prims = ref_gates.primitives(name, qubits, angle)
        moving = [False] * len(prims)
        if param is not None:
            if name not in ROTATIONS:
                raise ValueError(f"no derivative of gate {name!r}")
            shifted = ref_gates.primitives(name, qubits, angle + math.pi)
            moving = [p[0] != s[0] for p, s in zip(prims, shifted)]
        for k in reversed(range(len(prims))):
            m, t, c = prims[k]
            inverse = dagger(m)
            sv.apply(ket, inverse, t, c)
            if moving[k]:
                half = tuple(tuple(x / 2 for x in row)
                             for row in shifted[k][0])
                grads[param] += 2 * expectation(bra, half, ket, t, c)
            sv.apply(bra, inverse, t, c)
    return energy, grads
