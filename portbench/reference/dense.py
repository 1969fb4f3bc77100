"""Dense two-qubit gates for the benchmark's plain reference: torch and
numpy only, nothing of the program under test and nothing of JAX.

A dense gate is a 4x4 complex matrix ``u`` on two qubits ``(a, b)``, with
qubit ``a`` the low bit of its index: ``u[i, j]``, i = bit_a + 2 bit_b, as
Qiskit's ``QuantumCircuit.unitary(u, [a, b])`` takes it. A circuit may name
it ``SU4``: its matrix is :func:`matrix` of the request's draw for it. It
is applied to the float planes of a :class:`statevector.State` in chunks,
as one real 8x8 product a chunk, in the state's dtype (float64 for the
comparison, the control's dtype for the control); every other gate goes
through :mod:`statevector` as before.
"""

import numpy as np
import torch

from portbench.reference import gates as ref_gates
from portbench.reference import statevector as ref

CHUNK = 1 << 22  # amplitude quadruples a product works on


def matrix(draw):
    """The Haar-random SU(4) of one draw (a float): 32 standard normals
    from a generator seeded by the draw's 64 bits, the QR of the complex
    Gaussian matrix they make with the phases of R's diagonal moved into
    Q, divided by a fourth root of its determinant."""
    seed = int(np.float64(draw).view(np.uint64))
    g = np.random.default_rng(np.random.SeedSequence(seed))
    z = g.standard_normal((4, 4)) + 1j * g.standard_normal((4, 4))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    q = q * (d / np.abs(d))
    return q / np.linalg.det(q) ** 0.25


def _real_form(u, dtype, device):
    """The 8x8 real matrix of ``u`` acting on ``[re; im]``."""
    u = np.asarray(u, np.complex128)
    r = np.block([[u.real, -u.imag], [u.imag, u.real]])
    return torch.tensor(r, dtype=dtype, device=device)


def apply(state, u, a, b):
    """The 4x4 ``u`` on local qubits ``a`` (its index's low bit) and
    ``b``, in place."""
    if a == b or max(a, b) >= state.local_bits:
        raise ValueError(f"a dense gate needs two distinct local qubits, "
                         f"got {a}, {b}")
    state.make_complex()
    u = np.asarray(u, np.complex128)
    hi, lo = max(a, b), min(a, b)
    if a == hi:  # index bit 0 = qubit a: swap bits 1 and 2 of u's index
        p = [0, 2, 1, 3]
        u = u[np.ix_(p, p)]
    L = state.local_bits
    shape = (1 << (L - hi - 1), 2, 1 << (hi - lo - 1), 2, 1 << lo)
    # chunks along the largest of the three free axes
    axis = max((0, 2, 4), key=lambda k: shape[k])
    per = max(1, CHUNK * shape[axis] // (shape[0] * shape[2] * shape[4]))
    for blk in state.blocks:
        rm = _real_form(u, state.dtype, blk[0].device)
        views = [p.view(shape) for p in blk]
        for s in range(0, shape[axis], per):
            idx = [slice(None)] * 5
            idx[axis] = slice(s, min(s + per, shape[axis]))
            parts = [v[tuple(idx)] for v in views]
            # rows (re, im) x bit hi x bit lo, the quadruples as columns
            rows = [p.permute(1, 3, 0, 2, 4) for p in parts]
            x = torch.empty((2,) + rows[0].shape, dtype=state.dtype,
                            device=rm.device)
            for k in range(2):
                x[k].copy_(rows[k])
            y = (rm @ x.view(8, -1)).view(x.shape)
            for k in range(2):
                rows[k].copy_(y[k])


def simulate(n, circuit, theta, dtype, devices):
    """:func:`statevector.simulate` with ``SU4`` gates: ``(name, qubits,
    param)``, an ``SU4`` taking :func:`matrix` of ``theta[param]``."""
    state = ref.zero_state(n, dtype, devices)
    for name, qubits, param in circuit:
        angle = None if param is None else float(theta[param])
        if name == "SU4":
            apply(state, matrix(angle), *qubits)
            continue
        for m, t, c in ref_gates.primitives(name, qubits, angle):
            ref.apply(state, m, t, c)
    return state
