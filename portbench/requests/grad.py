"""One optimizer step's value and gradient: the energy of the
configuration's observable and its derivative in every angle, as
PennyLane's ``diff_method="adjoint"`` gives them. The kind owns its
whole request: ``system.gradient``, the port's public ``adjoint_grad``
on the program's side, the plain adjoint reference in the control's
dtype on the control's. Nothing holds a state.

Compared, over the checked requests, against :func:`reference.adjoint.
gradient` in the comparison's dtype (sum_k |c_k| bounds |E| and every
|dE/dtheta| of a Pauli rotation):

- ``energy_err``: the largest |E - E_ref| / sum_k |c_k|;
- ``grad_err``: the largest |g_j - g_ref,j| / sum_k |c_k| over the
  requests and the angles.

An answer of the wrong length, or with a NaN, reads inf.
"""

import numpy as np

from portbench.reference import adjoint

NUMBERS = ("energy_err", "grad_err")


def request(system, theta, cell, traffic):
    return system.gradient(theta, cell.terms)


def compare(cell, traffic, checked, dtype, devices):
    """``checked`` yields ``(answer, theta)`` one request at a time."""
    scale = sum(abs(c) for c, _ in cell.terms)
    energy_err, grad_err = [], []
    for (value, grads), theta in checked:
        grads = np.asarray(grads, np.float64).ravel()
        if grads.shape != theta.shape or not np.isfinite(value) \
                or not np.isfinite(grads).all():
            return {"energy_err": float("inf"), "grad_err": float("inf")}
        want_e, want_g = adjoint.gradient(cell.n, cell.gates, theta,
                                          cell.terms, dtype, devices)
        energy_err.append(abs(float(value) - want_e) / scale)
        grad_err.append(float(np.abs(grads - want_g).max()) / scale)
    return {"energy_err": max(energy_err, default=float("inf")),
            "grad_err": max(grad_err, default=float("inf"))}
