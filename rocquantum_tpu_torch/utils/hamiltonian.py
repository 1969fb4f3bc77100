"""Hamiltonian expectation helpers for density-matrix states (a copy of
``rocquantum_tpu/utils/hamiltonian.py`` over this package's
DensityMatrixState).

API-parity rebuild of reference rocquantum/utils/hamiltonian.py: the
reference rotated the state into the Z basis with S†/H gates, measured the
Z-product, and rotated back (:10-61 — mutate-and-restore); here the Pauli
string is measured directly as Tr(P rho) in one pass, same math, no state
mutation.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Tuple

if TYPE_CHECKING:  # utils/ is imported while the package's api loads
    from ..density_state import DensityMatrixState


def _parse_string(pauli_string: str) -> List[Tuple[str, int]]:
    """'IXYZ' positional form: character i acts on qubit i."""
    if len(pauli_string) > 64:
        raise ValueError("Pauli string is too long.")
    ops = []
    for i, pauli_op in enumerate(pauli_string):
        if pauli_op == "I":
            continue
        if pauli_op not in "XYZ":
            raise ValueError(
                f"Invalid Pauli operator '{pauli_op}' in string.")
        ops.append((pauli_op, i))
    return ops


def _compute_pauli_string_expectation(state: DensityMatrixState,
                                      pauli_string: str) -> float:
    ops = _parse_string(pauli_string)
    if not ops:
        return 1.0
    return state.compute_pauli_string_expectation(ops)


def compute_hamiltonian_expectation(
        hamiltonian: List[Tuple[str, float]],
        state: DensityMatrixState) -> float:
    """Total <H> for H given as [(pauli_string, coefficient), ...]
    (reference hamiltonian.py:63-85)."""
    total_energy = 0.0
    for pauli_string, coefficient in hamiltonian:
        term = _compute_pauli_string_expectation(state, pauli_string)
        total_energy += coefficient * term
    return total_energy
