"""DensityMatrixState: the ``rocq_hip`` binding surface of the density
engine, on :class:`DensityCircuit`.

Counterpart of ``rocquantum_tpu/density_state.py`` (the reference's
py_hip_density_mat.cpp: ``apply_gate(matrix, qubit, adjoint)``,
``apply_cnot``, ``apply_controlled_gate``, ``compute_expectation``,
``_compute_z_product_expectation``, the channels; the ``Pauli`` enum).
Operations queue on a DensityCircuit and run at the next readout, so they
take its engines: the fused kernels in single precision and in df64, the
exact engine under ``set_precision("double")``.
"""

from __future__ import annotations

import enum
from typing import Sequence

import numpy as np

from .api import Simulator
from .density_circuit import DensityCircuit
from .ops import pairdm


class Pauli(enum.Enum):
    I = "I"
    X = "X"
    Y = "Y"
    Z = "Z"


def _qubit_list(qubits):
    return [qubits] if isinstance(qubits, int) else list(qubits)


def _matrix(matrix) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(matrix), np.complex128)


class DensityMatrixState:
    """n-qubit density matrix with an eager-looking, queued API on
    ``device`` (default: the current CUDA device; pass ``device="cpu"``
    for the CPU)."""

    def __init__(self, num_qubits: int, device=None):
        if num_qubits <= 0:
            raise ValueError("num_qubits must be positive")
        self.num_qubits = num_qubits
        self._circ = DensityCircuit(num_qubits, Simulator(device=device))

    # -- binding-parity API --------------------------------------------------

    def apply_gate(self, matrix: np.ndarray, qubit: int,
                   adjoint: bool = False):
        self._circ._enqueue("UNITARY", [qubit], matrix=_matrix(matrix),
                            is_adjoint=adjoint)

    def apply_matrix(self, matrix: np.ndarray, qubits: Sequence[int]):
        self._circ._enqueue("UNITARY", list(qubits), matrix=_matrix(matrix))

    def apply_cnot(self, control: int, target: int):
        self._circ._enqueue("CNOT", [target], controls=[control])

    def apply_controlled_gate(self, matrix: np.ndarray, control: int,
                              target: int):
        self._circ._enqueue("UNITARY", [target], controls=[control],
                            matrix=_matrix(matrix))

    def apply_h(self, qubit: int):
        self._circ._enqueue("H", [qubit])

    def apply_x(self, qubit: int):
        self._circ._enqueue("X", [qubit])

    def apply_y(self, qubit: int):
        self._circ._enqueue("Y", [qubit])

    def apply_z(self, qubit: int):
        self._circ._enqueue("Z", [qubit])

    def apply_ry(self, theta: float, qubit: int):
        self._circ._enqueue("RY", [qubit], params=[theta])

    def apply_rz(self, phi: float, qubit: int):
        self._circ._enqueue("RZ", [qubit], params=[phi])

    def apply_bit_flip_channel(self, qubits, prob: float):
        self._circ.apply_channel("bit_flip", prob, _qubit_list(qubits))

    def apply_phase_flip_channel(self, qubits, prob: float):
        self._circ.apply_channel("phase_flip", prob, _qubit_list(qubits))

    def apply_depolarizing_channel(self, qubits, prob: float):
        self._circ.apply_channel("depolarizing", prob, _qubit_list(qubits))

    def apply_amplitude_damping_channel(self, qubits, gamma: float):
        self._circ.apply_channel("amplitude_damping", gamma,
                                 _qubit_list(qubits))

    def _rho(self):
        return self._circ.state

    def compute_expectation(self, pauli: "Pauli | str", qubit: int) -> float:
        """<P_q> = Tr(P_q rho)."""
        p = pauli.value if isinstance(pauli, Pauli) else str(pauli).upper()
        re, im = self._rho()
        if p == "I":
            return float(pairdm.trace_pair_dm(re, self.num_qubits))
        return float(pairdm.expval_pauli_string_pair_dm(
            re, im, ((p, qubit),), self.num_qubits))

    def _compute_z_product_expectation(self, z_indices: Sequence[int]
                                       ) -> float:
        re, _ = self._rho()
        return float(pairdm.expval_pauli_product_z_pair_dm(
            re, tuple(z_indices), self.num_qubits))

    def compute_pauli_string_expectation(self, ops: Sequence[tuple]) -> float:
        re, im = self._rho()
        return float(pairdm.expval_pauli_string_pair_dm(
            re, im, tuple(ops), self.num_qubits))

    def get_density_matrix(self) -> np.ndarray:
        return self._circ.get_density_matrix()
