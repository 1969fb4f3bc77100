"""Quantum error correction framework: the counterpart of
``rocquantum_tpu/qec/framework.py``, on this package's ``build`` and
``Circuit.measure`` (on the simulator's device).

Same public surface as reference rocquantum/qec/framework.py (the
QuantumErrorCode / Decoder ABCs and a QEC_Experiment running the
"circuit fragmentation" strategy, :49-89) with a reworked orchestrator:
syndrome extraction is its own reusable step, fragment/ancilla counts are
validated up front (the reference would IndexError on a mismatch), and the
measured probabilities are kept alongside the outcomes.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Tuple

from .. import api as roc_q
from ..api import PauliOperator, QuantumProgram

AnsatzKernel = Callable[..., None]


class QuantumErrorCode(ABC):
    """Blueprint for an error-correcting code."""

    @abstractmethod
    def generate_stabilizer_circuits(
            self, initial_state_kernel: AnsatzKernel, num_qubits: int,
            simulator: roc_q.Simulator) -> List[QuantumProgram]:
        """One circuit fragment per stabilizer measurement."""

    @abstractmethod
    def define_logical_operators(self) -> Dict[str, PauliOperator]:
        """Logical operators of the code."""


class Decoder(ABC):
    """Blueprint for a syndrome decoder."""

    @abstractmethod
    def decode(self, syndrome: List[int]) -> PauliOperator:
        """Map a syndrome to a correction operator."""


class QEC_Experiment:
    """Single-round QEC orchestrator (circuit fragmentation): each
    stabilizer is measured on its own circuit fragment — embarrassingly
    parallel programs sharing one structure-keyed compile cache."""

    def __init__(self, simulator: roc_q.Simulator):
        if not isinstance(simulator, roc_q.Simulator):
            raise TypeError(
                f"QEC_Experiment needs a rocquantum Simulator, got "
                f"{type(simulator).__name__}")
        self.simulator = simulator

    def extract_syndrome(self, code: QuantumErrorCode,
                         initial_state_kernel: AnsatzKernel,
                         num_qubits: int,
                         ancilla_qubit_indices: List[int],
                         ) -> Tuple[List[int], List[float]]:
        """Measure every stabilizer's ancilla; returns (outcomes, probs).

        Each fragment prepares the (possibly corrupted) encoded state,
        entangles one stabilizer's parity onto its ancilla, and collapses
        that ancilla — a mid-circuit measurement on the statevector
        engine, not a full-state readback."""
        fragments = code.generate_stabilizer_circuits(
            initial_state_kernel, num_qubits, self.simulator)
        if len(fragments) != len(ancilla_qubit_indices):
            raise ValueError(
                f"{type(code).__name__} produced {len(fragments)} "
                f"stabilizer fragments but {len(ancilla_qubit_indices)} "
                "ancilla indices were given")
        outcomes, probs = [], []
        for program, ancilla in zip(fragments, ancilla_qubit_indices):
            bit, p = program.circuit_ref.measure(ancilla)
            outcomes.append(bit)
            probs.append(p)
        return outcomes, probs

    def run_single_round(self, code: QuantumErrorCode, decoder: Decoder,
                         initial_state_kernel: AnsatzKernel, num_qubits: int,
                         ancilla_qubit_indices: List[int]) -> Dict[str, Any]:
        """Extract the syndrome, decode it, report the correction."""
        syndrome, probs = self.extract_syndrome(
            code, initial_state_kernel, num_qubits, ancilla_qubit_indices)
        correction = decoder.decode(syndrome)
        return {
            "syndrome": syndrome,
            "syndrome_probs": probs,
            "correction_applied": str(correction),
            "logical_operators": code.define_logical_operators(),
        }
