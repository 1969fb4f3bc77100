"""3-qubit bit-flip repetition code.

API-parity rebuild of reference rocquantum/qec/codes/repetition_code.py:
data qubits 0-2, ancillas 3-4; Z0Z1 / Z1Z2 stabilizers measured via
H-CX-CX-H on the ancilla (:27-67).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ... import api as roc_q
from ...api import PauliOperator, QuantumProgram
from ..framework import QuantumErrorCode

AnsatzKernel = Callable[..., None]


class ThreeQubitRepetitionCode(QuantumErrorCode):
    """Bit-flip repetition code: data qubits 0,1,2; ancillas 3,4."""

    def generate_stabilizer_circuits(
            self, initial_state_kernel: AnsatzKernel, num_qubits: int,
            simulator: roc_q.Simulator) -> List[QuantumProgram]:
        base = getattr(initial_state_kernel, "__wrapped__",
                       initial_state_kernel)
        programs = []

        # NB: the reference wrapped the parity CNOTs in H gates on the
        # ancilla (repetition_code.py:40-44, :53-57). With the data qubits
        # as CNOT controls that circuit measures nothing (the ancilla ends
        # in |0> for every data state — X|+> = |+>), so every syndrome reads
        # 0. The correct Z-stabilizer parity circuit is CX(data->ancilla)
        # without the H's (SURVEY §7: reference bugs are not spec).
        @roc_q.kernel
        def z0z1_stabilizer_kernel(q):
            base(q)
            q.cx(0, 3)
            q.cx(1, 3)

        programs.append(roc_q.build(z0z1_stabilizer_kernel, num_qubits,
                                    simulator))

        @roc_q.kernel
        def z1z2_stabilizer_kernel(q):
            base(q)
            q.cx(1, 4)
            q.cx(2, 4)

        programs.append(roc_q.build(z1z2_stabilizer_kernel, num_qubits,
                                    simulator))
        return programs

    def define_logical_operators(self) -> Dict[str, PauliOperator]:
        return {
            "logical_Z": PauliOperator({"Z0": 1.0}),
            "logical_X": PauliOperator({"X0 X1 X2": 1.0}),
        }
