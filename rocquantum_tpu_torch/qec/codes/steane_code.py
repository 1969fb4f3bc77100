"""Steane [[7,1,3]] code — X and Z errors both correctable.

Goes beyond the reference's QEC catalog (it shipped only the 3-qubit
repetition code, rocquantum/qec/codes/repetition_code.py) while staying on
the same framework ABCs: data qubits 0-6, one ancilla per stabilizer
(7-12). The check supports follow the Hamming(7,4) parity matrix — qubit i
(1-indexed) participates in check j iff bit j of i is set — so a single
error's syndrome reads the error position in binary.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ... import api as roc_q
from ...api import PauliOperator, QuantumProgram
from ..framework import QuantumErrorCode

AnsatzKernel = Callable[..., None]

# Hamming supports (0-indexed data qubits): check j covers qubits whose
# 1-indexed label has bit j set.
CHECK_SUPPORTS = [
    (0, 2, 4, 6),
    (1, 2, 5, 6),
    (3, 4, 5, 6),
]


class SteaneCode(QuantumErrorCode):
    """[[7,1,3]]: 3 Z-type stabilizers (ancillas 7-9, locate X errors)
    followed by 3 X-type stabilizers (ancillas 10-12, locate Z errors)."""

    num_data = 7
    num_ancilla = 6

    def generate_stabilizer_circuits(
            self, initial_state_kernel: AnsatzKernel, num_qubits: int,
            simulator: roc_q.Simulator) -> List[QuantumProgram]:
        base = getattr(initial_state_kernel, "__wrapped__",
                       initial_state_kernel)
        programs = []
        for j, support in enumerate(CHECK_SUPPORTS):
            anc = 7 + j

            def z_kernel(q, _s=support, _a=anc):
                base(q)
                for d in _s:
                    q.cx(d, _a)          # Z-parity: CX(data -> ancilla)

            z_kernel.__name__ = f"steane_z{j}"
            programs.append(roc_q.build(roc_q.kernel(z_kernel), num_qubits,
                                        simulator))
        for j, support in enumerate(CHECK_SUPPORTS):
            anc = 10 + j

            def x_kernel(q, _s=support, _a=anc):
                base(q)
                q.h(_a)                  # X-parity: ancilla in |+>,
                for d in _s:             # CX(ancilla -> data),
                    q.cx(_a, d)
                q.h(_a)                  # read in the computational basis
            x_kernel.__name__ = f"steane_x{j}"
            programs.append(roc_q.build(roc_q.kernel(x_kernel), num_qubits,
                                        simulator))
        return programs

    def define_logical_operators(self) -> Dict[str, PauliOperator]:
        return {
            "logical_Z": PauliOperator({" ".join(f"Z{i}" for i in range(7)):
                                        1.0}),
            "logical_X": PauliOperator({" ".join(f"X{i}" for i in range(7)):
                                        1.0}),
        }
