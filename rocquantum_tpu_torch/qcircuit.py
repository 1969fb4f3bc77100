"""High-level QuantumCircuit with OpenQASM 3.0 emission (a copy of
``rocquantum_tpu/qcircuit.py`` over this package's IR and
compiler/qasm.py).

API-parity rebuild of the reference rocquantum/circuit.py (QuantumCircuit:
h/x/cx/measure_all, to_qasm :68-96), extended with the full engine gate set
(the reference only emitted h/x/cx).
"""

from __future__ import annotations

from typing import Any, List, Tuple

from .compiler.ir import CircuitIR
from .compiler.qasm import to_qasm3


class QuantumCircuit:
    """Programmatic circuit builder compiling to OpenQASM 3.0."""

    def __init__(self, num_qubits: int):
        if not isinstance(num_qubits, int) or num_qubits <= 0:
            raise ValueError("Number of qubits must be a positive integer.")
        self.num_qubits = num_qubits
        self._operations: List[Tuple[str, Any]] = []
        self._measured = False

    def _validate_qubit_index(self, *indices):
        for index in indices:
            if not (0 <= index < self.num_qubits):
                raise ValueError(
                    f"Qubit index {index} is out of bounds for a circuit "
                    f"with {self.num_qubits} qubits.")

    def h(self, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("h", qubit_index))

    def x(self, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("x", qubit_index))

    def y(self, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("y", qubit_index))

    def z(self, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("z", qubit_index))

    def s(self, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("s", qubit_index))

    def t(self, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("t", qubit_index))

    def rx(self, angle: float, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("rx", (angle, qubit_index)))

    def ry(self, angle: float, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("ry", (angle, qubit_index)))

    def rz(self, angle: float, qubit_index: int):
        self._validate_qubit_index(qubit_index)
        self._operations.append(("rz", (angle, qubit_index)))

    def cx(self, control_index: int, target_index: int):
        if control_index == target_index:
            raise ValueError("Control and target qubits cannot be the same.")
        self._validate_qubit_index(control_index, target_index)
        self._operations.append(("cx", (control_index, target_index)))

    def cz(self, control_index: int, target_index: int):
        if control_index == target_index:
            raise ValueError("Control and target qubits cannot be the same.")
        self._validate_qubit_index(control_index, target_index)
        self._operations.append(("cz", (control_index, target_index)))

    def swap(self, q1: int, q2: int):
        if q1 == q2:
            raise ValueError("SWAP qubits cannot be the same.")
        self._validate_qubit_index(q1, q2)
        self._operations.append(("swap", (q1, q2)))

    def measure_all(self):
        if self._measured:
            raise ValueError(
                "Measurement has already been added to this circuit.")
        self._operations.append(("measure_all", None))
        self._measured = True

    def to_ir(self) -> CircuitIR:
        """Lower to the shared circuit IR (executable on the simulator)."""
        ir = CircuitIR(self.num_qubits, name="qcircuit")
        for op_name, op_args in self._operations:
            if op_name == "measure_all":
                continue
            if op_name in ("rx", "ry", "rz"):
                angle, q = op_args
                ir.add(op_name, [q], params=[angle])
            elif op_name in ("cx", "cz"):
                c, t = op_args
                ir.add("CNOT" if op_name == "cx" else "CZ", [t], controls=[c])
            elif op_name == "swap":
                ir.add("SWAP", list(op_args))
            else:
                ir.add(op_name, [op_args])
        return ir

    def to_qasm(self) -> str:
        """OpenQASM 3.0 emission; auto-appends measurement
        (reference circuit.py:68-96 semantics)."""
        if not self._measured:
            self.measure_all()
        return to_qasm3(self.to_ir(), add_measure_all=True)
