"""OpenQASM 3.0 emission from CircuitIR.

A copy of ``rocquantum_tpu/compiler/qasm.py``.

Parity with the reference's QuantumCircuit.to_qasm
(rocquantum/circuit.py:68-96), extended to the full gate set.
"""

from __future__ import annotations

from .ir import CircuitIR, GateOp, ParamRef

_SIMPLE = {"X": "x", "Y": "y", "Z": "z", "H": "h", "S": "s", "SDG": "sdg",
           "T": "t", "TDG": "tdg", "SWAP": "swap"}
_PARAM = {"RX": "rx", "RY": "ry", "RZ": "rz", "P": "p", "PHASE": "p",
          "U3": "u3"}
_CTRL = {"CNOT": "cx", "CX": "cx", "CZ": "cz", "CRX": "crx", "CRY": "cry",
         "CRZ": "crz", "MCX": None, "CCX": "ccx", "TOFFOLI": "ccx",
         "CSWAP": "cswap"}


def _fmt_params(op: GateOp) -> str:
    vals = []
    for p in op.params:
        if isinstance(p, ParamRef):
            raise ValueError(
                "cannot emit OpenQASM for a circuit with unbound parameters; "
                "bind concrete values first")
        vals.append(f"{float(p):.12g}")
    return "(" + ", ".join(vals) + ")" if vals else ""


def to_qasm3(ir: CircuitIR, add_measure_all: bool = True) -> str:
    lines = [
        "OPENQASM 3.0;",
        f"qubit[{ir.num_qubits}] q;",
        f"bit[{ir.num_qubits}] c;",
    ]
    for op in ir.ops:
        name = op.name.upper()
        qubits = list(op.controls) + list(op.targets)
        qstr = ", ".join(f"q[{i}]" for i in qubits)
        if op.matrix is not None:
            raise ValueError("generic unitary ops have no OpenQASM form")
        if name == "RZZ":
            # not in stdgates: emit the CNOT-RZ-CNOT decomposition so any
            # cloud backend can consume it
            a, b = op.targets
            theta = _fmt_params(op)
            lines.append(f"cx q[{a}], q[{b}];")
            lines.append(f"rz{theta} q[{b}];")
            lines.append(f"cx q[{a}], q[{b}];")
            continue
        if name in _SIMPLE:
            lines.append(f"{_SIMPLE[name]}{_fmt_params(op)} {qstr};")
        elif name in _PARAM:
            lines.append(f"{_PARAM[name]}{_fmt_params(op)} {qstr};")
        elif name in _CTRL:
            g = _CTRL[name]
            if g is None:  # MCX with arbitrary control count
                nc = len(op.controls)
                lines.append(f"ctrl({nc}) @ x {qstr};")
            else:
                lines.append(f"{g}{_fmt_params(op)} {qstr};")
        else:
            raise ValueError(f"gate {name} has no OpenQASM mapping")
    if add_measure_all:
        lines.append("c = measure q;")
    return "\n".join(lines)
