"""Hamiltonian time evolution via Trotterization (a copy of
``rocquantum_tpu/models/evolution.py``, run by this package's
``compile_ir``).

Builds exp(-i H t) circuits from PauliOperator Hamiltonians (first- and
second-order Suzuki-Trotter). Each Pauli-string term exp(-i c t P) compiles
to the standard basis-change + CNOT-parity-ladder + RZ pattern; the RZ
angles are ParamRef slots scaled at execution time, so one compiled circuit
serves any evolution time.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..compiler.ir import CircuitIR, ParamRef


def _term_ops(ir: CircuitIR, ops: Sequence[Tuple[str, int]], slot: int):
    """exp(-i theta/2 * P) for Pauli string P with theta = params[slot]
    (the RZ convention: RZ(theta) = exp(-i theta Z / 2))."""
    qubits = [q for _, q in ops]
    # basis change into Z
    for p, q in ops:
        if p == "X":
            ir.add("H", [q])
        elif p == "Y":
            # Y -> Z basis: S^dagger then H
            ir.add("SDG", [q])
            ir.add("H", [q])
    # parity ladder onto the last qubit
    for a, b in zip(qubits[:-1], qubits[1:]):
        ir.add("CNOT", [b], controls=[a])
    ir.add("RZ", [qubits[-1]], params=[ParamRef(slot)])
    for a, b in reversed(list(zip(qubits[:-1], qubits[1:]))):
        ir.add("CNOT", [b], controls=[a])
    # undo basis change
    for p, q in reversed(list(ops)):
        if p == "X":
            ir.add("H", [q])
        elif p == "Y":
            ir.add("H", [q])
            ir.add("S", [q])


def trotter_ir(hamiltonian, num_qubits: int, steps: int,
               order: int = 1) -> Tuple[CircuitIR, "callable"]:
    """Build the Trotterized evolution circuit for ``hamiltonian``
    (a PauliOperator; identity terms contribute only global phase and are
    skipped).

    Returns (ir, params_for) where ``params_for(t)`` gives the parameter
    vector evolving for total time ``t``.
    """
    terms = [(ops, coeff) for ops, coeff in hamiltonian.terms if ops]
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    ir = CircuitIR(num_qubits, name=f"trotter{order}x{steps}")
    slot_scale: List[float] = []

    def add_sweep(scale: float, term_list):
        for ops, coeff in term_list:
            slot = len(slot_scale)
            # RZ(theta) = exp(-i theta Z/2)  =>  theta = 2 * coeff * dt
            slot_scale.append(2.0 * coeff * scale)
            _term_ops(ir, ops, slot)

    for _ in range(steps):
        if order == 1:
            add_sweep(1.0 / steps, terms)
        else:  # symmetric second order
            add_sweep(0.5 / steps, terms)
            add_sweep(0.5 / steps, list(reversed(terms)))

    scales = np.asarray(slot_scale, dtype=np.float64)

    def params_for(t: float) -> np.ndarray:
        return (scales * float(t)).astype(np.float32)

    return ir, params_for


def evolve(state, hamiltonian, t: float, steps: int = 10, order: int = 2,
           num_qubits: int = None):
    """Evolve the flat complex ``state`` under exp(-i H t) (Trotterized);
    returns a new state on the same device."""
    from ..compiler.interpreter import compile_ir
    from ..ops import statevec as sv

    n = num_qubits if num_qubits is not None else sv.num_qubits_of(state)
    ir, params_for = trotter_ir(hamiltonian, n, steps, order)
    return compile_ir(ir)(state, params_for(t))
