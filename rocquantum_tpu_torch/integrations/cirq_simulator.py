"""Cirq simulator plugin on the port's QuantumSimulator.

Counterpart of ``rocquantum_tpu/integrations/cirq_simulator.py``
(reference: integrations/cirq-rocm/cirq_rocm/roc_quantum_simulator.py —
named-gate map, cirq.unitary() fallback for matrix gates, statevector
simulation + sampling). Requires cirq at import time.
"""

from __future__ import annotations

import numpy as np
import torch

import cirq

from ..api import default_device
from ..simulator import QuantumSimulator

CIRQ_TO_ROCQ_GATES = {
    cirq.X: "X", cirq.Y: "Y", cirq.Z: "Z", cirq.H: "H",
    cirq.S: "S", cirq.T: "T", cirq.CNOT: "CNOT", cirq.CZ: "CZ",
}


class RocQuantumSimulator(cirq.SimulatesFinalState, cirq.SimulatesSamples):
    """cirq simulator running on the port's statevector engine, on
    ``device`` (default: the card)."""

    def __init__(self, device=None):
        self._device = torch.device(device) if device is not None \
            else default_device()

    def _get_final_statevector(self, circuit, qubit_order):
        q_map = {q: i for i, q in enumerate(qubit_order)}
        sim = QuantumSimulator(num_qubits=max(len(q_map), 1),
                               device=self._device)
        for op in circuit.all_operations():
            if isinstance(op.gate, cirq.MeasurementGate):
                continue
            indices = [q_map[q] for q in op.qubits]
            if op.gate in CIRQ_TO_ROCQ_GATES:
                sim.apply_gate(CIRQ_TO_ROCQ_GATES[op.gate], indices)
            else:
                sim.apply_matrix(cirq.unitary(op), indices)
        return sim, q_map

    def _run(self, circuit, param_resolver, repetitions):
        resolved = cirq.resolve_parameters(circuit, param_resolver)
        qubit_order = sorted(resolved.all_qubits())
        sim, q_map = self._get_final_statevector(resolved, qubit_order)
        measurements = {}
        for op in resolved.all_operations():
            if isinstance(op.gate, cirq.MeasurementGate):
                indices = [q_map[q] for q in op.qubits]
                outcomes = np.asarray(sim.measure(indices, repetitions))
                # bit i of the outcome integer corresponds to indices[i]
                values = ((outcomes[:, np.newaxis] >>
                           np.arange(len(indices))) & 1).astype(np.uint8)
                measurements[op.gate.key] = values
        return measurements

    def simulate_sweep(self, program, params=None, qubit_order=None,
                       initial_state=None):
        results = []
        for resolver in cirq.to_resolvers(params):
            resolved = cirq.resolve_parameters(program, resolver)
            order = sorted(resolved.all_qubits())
            sim, _ = self._get_final_statevector(resolved, order)
            state = sim.get_statevector().astype(np.complex64)
            results.append(_FinalStateResult(state, resolver))
        return results


class _FinalStateResult:
    """Minimal final-state result (statevector + params)."""

    def __init__(self, state, params):
        self.final_state_vector = state
        self.params = params

    def state_vector(self):
        return self.final_state_vector
