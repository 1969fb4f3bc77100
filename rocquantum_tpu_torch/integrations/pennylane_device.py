"""PennyLane device plugin on the port's QuantumSimulator.

Counterpart of ``rocquantum_tpu/integrations/pennylane_device.py``
(reference: integrations/pennylane-rocq/pennylane_rocq/rocq_device.py —
QubitDevice 'rocquantum.qpu', named-gate map + qml.matrix fallback,
analytic_probability + multinomial generate_samples). Requires pennylane at
import time.

The state stays on ``device`` (default: the card): probabilities are
computed there and the draws come from the simulator's seeded
``torch.Generator``, so samples repeat run to run. ``state`` copies the
amplitudes to the host only when it is read.
"""

from __future__ import annotations

import numpy as np
import torch

import pennylane as qml
from pennylane.devices import QubitDevice

from ..api import default_device
from ..simulator import QuantumSimulator

PENNYLANE_TO_ROCQ_GATES = {
    "PauliX": "X", "PauliY": "Y", "PauliZ": "Z",
    "Hadamard": "H", "S": "S", "T": "T",
    "CNOT": "CNOT", "CZ": "CZ",
}


class RocQDevice(QubitDevice):
    """PennyLane device running on the port's statevector engine."""

    name = "rocQuantum PyTorch Simulator Device"
    short_name = "rocquantum.qpu"
    pennylane_requires = ">=0.30"
    version = "0.1.0"
    author = "rocquantum_tpu developers"

    operations = set(PENNYLANE_TO_ROCQ_GATES) | {"QubitUnitary", "RX", "RY",
                                                 "RZ"}
    observables = {"PauliX", "PauliY", "PauliZ", "Identity", "Hadamard",
                   "Prod"}

    def __init__(self, wires, shots=None, device=None, **kwargs):
        super().__init__(wires=wires, shots=shots)
        self._device = torch.device(device) if device is not None \
            else default_device()
        self.sim = None
        self._applied = False
        self.reset()

    def reset(self):
        self.sim = QuantumSimulator(num_qubits=len(self.wires),
                                    device=self._device)
        self._applied = False

    def apply(self, operations, **kwargs):
        for op in operations:
            gate_name = op.name
            wire_indices = [self.wire_map[w] for w in op.wires]
            if gate_name in PENNYLANE_TO_ROCQ_GATES:
                self.sim.apply_gate(PENNYLANE_TO_ROCQ_GATES[gate_name],
                                    wire_indices)
            elif gate_name in ("RX", "RY", "RZ"):
                self.sim.apply_gate(gate_name, wire_indices,
                                    [float(p) for p in op.parameters])
            elif gate_name == "QubitUnitary":
                self.sim.apply_matrix(qml.matrix(op), wire_indices)
            else:
                raise NotImplementedError(
                    f"Operation {gate_name} not supported.")
        self.sim.Execute()
        self._applied = True

    @property
    def state(self):
        return self.sim.get_statevector() if self._applied else None

    def analytic_probability(self, wires=None):
        if not self._applied:
            return None
        all_probs = self.sim.get_probabilities()
        if wires is None:
            return all_probs
        wires_to_trace = [i for i, w in enumerate(self.wires)
                          if w not in wires]
        return self.marginal_prob(all_probs, wires_to_trace)

    def generate_samples(self):
        n = len(self.wires)
        # outcome k has bit q = qubit q, the index order of the
        # probabilities above
        outcomes = self.sim.measure(list(range(n)), self.shots)
        return self.states_to_binary(np.asarray(outcomes, np.int64), n)
