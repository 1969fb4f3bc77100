"""Qiskit provider + backend on the port's QuantumSimulator.

Counterpart of ``rocquantum_tpu/integrations/qiskit_provider.py``
(reference: integrations/qiskit-rocquantum-provider/qiskit_rocquantum_provider/
backend.py — BackendV2 with rx/ry/rz/cx/h/unitary/measure Target :29-36,
per-instruction translation + measure -> Counter -> Result :50-110;
provider.py — ProviderV1 registry). Requires qiskit at import time.

The simulator's state lives on ``device`` (default: the card); the draws
come from its seeded ``torch.Generator``.
"""

from __future__ import annotations

import uuid
from collections import Counter

import torch
from qiskit.providers import BackendV2, Options
from qiskit.result import Result
from qiskit.transpiler import Target

from ..api import default_device
from ..simulator import QuantumSimulator


class RocQuantumBackend(BackendV2):
    """Qiskit backend running on the port's statevector simulator."""

    def __init__(self, provider=None, device=None, **kwargs):
        super().__init__(provider=provider, name="rocq_simulator", **kwargs)
        self._device = torch.device(device) if device is not None \
            else default_device()
        self._simulator = None
        self._num_qubits = 0
        self._target = Target()

    @property
    def target(self):
        return self._target

    @property
    def max_circuits(self):
        return None

    @classmethod
    def _default_options(cls):
        return Options(shots=1024)

    def _ensure_simulator(self, num_qubits):
        if self._simulator is None or self._num_qubits != num_qubits:
            self._simulator = QuantumSimulator(num_qubits,
                                               device=self._device)
            self._num_qubits = num_qubits
        else:
            self._simulator.reset()

    def run(self, run_input, **options):
        if not isinstance(run_input, list):
            run_input = [run_input]
        job_id = str(uuid.uuid4())
        shots = options.get("shots", self.options.shots)
        results = []

        for circuit in run_input:
            self._ensure_simulator(circuit.num_qubits)
            measured_bits = {}
            for instruction in circuit.data:
                op = instruction.operation
                q_indices = [circuit.find_bit(q).index
                             for q in instruction.qubits]
                if op.name in ("rx", "ry", "rz"):
                    self._simulator.apply_gate(op.name.upper(), q_indices,
                                               [float(p) for p in op.params])
                elif op.name in ("cx", "cz", "swap", "h", "x", "y", "z",
                                 "s", "sdg", "t", "tdg", "ccx", "cswap"):
                    name = {"cx": "CNOT"}.get(op.name, op.name.upper())
                    self._simulator.apply_gate(name, q_indices, [])
                elif op.name == "unitary":
                    self._simulator.apply_matrix(op.to_matrix(), q_indices)
                elif op.name == "measure":
                    c_index = circuit.find_bit(instruction.clbits[0]).index
                    measured_bits[c_index] = q_indices[0]
                elif op.name == "barrier":
                    continue
                else:
                    raise ValueError(f"Unsupported instruction: {op.name}")

            qubits_to_measure = list(measured_bits.values())
            if not qubits_to_measure:
                qubits_to_measure = list(range(circuit.num_qubits))
            # bit i of each outcome is qubits_to_measure[i]
            raw_samples = self._simulator.measure(qubits_to_measure, shots)
            counts = Counter(raw_samples)
            n = len(qubits_to_measure)
            formatted_counts = {format(k, f"0{n}b"): v
                                for k, v in counts.items()}
            results.append({
                "shots": shots,
                "success": True,
                "data": {
                    "counts": formatted_counts,
                    "memory": [format(s, f"0{n}b") for s in raw_samples],
                },
                "header": {"name": getattr(circuit, "name", "circuit")},
            })

        return Result.from_dict({
            "backend_name": self.name,
            "backend_version": "0.1.0",
            "job_id": job_id,
            "qobj_id": None,
            "success": True,
            "results": results,
        })

    def get_statevector(self):
        if self._simulator is None:
            raise RuntimeError("run() a circuit first")
        return self._simulator.get_statevector()


try:  # ProviderV1 was removed in qiskit 1.x; fall back to a plain registry
    from qiskit.providers import ProviderV1 as _ProviderBase
except ImportError:
    _ProviderBase = object


class RocQuantumProvider(_ProviderBase):
    """Provider exposing the rocq_simulator backend on ``device``."""

    def __init__(self, device=None):
        if _ProviderBase is not object:
            super().__init__()
        self.name = "rocquantum_provider"
        self._backends = {"rocq_simulator": RocQuantumBackend(
            provider=self, device=device)}

    def backends(self, name=None, **kwargs):
        if name:
            return [self._backends[name]]
        return list(self._backends.values())

    def get_backend(self, name=None, **kwargs):
        if name is None:
            return next(iter(self._backends.values()))
        return self._backends[name]
