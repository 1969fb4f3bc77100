"""Standalone QuantumSimulator facade (counterpart of
``rocquantum_tpu/simulator.py``).

API-parity rebuild of the reference's self-contained simulator that feeds
the Qiskit/Cirq/PennyLane plugins
(reference: include/rocquantum/QuantumSimulator.h:11-43 — modern API
apply_gate/apply_matrix/measure/reset/get_statevector; legacy
ApplyGate/Execute/GetStateVector API simulator.cpp:190-208; ``QSim`` alias
:42; name->matrix table simulator.cpp:28-48).

Gates are queued and the queue runs at the next readback as one circuit
through ``compile_ir`` on a flat complex state: its plan is cached by
structure, with the gate angles as runtime parameters, and from n = 15 on
its runs of gates launch the fused kernel. The state lives on ``device``
(default: the card); draws come from a ``torch.Generator`` seeded with
``seed``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .compiler.interpreter import compile_ir, parametrize
from .compiler.ir import CircuitIR, GateOp
from .ops import statevec as sv

# gate name -> (targets, params) layout, mirroring simulator.cpp:28-48
_KNOWN_GATES = {"H", "X", "Y", "Z", "S", "SDG", "T", "TDG", "I",
                "RX", "RY", "RZ", "CNOT", "CX", "CZ", "SWAP",
                "CRX", "CRY", "CRZ", "CCX", "MCX", "CSWAP"}


class QuantumSimulator:
    """Statevector simulator with the reference's plugin-facing method
    surface."""

    def __init__(self, num_qubits: int, seed: int = 0, device=None):
        if num_qubits <= 0:
            raise ValueError("num_qubits must be positive")
        if device is None:
            from .api import default_device
            device = default_device()
        self.num_qubits = num_qubits
        self.device = torch.device(device)
        self._queue: List[GateOp] = []
        self._state: Optional[torch.Tensor] = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    # -- state helpers -------------------------------------------------------

    def _init_state(self) -> torch.Tensor:
        return sv.init_state(self.num_qubits, device=self.device)

    def _flush(self):
        if self._state is None:
            self._state = self._init_state()
        if not self._queue:
            return
        ops, values = parametrize(self._queue)
        fn = compile_ir(CircuitIR(self.num_qubits, ops))
        self._state = fn(self._state, np.asarray(values, np.float64))
        self._queue.clear()

    # -- modern API (QuantumSimulator.h:20-33) -------------------------------

    def reset(self):
        self._queue.clear()
        self._state = self._init_state()

    def apply_gate(self, gate_name: str, qubits: Sequence[int],
                   params: Sequence[float] = ()):
        name = gate_name.upper()
        if name not in _KNOWN_GATES:
            raise ValueError(f"Unknown gate: {gate_name}")
        qubits = [int(q) for q in qubits]
        params = [float(p) for p in params]
        if name in ("CNOT", "CX", "CZ", "CRX", "CRY", "CRZ"):
            ctrl, tgt = qubits[:-1], qubits[-1:]
            self._queue.append(GateOp(name if name != "CX" else "CNOT",
                                      tuple(tgt), tuple(ctrl), tuple(params)))
        elif name in ("CCX", "MCX"):
            self._queue.append(GateOp("MCX", (qubits[-1],),
                                      tuple(qubits[:-1]), ()))
        elif name == "CSWAP":
            self._queue.append(GateOp("CSWAP", tuple(qubits[1:]),
                                      (qubits[0],), ()))
        else:
            self._queue.append(GateOp(name, tuple(qubits), (), tuple(params)))

    def apply_matrix(self, matrix: np.ndarray, qubits: Sequence[int]):
        matrix = np.asarray(matrix)
        m = len(qubits)
        if matrix.shape != (1 << m, 1 << m):
            raise ValueError(f"matrix shape {matrix.shape} does not match "
                             f"{m} qubits")
        self._queue.append(GateOp("UNITARY", tuple(int(q) for q in qubits), (),
                                  (), np.ascontiguousarray(matrix,
                                                           np.complex128)))

    def measure(self, qubits: Sequence[int], shots: int) -> List[int]:
        """Sample ``shots`` outcomes over ``qubits`` without collapsing
        (simulator.cpp:153-184's probability + host sampling, on the
        device)."""
        self._flush()
        out = sv.sample(self._state, [int(q) for q in qubits], int(shots),
                        self._generator)
        return out.cpu().tolist()

    def get_statevector(self) -> np.ndarray:
        self._flush()
        return self._state.cpu().numpy().astype(np.complex128)

    def get_probabilities(self, qubits: Optional[Sequence[int]] = None
                          ) -> np.ndarray:
        """Marginal probabilities over ``qubits`` (default: all), float64
        sums of the precision's amplitudes."""
        self._flush()
        if qubits is None:
            qubits = range(self.num_qubits)
        return sv.marginal_probs(self._state, [int(q) for q in qubits]
                                 ).cpu().numpy()

    def sample_counts(self, shots: int,
                      qubits: Optional[Sequence[int]] = None) -> Dict[int, int]:
        if qubits is None:
            qubits = range(self.num_qubits)
        return dict(Counter(self.measure(list(qubits), shots)))

    # -- legacy API (simulator.cpp:190-208; bindings.cpp:31-102) -------------

    def ApplyGate(self, gate_name: str, target_qubit: int):
        self.apply_gate(gate_name, [target_qubit])

    def ApplyCNOT(self, control: int, target: int):
        self.apply_gate("CNOT", [control, target])

    def Execute(self):
        self._flush()

    def GetStateVector(self) -> np.ndarray:
        return self.get_statevector()


# Legacy alias (QuantumSimulator.h:42)
QSim = QuantumSimulator
