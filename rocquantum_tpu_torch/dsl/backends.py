"""DSL simulation backends: 'state_vector' and 'density_matrix'
(counterpart of ``rocquantum_tpu/dsl/backends.py``).

API-parity rebuild of the reference rocq/backends.py (get_backend factory
:114-153, StateVectorBackend/DensityMatrixBackend dispatch :51-112), with the
mock C++ fallbacks replaced by this package's engines. Gate and noise calls
are queued; the queue runs at the first readback after it changed, and its
state is kept for the readbacks that follow:

- the state-vector backend runs the queue as one IR through ``compile_ir``
  on a flat complex state (gate angles as runtime parameters, so the plan
  is cached by structure): from n = 15 on its runs of gates launch the
  fused kernel in single precision; a complex128 state in ``"double"``
  runs every gate exactly;
- the density-matrix backend lowers the queue to this package's
  ``DensityCircuit``, which runs it on the fused kernels in single
  precision and ``"df64"``, and on the exact engine in ``"double"``.

Both live on ``device`` (default: the card).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import config
from ..compiler.interpreter import compile_ir
from ..compiler.ir import CircuitIR, GateOp, ParamRef
from ..ops import pairdm
from ..ops import statevec as sv
from ..ops.density import CHANNELS

_GATE_PARAM_ORDER = {"rx": ("theta",), "ry": ("theta",), "rz": ("phi",)}


def _canon_op(op_name: str, targets: Sequence[int], params: Optional[Dict]):
    """DSL op -> (name, targets, controls, param values)."""
    op = op_name.lower()
    params = params or {}
    order = _GATE_PARAM_ORDER.get(op, ())
    vals = [params[k] for k in order] if order else list(params.values())
    if op in ("cnot", "cx"):
        return ("CNOT", [targets[1]], [targets[0]], [])
    if op == "cz":
        return ("CZ", [targets[1]], [targets[0]], [])
    if op == "ccx":
        return ("MCX", [targets[2]], [targets[0], targets[1]], [])
    if op == "mcx":
        return ("MCX", [targets[-1]], list(targets[:-1]), [])
    if op == "cswap":
        return ("CSWAP", [targets[1], targets[2]], [targets[0]], [])
    return (op.upper(), list(targets), [], vals)


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class _BaseBackend:
    """Abstract backend (reference rocq/backends.py:37-49)."""

    def __init__(self, num_qubits: int, device=None):
        if device is None:
            from ..api import default_device
            device = default_device()
        self.num_qubits = num_qubits
        self.device = torch.device(device)
        self._queue: List[tuple] = []
        self._ran = None  # (queue length, precision, result) of the last run

    def apply_gate(self, op_name, targets, params=None):
        name, tgt, ctrl, vals = _canon_op(op_name, targets, params)
        self._queue.append(("gate", name, tuple(tgt), tuple(ctrl),
                            tuple(float(v) for v in vals)))

    def apply_noise(self, channel, targets, prob):
        raise NotImplementedError

    def validate_noise_support(self):
        raise NotImplementedError

    def get_state(self):
        raise NotImplementedError

    def _final_state(self):
        """The queue's result, run again only when the queue (it only
        grows) or the precision changed since the last run."""
        mark = (len(self._queue), config.get_precision(),
                config.df64_enabled())
        if self._ran is None or self._ran[0] != mark:
            self._ran = (mark, self._run())
        return self._ran[1]

    def _run(self):
        raise NotImplementedError


class StateVectorBackend(_BaseBackend):
    """State-vector simulation (reference rocq/backends.py:51-85)."""

    def apply_noise(self, channel, targets, prob):
        raise NotImplementedError(
            "Noise models are only supported by the 'density_matrix' backend.")

    def validate_noise_support(self):
        raise NotImplementedError(
            "Noise models are only supported by the 'density_matrix' backend.")

    def _run(self) -> torch.Tensor:
        """The flat state after the queue: the gate angles become ParamRef
        slots of one IR, so queues that differ only in angles share its
        cached plan."""
        ops, values = [], []
        for _, name, tgt, ctrl, vals in self._queue:
            refs = tuple(ParamRef(len(values) + i) for i in range(len(vals)))
            values.extend(vals)
            ops.append(GateOp(name, tgt, ctrl, refs))
        fn = compile_ir(CircuitIR(self.num_qubits, ops))
        return fn(sv.init_state(self.num_qubits, device=self.device),
                  np.asarray(values, np.float64))

    def get_state(self) -> np.ndarray:
        return self._final_state().cpu().numpy().astype(np.complex128)

    get_state_vector = get_state

    def sample(self, qubits, shots, seed=0):
        out = sv.sample(self._final_state(), list(qubits), shots,
                        _generator(self.device, seed))
        return out.cpu().numpy()

    def expectation_pauli(self, ops) -> float:
        state = self._final_state()
        if not ops:
            return 1.0
        return float(sv.expval_pauli_string(state, list(ops)))

    def expectation_matrix(self, matrix, targets) -> float:
        """Re <psi| M |psi> for a dense M on ``targets``."""
        state = self._final_state()
        phi = sv.apply_matrix(state, np.asarray(matrix), list(targets))
        return float(torch.sum((state.conj() * phi).real, dtype=torch.float64))


class DensityMatrixBackend(_BaseBackend):
    """Density-matrix simulation with noise channels
    (reference rocq/backends.py:87-112)."""

    def apply_noise(self, channel_type, targets, prob):
        channel = channel_type.lower()
        if channel not in CHANNELS:
            raise ValueError(
                f"Noise channel '{channel_type}' is not supported by the "
                "DensityMatrixBackend.")
        self._queue.append(("noise", channel, tuple(targets), float(prob)))

    def validate_noise_support(self):
        return None

    def _run(self):
        """A flushed DensityCircuit holding the queue's rho."""
        from ..api import Simulator
        from ..density_circuit import DensityCircuit

        circ = DensityCircuit(self.num_qubits, Simulator(device=self.device))
        for item in self._queue:
            if item[0] == "gate":
                _, name, tgt, ctrl, vals = item
                circ._enqueue(name, tgt, ctrl, vals)
            else:
                _, channel, tgt, prob = item
                circ.apply_channel(channel, prob, list(tgt))
        circ.flush()
        return circ

    def get_state(self) -> np.ndarray:
        return self._final_state().get_density_matrix()

    get_density_matrix = get_state

    def sample(self, qubits, shots, seed=0):
        re = self._final_state().state[0]
        out = pairdm.sample_pair_dm(re, tuple(qubits), shots,
                                    _generator(self.device, seed))
        return out.cpu().numpy()

    def expectation_pauli(self, ops) -> float:
        circ = self._final_state()
        if not ops:
            return 1.0
        re, im = circ.state
        return float(pairdm.expval_terms_pair_dm(
            re, im, [tuple(ops)], [1.0], self.num_qubits))

    def expectation_matrix(self, matrix, targets) -> float:
        """Re Tr(M rho) for a dense M on ``targets``: M acts on rho's row
        bits (q + n) and the trace is summed in float64."""
        n = self.num_qubits
        re, im = self._final_state().state
        rho = torch.complex(re, im if im is not None else torch.zeros_like(re))
        phi = sv.apply_matrix(rho, np.asarray(matrix),
                              [t + n for t in targets])
        return float(torch.sum(phi.reshape(1 << n, 1 << n).diagonal().real,
                               dtype=torch.float64))


def get_backend(backend_name: str, num_qubits: int, device=None):
    """Backend factory (reference rocq/backends.py:114-153; error message is
    part of the tested contract, tests/test_framework.py:44-48); the
    backend lives on ``device`` (default: the card)."""
    SUPPORTED_BACKENDS = ["state_vector", "density_matrix"]
    if backend_name not in SUPPORTED_BACKENDS:
        raise ValueError(
            f"Unsupported backend '{backend_name}'. Supported backends are: "
            f"{SUPPORTED_BACKENDS}")
    if backend_name == "state_vector":
        return StateVectorBackend(num_qubits, device)
    return DensityMatrixBackend(num_qubits, device)
