"""The rocq programming model on PyTorch: Simulator / Circuit /
PauliOperator.

Counterpart of ``rocquantum_tpu/api.py`` for an f32 circuit on one device,
unsharded and unbatched. ``Circuit`` queues gates and ``flush()`` replays
the queue through the planned fused-kernel passes (compiler/interpreter.py),
carrying the state as a float32 pair ``(re, im)`` and as ``(re, None)``
while the circuit stays real. Mid-circuit ``measure`` reduces on the device,
draws on the host from the simulator's numpy generator (the same draws as
the JAX package for the same seed) and collapses on the device; ``sample``
draws on the device from a seeded ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .compiler.interpreter import compile_pair32_ir, init_real, parametrize
from .compiler.ir import CircuitIR, GateOp
from .compiler.sharded_schedule import elide_swaps, unpermute_ops
from .ops import pairsim


def default_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class Simulator:
    """Simulation context: RNG seeding and device placement.

    ``host_random`` draws from ``np.random.default_rng(seed)``, as the JAX
    package does, so mid-circuit measurements draw the same outcomes for
    the same seed. Device sampling uses one ``torch.Generator`` per device,
    seeded with ``seed``."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = seed
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._host_rng = np.random.default_rng(seed)
        self._generators: Dict[torch.device, torch.Generator] = {}

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        gen = self._generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.seed)
            self._generators[device] = gen
        return gen

    def host_random(self) -> float:
        return float(self._host_rng.random())


class _GateMethods:
    """Gate-emission methods shared by Circuit and the kernel recorder.

    Method set and argument orders follow the reference Circuit
    (api.py:118-188).
    """

    def _enqueue(self, name, targets, controls=(), params=(), matrix=None):
        raise NotImplementedError

    def _validate_qubit_index(self, qubit_index, name="target qubit"):
        if not isinstance(qubit_index, (int, np.integer)) or not (
                0 <= qubit_index < self.num_qubits):
            if not (self.num_qubits == 0 and qubit_index == 0):
                raise ValueError(
                    f"{name} index {qubit_index} is out of range for "
                    f"{self.num_qubits} qubits.")

    def _validate_control_target(self, control_qubit, target_qubit):
        self._validate_qubit_index(control_qubit, "control qubit")
        self._validate_qubit_index(target_qubit, "target qubit")
        if control_qubit == target_qubit and self.num_qubits > 0:
            raise ValueError("Control and target qubits cannot be the same.")

    def x(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("X", [target_qubit])

    def y(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("Y", [target_qubit])

    def z(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("Z", [target_qubit])

    def h(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("H", [target_qubit])

    def s(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("S", [target_qubit])

    def sdg(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("SDG", [target_qubit])

    def t(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("T", [target_qubit])

    def tdg(self, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("TDG", [target_qubit])

    def rx(self, angle, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("RX", [target_qubit], params=[angle])

    def ry(self, angle, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("RY", [target_qubit], params=[angle])

    def rz(self, angle, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._enqueue("RZ", [target_qubit], params=[angle])

    def cx(self, control_qubit: int, target_qubit: int):
        self._validate_control_target(control_qubit, target_qubit)
        self._enqueue("CNOT", [target_qubit], controls=[control_qubit])

    cnot = cx

    def cz(self, qubit1: int, qubit2: int):
        self._validate_control_target(qubit1, qubit2)
        self._enqueue("CZ", [qubit2], controls=[qubit1])

    def swap(self, qubit1: int, qubit2: int):
        self._validate_control_target(qubit1, qubit2)
        self._enqueue("SWAP", [qubit1, qubit2])

    def rzz(self, angle, qubit1: int, qubit2: int):
        """exp(-i angle/2 Z@Z) — the native two-qubit diagonal entangler
        (rides the fused kernel's "D2" path; QASM emission decomposes to
        CNOT-RZ-CNOT for cloud backends)."""
        self._validate_control_target(qubit1, qubit2)
        self._enqueue("RZZ", [qubit1, qubit2], params=[angle])

    def crx(self, angle, control_qubit: int, target_qubit: int):
        self._validate_control_target(control_qubit, target_qubit)
        self._enqueue("CRX", [target_qubit], controls=[control_qubit],
                      params=[angle])

    def cry(self, angle, control_qubit: int, target_qubit: int):
        self._validate_control_target(control_qubit, target_qubit)
        self._enqueue("CRY", [target_qubit], controls=[control_qubit],
                      params=[angle])

    def crz(self, angle, control_qubit: int, target_qubit: int):
        self._validate_control_target(control_qubit, target_qubit)
        self._enqueue("CRZ", [target_qubit], controls=[control_qubit],
                      params=[angle])

    def ccx(self, control_qubit1: int, control_qubit2: int, target_qubit: int):
        self._validate_qubit_index(target_qubit)
        self._validate_qubit_index(control_qubit1)
        self._validate_qubit_index(control_qubit2)
        self._enqueue("MCX", [target_qubit],
                      controls=[control_qubit1, control_qubit2])

    def mcx(self, control_qubits: Sequence[int], target_qubit: int):
        for c in control_qubits:
            self._validate_qubit_index(c, "control qubit")
        self._validate_qubit_index(target_qubit)
        self._enqueue("MCX", [target_qubit], controls=list(control_qubits))

    def cswap(self, control_qubit: int, target_qubit1: int, target_qubit2: int):
        self._validate_qubit_index(control_qubit)
        self._validate_qubit_index(target_qubit1)
        self._validate_qubit_index(target_qubit2)
        self._enqueue("CSWAP", [target_qubit1, target_qubit2],
                      controls=[control_qubit])

    def apply_unitary(self, qubit_indices: List[int], matrix: np.ndarray):
        matrix = np.asarray(matrix)
        m = len(qubit_indices)
        if matrix.shape != (1 << m, 1 << m):
            raise ValueError(
                f"matrix shape {matrix.shape} does not match "
                f"{m} target qubits")
        for q in qubit_indices:
            self._validate_qubit_index(q)
        self._enqueue("UNITARY", list(qubit_indices),
                      matrix=np.ascontiguousarray(matrix, dtype=np.complex128))

    def apply_controlled_unitary(self, control_qubits: List[int],
                                 target_qubits: List[int], matrix: np.ndarray):
        matrix = np.asarray(matrix)
        m = len(target_qubits)
        if matrix.shape != (1 << m, 1 << m):
            raise ValueError(
                f"matrix shape {matrix.shape} does not match "
                f"{m} target qubits")
        for q in list(control_qubits) + list(target_qubits):
            self._validate_qubit_index(q)
        self._enqueue("UNITARY", list(target_qubits),
                      controls=list(control_qubits),
                      matrix=np.ascontiguousarray(matrix, dtype=np.complex128))

class Circuit(_GateMethods):
    """A gate queue bound to device state; ``flush`` runs the queue through
    the fused-kernel plan (reference api.py:37-288)."""

    def __init__(self, num_qubits: int, simulator: Simulator,
                 fuse: bool = True, max_fuse: int = 2, device=None):
        if not isinstance(simulator, Simulator):
            raise TypeError("A valid Simulator instance is required.")
        if num_qubits < 0:
            raise ValueError("Number of qubits must be non-negative.")
        self.num_qubits = num_qubits
        self.simulator = simulator
        self.device = torch.device(device) if device is not None \
            else simulator.device
        self._fuse = fuse
        self._max_fuse = max_fuse
        self._gate_queue: List[GateOp] = []
        self._is_dirty = False
        self._state = None  # (re, im_or_None), made at first use
        # logical qubit -> physical index bit (SWAP gates relabel it)
        self._layout: List[int] = list(range(num_qubits))

    # -- state management ---------------------------------------------------

    @property
    def state(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The float-pair state ``(re, im)``; ``im`` is None while the
        circuit is real."""
        if self._state is None:
            self._state = (init_real(self.num_qubits, self.device), None)
        return self._state

    def reset(self):
        """Re-initialize to |0...0> (rocsvInitializeState semantics)."""
        self._gate_queue.clear()
        self._is_dirty = False
        self._layout = list(range(self.num_qubits))
        self._state = None
        self._state = self.state

    def _phys(self, qubit: int) -> int:
        return self._layout[qubit]

    def _restore_identity_layout(self):
        """Apply the index-bit swaps returning the state to logical order
        (before a full-state readback)."""
        if self._layout == list(range(self.num_qubits)):
            return
        fn = compile_pair32_ir(CircuitIR(self.num_qubits,
                                         unpermute_ops(self._layout)))
        self._state = tuple(fn(self.state, None))
        self._layout = list(range(self.num_qubits))

    # -- queue / flush --------------------------------------------------------

    def _enqueue(self, name, targets, controls=(), params=(), matrix=None,
                 is_adjoint=False):
        self._gate_queue.append(GateOp(name.upper(), tuple(targets),
                                       tuple(controls), tuple(params), matrix,
                                       is_adjoint))
        self._is_dirty = True

    def flush(self):
        """Run the queued gates (reference api.py:74-89): SWAPs become
        layout relabels, concrete angles become a parameter vector so
        structurally equal flushes share one cached plan."""
        if not self._is_dirty or not self._gate_queue:
            return
        ops, values = parametrize(self._gate_queue)
        ops, self._layout = elide_swaps(ops, self._layout)
        fn = compile_pair32_ir(CircuitIR(self.num_qubits, ops),
                               fuse=self._fuse, max_fuse=self._max_fuse)
        self._state = tuple(fn(self.state, np.asarray(values, np.float32)))
        self._gate_queue.clear()
        self._is_dirty = False

    # -- measurement / readback ----------------------------------------------

    def measure(self, qubit_to_measure: int) -> Tuple[int, float]:
        """Projective mid-circuit measurement: returns (outcome, probability
        of that outcome) and collapses the state (rocsvMeasure semantics,
        hipStateVec.h:327). A real carry stays real."""
        self.flush()
        self._validate_qubit_index(qubit_to_measure)
        phys = self._phys(qubit_to_measure)
        re, im = self.state
        p1 = float(pairsim.prob_one_pair(re, im, phys))
        outcome = 1 if self.simulator.host_random() < p1 else 0
        self._state = pairsim.collapse_pair(re, im, phys, outcome)
        return outcome, (p1 if outcome == 1 else 1.0 - p1)

    def sample(self, measured_qubits: List[int], num_shots: int) -> np.ndarray:
        """Shot sampling over ``measured_qubits`` (rocsvSample;
        qubits[0] is the least significant bit of each outcome)."""
        self.flush()
        if not measured_qubits:
            raise ValueError("List of measured_qubits cannot be empty.")
        for idx in measured_qubits:
            self._validate_qubit_index(idx, f"measured_qubits element {idx}")
        if num_shots <= 0:
            raise ValueError("Number of shots must be positive.")
        qubits = tuple(self._phys(q) for q in measured_qubits)
        re, im = self.state
        out = pairsim.sample_pair(re, im, qubits, num_shots,
                                  self.simulator.generator(re.device))
        return out.cpu().numpy()

    def sample_counts(self, measured_qubits: List[int],
                      num_shots: int) -> Dict[str, int]:
        """Histogram with bitstring keys (qubits[0] = rightmost bit), the
        format cloud providers return."""
        from collections import Counter
        samples = self.sample(measured_qubits, num_shots)
        k = len(measured_qubits)
        return {format(int(v), f"0{k}b"): c
                for v, c in sorted(Counter(samples.ravel().tolist()).items())}

    def get_statevector(self) -> np.ndarray:
        """Full state readback as complex128 (rocsvGetStateVectorFull)."""
        self.flush()
        self._restore_identity_layout()
        re, im = self.state
        out = re.cpu().numpy().astype(np.complex128)
        if im is not None:
            out += 1j * im.cpu().numpy()
        return out

    def get_statevector_slice(self, start: int, size: int) -> np.ndarray:
        """Amplitudes [start, start+size) without full readback
        (rocsvGetStateVectorSlice analog)."""
        self.flush()
        if start < 0 or size <= 0 or start + size > (1 << self.num_qubits):
            raise ValueError("slice out of range")
        self._restore_identity_layout()
        re, im = pairsim.slice_pair(*self.state, start, size)
        out = re.cpu().numpy().astype(np.complex128)
        if im is not None:
            out += 1j * im.cpu().numpy()
        return out

    def get_probabilities(self, qubits: Optional[List[int]] = None
                          ) -> np.ndarray:
        self.flush()
        qubits = list(qubits) if qubits is not None \
            else list(range(self.num_qubits))
        phys = tuple(self._phys(q) for q in qubits)
        probs = pairsim.marginal_probs_pair(*self.state, phys)
        return probs.cpu().numpy().astype(np.float64)

    def expval(self, pauli_operator: "PauliOperator") -> float:
        """Expectation of a PauliOperator on the current state, computed on
        the device with float64 accumulation."""
        if not isinstance(pauli_operator, PauliOperator):
            raise TypeError("Input must be a PauliOperator object.")
        self.flush()
        terms = [tuple((p, self._phys(q)) for p, q in ops)
                 for ops, _ in pauli_operator.terms]
        coeffs = [float(c) for _, c in pauli_operator.terms]
        return float(pairsim.expval_terms_pair(*self.state, terms, coeffs))


class PauliOperator:
    """Weighted sum of Pauli strings ("X0 Y1" terms).

    Ported essentially verbatim from the reference (api.py:291-366) for API
    parity — this class, including its parsing rules and error messages, IS
    the behavioral contract user code and the solvers program against
    (SURVEY §7 directs "port as-is" for this pure-Python glue)."""

    def __init__(self, terms: Union[Dict[str, float], str, None] = None,
                 coefficient: float = 1.0):
        self.terms: List[Tuple[List[Tuple[str, int]], float]] = []
        if terms is None:
            return
        if isinstance(terms, str):
            # optional coefficient supports the DSL constructor form
            # PauliOperator("X0 Y1", 0.5) (reference rocq/operator.py:60)
            self._add_pauli_string(terms, coefficient)
        elif isinstance(terms, dict):
            for pauli_str, coeff in terms.items():
                self._add_pauli_string(pauli_str, coeff)
        else:
            raise TypeError(
                "PauliOperator terms must be a dict or a single Pauli string.")

    def _add_pauli_string(self, pauli_str: str, coeff: float):
        if not isinstance(pauli_str, str):
            raise TypeError("Pauli string must be a string.")
        if not isinstance(coeff, (float, int)):
            raise TypeError("Coefficient must be a float or int.")
        components = pauli_str.strip().upper().split()
        if not components and pauli_str:
            if pauli_str.strip().upper() == "I":
                self.terms.append(([], float(coeff)))
                return
            raise ValueError(f"Invalid Pauli string component: {pauli_str}")
        parsed_ops = []
        for comp in components:
            if not comp:
                continue
            if comp == "I":  # bare identity component (no qubit index)
                continue
            pauli_char = comp[0]
            if pauli_char not in "IXYZ":
                raise ValueError(
                    f"Invalid Pauli type '{pauli_char}' in '{comp}'. "
                    "Must be I, X, Y, or Z.")
            try:
                qubit_idx = int(comp[1:])
                if qubit_idx < 0:
                    raise ValueError("Qubit index cannot be negative.")
            except ValueError:
                raise ValueError(
                    f"Invalid qubit index in '{comp}'. Must be an integer.")
            if pauli_char != "I":
                parsed_ops.append((pauli_char, qubit_idx))
        self.terms.append((parsed_ops, float(coeff)))

    def __repr__(self):
        if not self.terms:
            return "PauliOperator(Empty)"
        term_strs = []
        for ops, coeff in self.terms:
            op_str = " ".join(f"{p}{q}" for p, q in ops) if ops else "I"
            term_strs.append(f"{coeff} * [{op_str}]")
        return "PauliOperator(" + "\n+ ".join(term_strs) + "\n)"

    def __add__(self, other):
        if not isinstance(other, PauliOperator):
            return NotImplemented
        new_op = PauliOperator()
        new_op.terms = self.terms + other.terms
        return new_op

    def __mul__(self, scalar: float):
        if not isinstance(scalar, (float, int)):
            return NotImplemented
        new_op = PauliOperator()
        new_op.terms = [(ops, coeff * float(scalar)) for ops, coeff in self.terms]
        return new_op

    def __rmul__(self, scalar: float):
        return self.__mul__(scalar)
