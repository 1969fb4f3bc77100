"""``_rocq_hip_backend``: the reference's main pybind11 module
(python/rocq/bindings.cpp) on the port, as the repository's
``rocq/_rocq_hip_backend.py`` provides it on the JAX package: the status
enum, the handle, device buffers, the per-gate apply functions, the
readouts, GateOp, RocTensor / RocTensorNetwork and the pinned-buffer
family. A handle owns a Simulator on ``RocsvHandle(device=...)``'s device
(default: the card); buffers and networks live there.
"""

from __future__ import annotations

import enum
from typing import List, Optional

import numpy as np

import torch

from ..compiler.ir import GateOp  # noqa: F401  (B1 GateOp :685)
from ..compiler.passes import plan_fusion as _plan_fusion
from ..compiler.pipeline import MLIRCompiler  # noqa: F401
from ..tensornet import Tensor, TensorNetwork, tensor_svd  # noqa: F401


class rocqStatus(enum.Enum):
    SUCCESS = 0
    ERROR_INVALID_VALUE = 1
    ERROR_ALLOCATION = 2
    NOT_IMPLEMENTED = 3


class RocsvHandle:
    """Opaque simulator handle (bindings.cpp:101-139): the Simulator whose
    device its buffers live on."""

    def __init__(self, device=None):
        from ..api import Simulator
        self.simulator = Simulator(device=device)

    def get_num_gpus(self) -> int:
        """The number of devices in ``parallel.default_mesh()`` (0 without
        a CUDA device)."""
        if not torch.cuda.is_available():
            return 0
        from ..parallel.mesh import default_mesh
        return default_mesh().size


class RocTensor:
    """Labeled tensor handle (bindings.cpp:497): dims now, data optional,
    labels assigned as an attribute (reference slicing_example.py style)."""

    def __init__(self, dims: List[int], py_data_np_array: Optional[np.ndarray] = None):
        self.dims = list(dims)
        self.labels: List[str] = []
        self._data = py_data_np_array

    def materialize(self, device=None) -> Tensor:
        data = self._data
        if data is None:
            rng = np.random.default_rng(0)
            data = rng.normal(size=self.dims).astype(np.complex64) \
                if self.dims else np.zeros((), np.complex64)
        return Tensor.from_numpy(np.asarray(data), list(self.labels),
                                 device=device)


class RocTensorNetwork:
    """Tensor-network handle (bindings.cpp:640) with dict-config contract."""

    def __init__(self, handle: Optional[RocsvHandle] = None):
        self.handle = handle
        self._tn = TensorNetwork(
            simulator=None if handle is None else handle.simulator)

    def add_tensor(self, tensor: RocTensor):
        self._tn.add_tensor(tensor.materialize(self._tn.device))

    def contract(self, optimizer_config=None, result: Optional[RocTensor] = None):
        out = self._tn.contract(optimizer_config)
        if result is not None:
            result.dims = list(out.shape)
            result.labels = list(out.labels)
            result._data = out.to_numpy()
        return out

    @property
    def last_num_slices(self):
        return self._tn.last_num_slices


def rocTensorNetworkAddTensor(tn: RocTensorNetwork, tensor: RocTensor):
    tn.add_tensor(tensor)
    return rocqStatus.SUCCESS


def rocTensorNetworkContract(tn: RocTensorNetwork, config, result: RocTensor):
    tn.contract(config, result)
    return rocqStatus.SUCCESS


class GateFusion:
    """CPU-side fusion planner handle (bindings.cpp:685-699; GateFusion.cpp).
    processQueue returns the fused plan rather than mutating device state."""

    def process_queue(self, ops, max_fuse: int = 2):
        return _plan_fusion(list(ops), max_fuse=max_fuse)

    processQueue = process_queue


def get_state_vector(handle, circuit_or_state, num_elements: int = None):
    """Statevector readback (bindings.cpp:466-485)."""
    if isinstance(circuit_or_state, DeviceBuffer):
        return circuit_or_state.circuit.get_statevector()
    if hasattr(circuit_or_state, "get_statevector"):
        return circuit_or_state.get_statevector()
    raise TypeError("pass a Circuit or DeviceBuffer")


# ---------------------------------------------------------------------------
# Per-gate binding surface (bindings.cpp:160-485). The reference mutates a
# device buffer synchronously per call; here DeviceBuffer wraps a Circuit,
# gate calls ENQUEUE (run together at the next flush), and every readback
# (measure / expectation / sample / get_state_vector_*) flushes: the same
# observable semantics, no per-gate device round trips.
# ---------------------------------------------------------------------------


class DeviceBuffer:
    """Owning 'device buffer' (bindings.cpp:29-97). Two roles, as in the
    reference: a STATE buffer (allocate_state_internal) carrying the live
    simulation, or a MATRIX buffer (create_device_matrix_from_numpy)
    carrying a dense operator."""

    def __init__(self, num_qubits: int = 0, handle: Optional[RocsvHandle] = None,
                 matrix: Optional[np.ndarray] = None):
        self.circuit = None
        self.matrix = None
        if matrix is not None:
            self.matrix = np.ascontiguousarray(matrix, dtype=np.complex64)
            self._nbytes = self.matrix.nbytes
            return
        from ..api import Circuit, Simulator
        sim = handle.simulator if handle is not None else Simulator()
        self.num_qubits = int(num_qubits)
        self.circuit = Circuit(self.num_qubits, sim)
        self._nbytes = 8 * (1 << self.num_qubits)

    def nbytes(self) -> int:
        return self._nbytes

    def copy_from_numpy(self, arr: np.ndarray):
        self.matrix = np.ascontiguousarray(arr, dtype=np.complex64)
        self._nbytes = self.matrix.nbytes

    def to_numpy(self) -> np.ndarray:
        if self.matrix is not None:
            return np.asarray(self.matrix)
        return self.circuit.get_statevector()


def allocate_state_internal(handle: RocsvHandle, num_qubits: int) -> DeviceBuffer:
    """rocsvAllocateState + DeviceBuffer wrap (bindings.cpp:173-184)."""
    return DeviceBuffer(num_qubits, handle)


def initialize_state(handle: RocsvHandle, d_state: DeviceBuffer,
                     num_qubits: int) -> rocqStatus:
    """Reset to |0...0> (bindings.cpp:186-193)."""
    if d_state.num_qubits != int(num_qubits):
        raise RuntimeError("DeviceBuffer size mismatch in initialize_state")
    d_state.circuit.reset()
    return rocqStatus.SUCCESS


def allocate_distributed_state(handle: RocsvHandle,
                               total_num_qubits: int) -> DeviceBuffer:
    """Distributed-state allocation (bindings.cpp:195-203): sharded over
    ``parallel.default_mesh()`` when it has more than one device, else a
    plain state on the handle's device."""
    from ..api import Circuit
    buf = DeviceBuffer.__new__(DeviceBuffer)
    buf.matrix = None
    buf.num_qubits = int(total_num_qubits)
    buf._nbytes = 8 * (1 << buf.num_qubits)
    if handle.get_num_gpus() > 1:
        from ..parallel.mesh import default_mesh
        buf.circuit = Circuit(buf.num_qubits, handle.simulator,
                              mesh=default_mesh())
    else:
        buf.circuit = Circuit(buf.num_qubits, handle.simulator)
    return buf


def initialize_distributed_state(handle: RocsvHandle,
                                 d_state: DeviceBuffer = None) -> rocqStatus:
    if d_state is not None:
        d_state.circuit.reset()
    return rocqStatus.SUCCESS


def _gate(method):
    def f(handle, d_state, num_qubits, *args):
        getattr(d_state.circuit, method)(*args)
        return rocqStatus.SUCCESS
    f.__name__ = f"apply_{method}"
    f.__doc__ = f"rocsvApply* shim: Circuit.{method} (bindings.cpp:211-258)."
    return f


apply_x = _gate("x")
apply_y = _gate("y")
apply_z = _gate("z")
apply_h = _gate("h")
apply_s = _gate("s")
apply_t = _gate("t")
apply_sdg = _gate("sdg")
apply_cnot = _gate("cx")
apply_cz = _gate("cz")
apply_swap = _gate("swap")


def _angle_gate(method):
    # reference order: (handle, d_state, nQ, target..., angle); Circuit
    # takes the angle FIRST — reorder here
    def f(handle, d_state, num_qubits, *args):
        *qubits, angle = args
        getattr(d_state.circuit, method)(angle, *qubits)
        return rocqStatus.SUCCESS
    f.__name__ = f"apply_{method}"
    f.__doc__ = f"rocsvApply* shim: Circuit.{method} (bindings.cpp:229-258)."
    return f


apply_rx = _angle_gate("rx")
apply_ry = _angle_gate("ry")
apply_rz = _angle_gate("rz")
apply_crx = _angle_gate("crx")
apply_cry = _angle_gate("cry")
apply_crz = _angle_gate("crz")


def apply_mcx(handle, d_state, num_qubits, control_qubits, target_qubit):
    """rocsvApplyMultiControlledX (bindings.cpp:252-254)."""
    d_state.circuit.mcx(list(control_qubits), int(target_qubit))
    return rocqStatus.SUCCESS


def apply_cswap(handle, d_state, num_qubits, control_qubit, t1, t2):
    """rocsvApplyCSWAP (bindings.cpp:255-257)."""
    d_state.circuit.cswap(int(control_qubit), int(t1), int(t2))
    return rocqStatus.SUCCESS


def _as_matrix(matrix_device) -> np.ndarray:
    if isinstance(matrix_device, DeviceBuffer):
        if matrix_device.matrix is None:
            raise RuntimeError("DeviceBuffer holds no matrix")
        return matrix_device.matrix
    return np.asarray(matrix_device, dtype=np.complex64)


def apply_matrix(handle, d_state, num_qubits, qubit_indices, matrix_device,
                 matrix_dim: int = None):
    """rocsvApplyMatrix (bindings.cpp:261-291): dense 2^m x 2^m matrix on
    ``qubit_indices`` (qubit_indices[0] = LSB of the matrix index)."""
    mat = _as_matrix(matrix_device)
    if matrix_dim is not None and mat.shape[0] != matrix_dim:
        mat = mat.reshape(matrix_dim, matrix_dim)
    d_state.circuit.apply_unitary(list(qubit_indices), mat)
    return rocqStatus.SUCCESS


def apply_controlled_matrix(handle, d_state, num_qubits, control_qubits,
                            target_qubits, matrix_device):
    """rocsvApplyControlledMatrix (bindings.cpp:429-464)."""
    mat = _as_matrix(matrix_device)
    controls = list(control_qubits)
    if not controls:
        return apply_matrix(handle, d_state, num_qubits, target_qubits,
                            matrix_device)
    d_state.circuit.apply_controlled_unitary(controls, list(target_qubits),
                                             mat)
    return rocqStatus.SUCCESS


def measure(handle, d_state, num_qubits, qubit_to_measure):
    """rocsvMeasure (bindings.cpp:293-308): collapse + (outcome, prob)."""
    outcome, prob = d_state.circuit.measure(int(qubit_to_measure))
    return int(outcome), float(prob)


def _expval_pauli(d_state, pauli_string: str, qubits) -> float:
    from ..api import PauliOperator
    term = " ".join(f"{p.upper()}{q}" for p, q in zip(pauli_string, qubits)
                    if p.upper() != "I")
    if not term:
        return 1.0
    return float(d_state.circuit.expval(PauliOperator(term)))


def get_expectation_value_z(handle, d_state, num_qubits, target_qubit):
    """<Z_k> (bindings.cpp:310-324). Non-destructive here (the reference's
    X/Y variants mutate the state — flagged by SURVEY as a bug, not spec)."""
    return _expval_pauli(d_state, "Z", [int(target_qubit)])


def get_expectation_value_x(handle, d_state, num_qubits, target_qubit):
    return _expval_pauli(d_state, "X", [int(target_qubit)])


def get_expectation_value_y(handle, d_state, num_qubits, target_qubit):
    return _expval_pauli(d_state, "Y", [int(target_qubit)])


def get_expectation_value_pauli_product_z(handle, d_state, num_qubits,
                                          target_qubits):
    """<Z_q0 Z_q1 ...> (bindings.cpp:358-377)."""
    qs = list(target_qubits)
    if not qs:
        return 1.0
    return _expval_pauli(d_state, "Z" * len(qs), qs)


def get_expectation_pauli_string(handle, d_state, num_qubits, pauli_string,
                                 target_qubits):
    """Generic Pauli-string expectation, e.g. "IXYZ" (bindings.cpp:378-402)."""
    qs = list(target_qubits)
    if len(pauli_string) != len(qs):
        raise RuntimeError(
            "Pauli string length must match the number of target qubits.")
    if not qs:
        return 1.0
    return _expval_pauli(d_state, pauli_string, qs)


def sample(handle, d_state, num_qubits, measured_qubits, num_shots):
    """rocsvSample (bindings.cpp:404-427): uint64 outcome per shot
    (measured_qubits[0] = LSB of the outcome index)."""
    if num_shots == 0:
        return np.zeros((0,), np.uint64)
    out = d_state.circuit.sample(list(measured_qubits), int(num_shots))
    return np.asarray(out, dtype=np.uint64)


def get_state_vector_full(handle, d_state, num_qubits, batch_size: int = 1):
    """rocsvGetStateVectorFull (bindings.cpp:466-474)."""
    return d_state.circuit.get_statevector()


def get_state_vector_slice(handle, d_state, num_qubits, batch_size: int = 1,
                           batch_index: int = 0):
    """rocsvGetStateVectorSlice (bindings.cpp:476-484)."""
    size = 1 << int(num_qubits)
    return d_state.circuit.get_statevector_slice(batch_index * size, size)


def create_device_matrix_from_numpy(numpy_array: np.ndarray) -> DeviceBuffer:
    """DeviceBuffer holding a dense matrix (bindings.cpp:487-495)."""
    arr = np.asarray(numpy_array)
    if arr.ndim != 2:
        raise RuntimeError("NumPy array must be 2D for matrix.")
    return DeviceBuffer(matrix=arr)


# --- pinned host-buffer family (hipStateVec.h:296-325) -------------------
# The surface is kept so binding-level callers port unchanged; "pinned"
# here is a plain numpy scratch buffer owned by the handle, as in the JAX
# package's shim (readbacks stage through PyTorch's own buffers).

def rocsv_ensure_pinned_buffer(handle: RocsvHandle,
                               min_size_bytes: int) -> rocqStatus:
    """rocsvEnsurePinnedBuffer (hipStateVec.h:307): grow-only scratch
    allocation on the handle."""
    if min_size_bytes < 0:
        return rocqStatus.ERROR_INVALID_VALUE
    buf = getattr(handle, "_pinned_buffer", None)
    if buf is None or buf.nbytes < min_size_bytes:
        handle._pinned_buffer = np.empty(int(min_size_bytes), np.uint8)
    return rocqStatus.SUCCESS


def rocsv_get_pinned_buffer_pointer(handle: RocsvHandle):
    """rocsvGetPinnedBufferPointer (hipStateVec.h:315): the scratch buffer
    (numpy array, the Python analog of a raw pointer) or None when not
    allocated."""
    return getattr(handle, "_pinned_buffer", None)


def rocsv_free_pinned_buffer(handle: RocsvHandle) -> rocqStatus:
    """rocsvFreePinnedBuffer (hipStateVec.h:324)."""
    handle._pinned_buffer = None
    return rocqStatus.SUCCESS
