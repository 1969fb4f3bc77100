"""The rocq programming model on PyTorch: Simulator / Circuit /
PauliOperator / kernel / build / get_expval / adjoint / compile_program /
grad / adjoint_grad.

Counterpart of ``rocquantum_tpu/api.py``. ``Circuit`` queues gates and
``flush()`` replays the queue through the planned fused-kernel passes
(compiler/interpreter.py), carrying the state as a float pair ``(re, im)``
and as ``(re, None)`` while the circuit stays real. The precision at the
state's creation fixes its planes: float32 in single precision, float64 in
double. A float64 state flushes through the double-float engine (df64
kernel) when ``config.df64_enabled()``, else through the exact per-op
engine, which returns the full pair. Mid-circuit ``measure`` reduces on
the device, draws on the host from the simulator's numpy generator (the
same draws as the JAX package for the same seed) and collapses on the
device; ``sample`` draws on the device from a seeded ``torch.Generator``.

``Circuit(n, sim, batch_size=b)`` runs b states side by side (the
reference's ``batchSize``, hipStateVec.h:61), as the JAX package does: in
single precision one complex64 ``(b, 2^n)`` tensor through
``compile_ir(batched=True)`` (the fused kernel's batched passes, one launch
a pass for the whole batch); in double precision, ``"df64"`` included, the
exact float64 pair of ``(b, 2^n)`` planes. Measurements draw per element
in element order and readouts return one row or value per element.

``Circuit(n, sim, mesh=mesh)`` (or ``multi_gpu=True``) shards the state
over a ``parallel.Mesh`` (parallel/sharded.py): flushes are scheduled so
every gate touches local bits, each device runs the plan over the rows of
its shards, and readouts reduce per-shard partials. A batch may be
sharded too, over a ``make_mesh_2d(dp, sv)``. ``compile_program(mesh=)``
replays a sharded flush.

``@kernel`` functions are traced into a CircuitIR by a recorder;
``compile_program`` captures a flush's plan once and replays it;
``adjoint_grad`` differentiates a kernel's energy with the O(1)-memory
reversible sweep (autodiff.py) through ``torch.autograd``.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from . import config
from .compiler.interpreter import (  # noqa: F401 (execute: re-exported)
    compile_df64_fused_ir, compile_ir, compile_pair32_ir, execute, init_real,
    init_real64, parametrize, run_ops_f64, run_ops_f64_sharded)
from .compiler.ir import CircuitIR, GateOp, ParamRef
from .compiler.passes import adjoint_ir
from .compiler.qasm import to_qasm3
from .compiler.sharded_schedule import (elide_swaps, schedule_for_sharding,
                                        unpermute_ops)
from .ops import pairsim
from .ops import statevec as sv
from .parallel import sharded
from .parallel.mesh import SV_AXIS, Mesh, default_mesh
from .utils import profiling
from .utils.cache import BoundedCache


def default_device() -> torch.device:
    """The current CUDA device. The port runs on the card unless the caller
    asks for the CPU (``device="cpu"``); without a CUDA device this
    raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


class _Engine(NamedTuple):
    """An engine of :func:`_engine`: its name (``"pair32"``, ``"flat"``,
    ``"df64"`` or ``"exact"``), the dtype of its parameter values,
    ``zero()``, which makes its |0...0>, and ``compile(ir, fuse=True,
    max_fuse=2)``, which returns its ``run(state, values) -> state`` for
    an IR."""
    name: str
    dtype: type
    zero: Callable
    compile: Callable


def _engine(n: int, device=None, batch_size: int = 1, sharding=None,
            f64: Optional[bool] = None) -> _Engine:
    """The engine of an n-qubit state of ``batch_size`` elements, sharded
    by ``sharding`` or on ``device``, by the precision in force:

    - unbatched on one card: ``"pair32"`` (a real float32 plane) in
      ``"single"``, ``"df64"`` (a real float64 plane) in ``"df64"``,
      ``"exact"`` (the float64 pair) in ``"double"``;
    - batched on one card: ``"flat"`` (complex64 ``(b, 2^n)``) in
      ``"single"``, else ``"exact"`` (a float64 pair batch): the JAX
      package batches neither the real carry nor df64;
    - sharded: ``"flat"`` (complex64 shards) in ``"single"``, ``"df64"``
      (a real float64 plane) unbatched in ``"df64"``, else ``"exact"``.

    ``f64`` says whether the state is float64, for a state made before
    (None: one made now, float64 unless the precision is ``"single"``);
    a float64 state takes df64 when ``config.df64_enabled()`` holds now."""
    if f64 is None:
        f64 = config.get_precision() != "single"
    b = None if batch_size == 1 else batch_size
    if not f64:
        name = "pair32" if sharding is None and b is None else "flat"
    else:
        name = "df64" if config.df64_enabled() and b is None else "exact"

    def zero():
        if name == "flat":
            if sharding is not None:
                return sharded.init_state(n, sharding, torch.complex64,
                                          "complex", b)
            state = torch.zeros((b, 1 << n), dtype=torch.complex64,
                                device=device)
            state[:, 0] = 1.0
            return state
        if name == "pair32":
            return init_real(n, device), None
        if sharding is not None:
            return sharded.init_state(n, sharding, torch.float64,
                                      "real" if name == "df64" else "pair",
                                      b)
        if b is not None:
            return pairsim.init_pair_batched(n, b, torch.float64, device)
        re = init_real64(n, device)
        return (re, None) if name == "df64" else (re, torch.zeros_like(re))

    def compile(ir: CircuitIR, fuse: bool = True, max_fuse: int = 2):
        if name == "pair32":
            fn = compile_pair32_ir(ir, fuse=fuse, max_fuse=max_fuse)
            return lambda state, p: tuple(fn(state, p))
        if name == "flat":
            return compile_ir(ir, fuse=fuse, max_fuse=max_fuse,
                              batched=b is not None, sharding=sharding)
        if name == "df64":
            return compile_df64_fused_ir(ir, fuse=fuse, max_fuse=max_fuse,
                                         sharding=sharding)
        ops = list(ir.ops)
        if sharding is not None:
            return lambda state, p: run_ops_f64_sharded(state, ops, p)
        return lambda state, p: run_ops_f64(*state, ops, p)

    return _Engine(name, np.float64 if f64 else np.float32, zero, compile)


def check_mesh(mesh):
    """Raise unless ``mesh`` is a ``parallel.Mesh`` with an ``sv`` axis."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a rocquantum_tpu_torch.parallel.Mesh,"
                        f" got {type(mesh).__name__}")
    if SV_AXIS not in mesh.axis_names:
        raise ValueError(f"sharded circuits need an '{SV_AXIS}' mesh axis; "
                         f"got {mesh.axis_names}")


# scheduled flushes by (queue structure, qubits, global bits, layout)
_SCHEDULE_CACHE = BoundedCache()


def _schedule(ops, n: int, n_global: int, layout):
    key = (tuple(op.structural_key() for op in ops), n, n_global,
           tuple(layout))
    hit = _SCHEDULE_CACHE.get(key)
    if hit is None:
        hit = schedule_for_sharding(ops, n, n_global, layout)
        _SCHEDULE_CACHE[key] = hit
    return hit[0], list(hit[1])


def _restore_sharded(state, layout):
    """A ShardedState in physical layout ``layout`` brought back to the
    identity layout in one relabel: bit q takes old bit ``layout[q]``, the
    permutation ``unpermute_ops(layout, merge=True)`` spells out (the JAX
    package cuts it into chunks of at most 8 bits for its compiler; one
    all-to-all round carries any permutation here)."""
    return sharded.permute_bits(state, tuple(range(len(layout))),
                                tuple(layout))


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
        self._keys = 0
        self._handle_wrapper = None

    @property
    def handle(self):
        """The reference's backend handle (reference api.py:19-22; user
        code calls ``sim.handle.get_num_gpus()``), made at first use."""
        if self._handle_wrapper is None:
            from .compat._rocq_hip_backend import RocsvHandle
            self._handle_wrapper = RocsvHandle.__new__(RocsvHandle)
            self._handle_wrapper.simulator = self
        return self._handle_wrapper

    def next_key(self) -> torch.Generator:
        """A new generator on the simulator's device, seeded from (seed,
        number of keys drawn so far): each call a fresh, reproducible
        stream (the JAX package splits its PRNG key)."""
        entropy = np.random.SeedSequence([self.seed, self._keys])
        self._keys += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(entropy.generate_state(1, np.uint64)[0] >> 1))
        return gen

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

    def create_device_matrix(self, numpy_matrix: np.ndarray) -> torch.Tensor:
        """A gate matrix as a tensor of the precision's complex type on the
        simulator's device (the reference's
        create_device_matrix_from_numpy, python/rocq/bindings.cpp:487)."""
        if not isinstance(numpy_matrix, np.ndarray):
            raise TypeError("Input matrix must be a NumPy array.")
        return torch.as_tensor(np.ascontiguousarray(numpy_matrix),
                               device=self.device).to(config.complex_dtype())


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
    the fused-kernel plan (reference api.py:37-288). ``batch_size`` > 1
    holds that many states, each getting every gate.

    ``mesh`` (a ``parallel.Mesh`` with an ``sv`` axis; ``multi_gpu=True``
    means ``parallel.default_mesh()``) shards the state: the top log2(P)
    index bits select the shard (parallel/sharded.py). A flush schedules
    the queue so every gate touches local bits (compiler/sharded_schedule
    .py: relabels as all-to-all rounds, the layout kept across flushes in
    ``_layout``) and runs it shard by shard: in single precision a
    complex64 state through ``compile_ir(sharding=...)``, in double
    precision a float64 pair through the df64 engine or the exact one.
    Readouts reduce per-shard partials; only a full read-back gathers,
    after one merged relabel back to the identity layout. ``device`` (last,
    keyword in practice) places an unsharded state."""

    def __init__(self, num_qubits: int, simulator: Simulator,
                 multi_gpu: bool = False, batch_size: int = 1, mesh=None,
                 fuse: bool = True, max_fuse: int = 2, device=None):
        if not isinstance(simulator, Simulator):
            raise TypeError("A valid Simulator instance is required.")
        if num_qubits < 0:
            raise ValueError("Number of qubits must be non-negative.")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1.")
        self.num_qubits = num_qubits
        self.simulator = simulator
        self.batch_size = batch_size
        self.is_multi_gpu = multi_gpu  # compat alias: means "sharded"
        if multi_gpu and mesh is None:
            mesh = default_mesh()
        if mesh is not None:
            check_mesh(mesh)
        self.mesh = mesh
        self.device = torch.device(device) if device is not None \
            else simulator.device
        self._fuse = fuse
        self._max_fuse = max_fuse
        self._gate_queue: List[GateOp] = []
        self._is_dirty = False
        self._state = None  # (re, im_or_None), made at first use
        # logical qubit -> physical index bit (SWAP gates relabel it; on a
        # sharded circuit the scheduler's relabels too)
        self._layout: List[int] = list(range(num_qubits))
        # the request (utils/profiling) of the last CompiledProgram.run
        # that handed this circuit out, which its readouts join
        self._request = None

    # -- state management ---------------------------------------------------

    def _sharding(self):
        if self.mesh is None:
            return None
        return sharded.state_sharding(self.mesh, batch=self.batch_size > 1)

    def _devices(self):
        """The devices that hold the state: the mesh's, or the one."""
        if self.mesh is None:
            return (self.device,)
        return self._sharding().devices

    def _engine(self, f64: Optional[bool] = None) -> _Engine:
        """:func:`_engine` of this circuit's state (``f64``: its own)."""
        return _engine(self.num_qubits, self.device, self.batch_size,
                       self._sharding(), f64)

    def _zero(self):
        """|0...0> in the precision set now (see :attr:`state`)."""
        return self._engine().zero()

    @property
    def state(self):
        """The float-pair state ``(re, im)``; ``im`` is None while the
        circuit is real. Made at first use in the precision set then: a
        real float32 plane, a real float64 plane for the double-float
        engine, else the full float64 pair the exact engine carries. A
        batch is a complex64 ``(b, 2^n)`` tensor in single precision, else
        a float64 pair of ``(b, 2^n)`` planes. A sharded circuit holds a
        ``parallel.ShardedState`` (its planes in the physical layout
        ``_layout``)."""
        if self._state is None:
            self._state = self._zero()
        return self._state

    def _is_sharded(self) -> bool:
        return isinstance(self.state, sharded.ShardedState)

    def _is_complex_batch(self) -> bool:
        return not isinstance(self.state, tuple)

    def _is_f64(self) -> bool:
        if self._is_sharded():
            return self.state.parts[0][0].dtype == torch.float64
        return self.state[0].dtype == torch.float64

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
        (before a full-state readback); sharded, one merged relabel."""
        if self._layout == list(range(self.num_qubits)):
            return
        if self._is_sharded():
            self._state = _restore_sharded(self.state, self._layout)
            self._layout = list(range(self.num_qubits))
            return
        ops = unpermute_ops(self._layout)
        if self._is_f64():
            # the exact engine, which materializes im, as the JAX package
            # does for a float64 state
            self._state = run_ops_f64(*self.state, ops)
        else:
            fn = compile_pair32_ir(CircuitIR(self.num_qubits, ops))
            self._state = tuple(fn(self.state, None))
        self._layout = list(range(self.num_qubits))

    # -- queue / flush --------------------------------------------------------

    def _enqueue(self, name, targets, controls=(), params=(), matrix=None,
                 is_adjoint=False):
        self._gate_queue.append(GateOp(name.upper(), tuple(targets),
                                       tuple(controls), tuple(params), matrix,
                                       is_adjoint))
        self._is_dirty = True

    def _flush_plan(self):
        """``(run, values, layout)`` for the queued gates on the engine of
        the state (:func:`_engine`): concrete angles become a parameter
        vector of the engine's dtype, so structurally equal flushes share
        one cached plan. An unbatched state's SWAPs become layout relabels;
        a batch keeps them as gates, as the JAX package's batched flush
        does; on a mesh the queue is scheduled for locality
        (schedule_for_sharding from the current layout, cached by
        structure)."""
        ops, values = parametrize(self._gate_queue)
        sharding = self._sharding()
        engine = self._engine(f64=self._is_f64())
        if sharding is not None:
            ops, layout = _schedule(ops, self.num_qubits, sharding.n_global,
                                    self._layout)
        elif self.batch_size > 1:
            layout = self._layout
        else:
            ops, layout = elide_swaps(ops, self._layout)
        run = engine.compile(CircuitIR(self.num_qubits, ops), self._fuse,
                             self._max_fuse)
        return run, np.asarray(values, engine.dtype), layout

    def flush(self):
        """Run the queued gates (reference api.py:74-89) through
        :meth:`_flush_plan`."""
        if not self._is_dirty or not self._gate_queue:
            return
        run, values, self._layout = self._flush_plan()
        self._state = run(self.state, values)
        self._gate_queue.clear()
        self._is_dirty = False

    # -- measurement / readback ----------------------------------------------

    def measure(self, qubit_to_measure: int):
        """Projective mid-circuit measurement: returns (outcome, probability
        of that outcome) and collapses the state (rocsvMeasure semantics,
        hipStateVec.h:327). A real carry stays real. A batch draws once per
        element, in element order, and returns ``(outcomes, probs)`` arrays
        of shape ``(b,)``."""
        self.flush()
        self._validate_qubit_index(qubit_to_measure)
        phys = self._phys(qubit_to_measure)
        if self._is_sharded():
            return self._measure_sharded(phys)
        if self.batch_size > 1:
            return self._measure_batch(phys)
        re, im = self.state
        p1 = float(pairsim.prob_one_pair(re, im, phys))
        outcome = 1 if self.simulator.host_random() < p1 else 0
        self._state = pairsim.collapse_pair(re, im, phys, outcome)
        return outcome, (p1 if outcome == 1 else 1.0 - p1)

    def _measure_sharded(self, phys: int):
        """measure on a sharded state: P(1) from per-shard partials, the
        draws on the host, the collapse shard by shard."""
        p1 = sharded.prob_one(self.state, phys).cpu().numpy()
        if self.batch_size == 1:
            p1 = float(p1)
            outcome = 1 if self.simulator.host_random() < p1 else 0
            sharded.collapse(self.state, phys, outcome)
            return outcome, (p1 if outcome == 1 else 1.0 - p1)
        draws = np.asarray([self.simulator.host_random()
                            for _ in range(self.batch_size)])
        outcomes = (draws < p1).astype(np.int32)
        sharded.collapse(self.state, phys, outcomes)
        return outcomes, np.where(outcomes == 1, p1, 1.0 - p1)

    def _measure_batch(self, phys: int):
        state = self.state
        if self._is_complex_batch():
            p1 = sv.prob_one(state, phys)
        else:
            p1 = pairsim.prob_one_pair(*state, phys)
        p1 = p1.cpu().numpy()
        draws = np.asarray([self.simulator.host_random()
                            for _ in range(self.batch_size)])
        outcomes = (draws < p1).astype(np.int32)
        probs = np.where(outcomes == 1, p1, 1.0 - p1)
        picked = torch.as_tensor(outcomes, device=self.device)
        if self._is_complex_batch():
            self._state = sv.collapse_dyn(state, phys, picked)
        else:
            self._state = pairsim.collapse_pair_batched(
                *state, phys, picked, self.num_qubits, self.batch_size)
        return outcomes, probs

    def sample(self, measured_qubits: List[int], num_shots: int) -> np.ndarray:
        """Shot sampling over ``measured_qubits`` (rocsvSample;
        qubits[0] is the least significant bit of each outcome); ``(b,
        shots)``, drawn independently per element, for a batch."""
        self.flush()
        if not measured_qubits:
            raise ValueError("List of measured_qubits cannot be empty.")
        for idx in measured_qubits:
            self._validate_qubit_index(idx, f"measured_qubits element {idx}")
        if num_shots <= 0:
            raise ValueError("Number of shots must be positive.")
        qubits = tuple(self._phys(q) for q in measured_qubits)
        span = profiling.span
        with span("rq.sample", request=self._request,
                  devices=self._devices):
            if self._is_complex_batch() and not self._is_sharded():
                with span("rq.sample.draw"):
                    out = sv.sample(self.state, qubits, num_shots,
                                    self.simulator.generator(self.device))
            else:
                with span("rq.sample.marginal"):
                    if self._is_sharded():
                        marg = sharded.marginal_probs(self.state, qubits)
                    else:
                        marg = pairsim.marginal_probs_pair(*self.state,
                                                           qubits)
                gen = self.simulator.generator(
                    marg.device if self._is_sharded() else self.device)
                with span("rq.sample.draw"):
                    out = pairsim.sample_marginal(marg, num_shots, gen)
            with span("rq.sample.to_host"):
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
        """Full state readback as complex128 (rocsvGetStateVectorFull);
        ``(b, 2^n)`` for a batch."""
        self.flush()
        self._restore_identity_layout()
        state = self.state
        if self._is_sharded():
            state = sharded.gather(state)
            state = state[0] if len(state) == 1 else state
        if not isinstance(state, tuple):
            return state.cpu().numpy().astype(np.complex128)
        re, im = state
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
        if self._is_sharded():
            part = sharded.gather_slice(self.state, start, size)
            re, im = sharded._as_pair(part)
        elif self._is_complex_batch():
            re, im = sv.state_slice_parts(self.state, start, size)
        else:
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
        if self._is_sharded():
            probs = sharded.marginal_probs(self.state, phys)
        elif self._is_complex_batch():
            probs = sv.marginal_probs(self.state, phys)
        else:
            probs = pairsim.marginal_probs_pair(*self.state, phys)
        return probs.cpu().numpy().astype(np.float64)

    def expval(self, pauli_operator: "PauliOperator"):
        """Expectation of a PauliOperator on the current state, computed on
        the device with float64 accumulation: a float, or a ``(b,)`` array
        of one value per element for a batch."""
        if not isinstance(pauli_operator, PauliOperator):
            raise TypeError("Input must be a PauliOperator object.")
        # the span ends once the readout's work is queued: the wait for
        # its value is the host's, not the readout's
        with profiling.span("rq.expval", request=self._request,
                            devices=self._devices):
            self.flush()
            terms = [tuple((p, self._phys(q)) for p, q in ops)
                     for ops, _ in pauli_operator.terms]
            coeffs = [float(c) for _, c in pauli_operator.terms]
            state = self.state
            if self._is_sharded():
                value = sharded.expval_terms(state, terms, coeffs)
            else:
                if self._is_complex_batch():
                    state = (state.real, state.imag)
                value = pairsim.expval_terms_pair(*state, terms, coeffs)
        if self.batch_size > 1:
            return value.cpu().numpy()
        return float(value)


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


class CompiledProgram:
    """A structure-cached end-to-end program: |0..0> -> circuit ->
    (optionally) an observable readback, the serving hot path (reference
    api.py:876-941).

    ``compile_program`` captures what a Circuit flush plans (the engine's
    run function over the cached plan, the parameter vector, the final
    layout) and how its start state is made, once; ``run()`` replays them
    with no re-enqueue and no re-hash. ``run(params)`` overrides the
    parameter VALUES (the structure, parameter count included, is fixed at
    compile time)."""

    def __init__(self, circuit: "Circuit", plan, init_fn, params,
                 observable: Optional["PauliOperator"]):
        self._circ = circuit
        self._plan = plan
        self._init_fn = init_fn
        self._params = params
        self._obs = observable

    @property
    def num_params(self) -> int:
        return int(self._params.shape[0])

    def run(self, params: Optional[Sequence[float]] = None):
        """Execute the program from |0..0>. Returns ``expval(observable)``
        as a float when an observable was given, else the (stateful)
        Circuit handle positioned at the final state for readbacks."""
        c = self._circ
        with profiling.span("rq.run", request=profiling.NEW,
                            devices=c._devices) as request:
            p = self._params
            if params is not None:
                with profiling.span("rq.run.params"):
                    p = np.asarray(params, dtype=self._params.dtype)
                if p.shape != self._params.shape:
                    raise ValueError(
                        f"expected {self._params.shape[0]} parameter values, "
                        f"got {p.shape}")
            run, layout = self._plan
            with profiling.span("rq.run.init"):
                state = self._init_fn()
            c._state = run(state, p)
            c._layout = list(layout)
            c._gate_queue.clear()
            c._is_dirty = False
            c._request = request.request
        if self._obs is None:
            return c
        return c.expval(self._obs)


def compile_program(ir: CircuitIR, simulator: Optional[Simulator] = None,
                    observable: Optional["PauliOperator"] = None,
                    mesh=None, fuse: bool = True,
                    max_fuse: int = 2) -> CompiledProgram:
    """Compile ``ir`` (concrete parameters only) into a
    :class:`CompiledProgram` on the simulator's device, or sharded over
    ``mesh``. The precision in force now fixes the engine and the start
    state of every run."""
    if any(isinstance(p, ParamRef) for op in ir.ops for p in op.params):
        raise ValueError(
            "compile_program needs fully-concrete parameters (found "
            "ParamRef slots); use QuantumProgram.update_params for "
            "recorder-managed parameter vectors")
    sim = simulator if simulator is not None else Simulator()
    c = Circuit(ir.num_qubits, sim, mesh=mesh, fuse=fuse, max_fuse=max_fuse)
    for op in ir.ops:
        c._enqueue(op.name, op.targets, op.controls, op.params, op.matrix,
                   op.is_adjoint)
    run, values, layout = c._flush_plan()
    return CompiledProgram(c, (run, tuple(layout)), c._engine().zero, values,
                           observable)


class _Recorder(_GateMethods):
    """Records a kernel's gate calls into a CircuitIR without executing
    (reference api.py:420-479 walked the kernel's AST instead, and only
    recognized h/cx/rx)."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.ops: List[GateOp] = []

    def _enqueue(self, name, targets, controls=(), params=(), matrix=None,
                 is_adjoint=False):
        self.ops.append(GateOp(name.upper(), tuple(targets), tuple(controls),
                               tuple(params), matrix, is_adjoint))

    # recorder has no device state: measure unsupported inside pure kernels
    def measure(self, *_a, **_k):
        raise NotImplementedError(
            "mid-circuit measurement inside a traced kernel is not "
            "supported; use Circuit.measure between kernel segments")


def trace_kernel(kernel_func: Callable, num_qubits: int, *args) -> CircuitIR:
    """Trace a kernel function into a CircuitIR."""
    rec = _Recorder(num_qubits)
    func = getattr(kernel_func, "__wrapped__", kernel_func)
    func(rec, *args)
    return CircuitIR(num_qubits, rec.ops,
                     name=getattr(kernel_func, "__name__", "kernel"))


class QuantumProgram:
    """A built program: IR + (optionally) an executed Circuit
    (reference api.py:372-417)."""

    def __init__(self, name: str, num_qubits: int, ir: Optional[CircuitIR] = None,
                 kernel_func=None, static_args=None, simulator_ref=None):
        self.name = name
        self.num_qubits = num_qubits
        self.ir = ir if ir is not None else CircuitIR(num_qubits, name=name)
        self.circuit_ref: Optional[Circuit] = None
        self._kernel_func = kernel_func
        self._static_args = static_args
        self._simulator_ref = simulator_ref

    @property
    def mlir_string(self) -> str:  # compat: textual IR instead of MLIR
        return self.ir.dump()

    def dump(self):
        print(self.ir.dump())

    def to_qasm(self) -> str:
        return to_qasm3(self.ir)

    def update_params(self, *params):
        """Re-execute the kernel with new parameters against a reset state
        (reference api.py:391-417). Hits the plan cache since the circuit
        structure is unchanged."""
        if self.circuit_ref is None:
            if self._simulator_ref and self._kernel_func:
                self.circuit_ref = Circuit(self.num_qubits, self._simulator_ref)
            else:
                raise RuntimeError(
                    "Cannot update params: circuit_ref is None and no "
                    "simulator/kernel info to rebuild.")
        if not self._kernel_func:
            raise RuntimeError(
                "Cannot update params: Kernel function not stored in "
                "QuantumProgram.")
        self.circuit_ref.reset()
        kernel_args = [self.circuit_ref]
        if self._static_args:
            kernel_args.extend(self._static_args)
        kernel_args.extend(params)
        func = getattr(self._kernel_func, "__wrapped__", self._kernel_func)
        func(*kernel_args)
        self.circuit_ref.flush()

    def __repr__(self):
        return (f"<QuantumProgram name='{self.name}' "
                f"num_qubits={self.num_qubits}>\nIR:\n{self.ir.dump()}")


def kernel(func: Callable) -> Callable:
    """Mark a function as a quantum kernel (reference api.py:420-479). The
    kernel body is traced by calling it with a recorder; ``generate_ir``
    returns the textual circuit IR (the conceptual-MLIR analog)."""

    def generate_ir(kernel_args, kernel_kwargs=None):
        num_qubits = kernel_args[0]
        ir = trace_kernel(func, num_qubits, *kernel_args[1:])
        return ir.dump()

    func.generate_ir = generate_ir
    func.generate_mlir = generate_ir  # compat alias
    func.__is_rocq_kernel__ = True
    return func


def build(kernel_func: Callable, num_qubits: int, simulator: Simulator,
          *args) -> QuantumProgram:
    """Build + eagerly execute a kernel into a QuantumProgram
    (reference api.py:482-517)."""
    if not hasattr(kernel_func, "generate_ir") and not callable(kernel_func):
        raise TypeError(
            "The function provided to build() must be decorated with "
            "@rocq.kernel")
    name = getattr(kernel_func, "__name__", "kernel")
    program = QuantumProgram(name, num_qubits,
                             kernel_func=kernel_func,
                             static_args=None,
                             simulator_ref=simulator)
    try:
        program.ir = trace_kernel(kernel_func, num_qubits, *args)
    except NotImplementedError:
        pass  # kernels with mid-circuit measurement can't be pre-traced

    if simulator is not None:
        if not isinstance(simulator, Simulator):
            raise TypeError(
                "A valid rocQ Simulator object is required if execution is "
                "expected.")
        program.circuit_ref = Circuit(num_qubits, simulator)
        func = getattr(kernel_func, "__wrapped__", kernel_func)
        func(program.circuit_ref, *args)
        program.circuit_ref.flush()
    return program


def expval_on_state(state, terms) -> float:
    """Evaluate a PauliOperator term list on a float-pair state ``(re,
    im_or_None)`` (reference api.py:1200-1220 takes a complex array):
    ``pairsim.expval_terms_pair``, float64 accumulation."""
    re, im = state
    terms_key = tuple(tuple(ops) for ops, _ in terms)
    coeffs = [float(c) for _, c in terms]
    return float(pairsim.expval_terms_pair(re, im, terms_key, coeffs))


def get_expval(program: QuantumProgram, hamiltonian: PauliOperator) -> float:
    """Expectation of ``hamiltonian`` on the program's executed state
    (reference api.py:520-643)."""
    if not isinstance(program, QuantumProgram) or not isinstance(
            program.circuit_ref, Circuit):
        raise TypeError(
            "Input must be a QuantumProgram object with an executed "
            "circuit_ref for get_expval.")
    circuit = program.circuit_ref
    if not isinstance(hamiltonian, PauliOperator):
        raise TypeError("Input hamiltonian must be a rocQ PauliOperator object.")
    return circuit.expval(hamiltonian)  # handles the qubit layout


class Kernel:
    """A named circuit IR (reference api.py:646-652 holds an MLIR string)."""

    def __init__(self, name: str, ir: Optional[CircuitIR] = None,
                 mlir_string: str = ""):
        self.name = name
        self.ir = ir if ir is not None else CircuitIR(0, name=name)
        self.mlir_string = mlir_string or self.ir.dump()

    def __str__(self):
        return f"<Kernel name='{self.name}'>\n{self.ir.dump()}"


def adjoint(kern: Union[Kernel, Callable]) -> Union[Kernel, Callable]:
    """Adjoint of a kernel: reversed ops, each daggered (reference
    api.py:654-692, AdjointGeneration.cpp). Accepts a Kernel (returns a
    Kernel) or a @kernel function (returns a new @kernel function)."""
    if isinstance(kern, Kernel):
        adj_ir = adjoint_ir(kern.ir)
        return Kernel(name=f"{kern.name}.adj", ir=adj_ir)
    if callable(kern):
        base = getattr(kern, "__wrapped__", kern)

        def adj_func(q, *args):
            rec = _Recorder(q.num_qubits)
            base(rec, *args)
            ir = adjoint_ir(CircuitIR(q.num_qubits, rec.ops))
            for op in ir.ops:
                q._enqueue(op.name, op.targets, op.controls, op.params,
                           op.matrix, is_adjoint=op.is_adjoint)

        adj_func.__name__ = getattr(kern, "__name__", "kernel") + "_adj"
        return kernel(adj_func)
    raise TypeError("Input to adjoint must be a Kernel object or a @kernel "
                    "function.")


def grad(kernel_func: Callable, num_qubits: int, simulator: Simulator,
         initial_params: Sequence[float], observable: PauliOperator) -> np.ndarray:
    """Parameter-shift gradient, ported verbatim from the reference for
    API parity (api.py:694-734): dE/dθᵢ = 0.5·(E(θᵢ+π/2) − E(θᵢ−π/2)).
    Prefer :func:`adjoint_grad` — one reversible forward+backward sweep
    instead of 2P circuit executions."""
    if not hasattr(kernel_func, "generate_ir") and not callable(kernel_func):
        raise TypeError(
            "The function provided to grad() must be decorated with "
            "@rocq.kernel")
    gradients = []
    params = np.array(initial_params, dtype=float)
    for i in range(len(params)):
        params_plus = params.copy()
        params_plus[i] += np.pi / 2.0
        params_minus = params.copy()
        params_minus[i] -= np.pi / 2.0
        prog_plus = build(kernel_func, num_qubits, simulator, *params_plus)
        expval_plus = get_expval(prog_plus, observable)
        prog_minus = build(kernel_func, num_qubits, simulator, *params_minus)
        expval_minus = get_expval(prog_minus, observable)
        gradients.append(0.5 * (expval_plus - expval_minus))
    return np.array(gradients)


# ---------------------------------------------------------------------------
# Adjoint (reverse-mode) differentiation — the fast path
# ---------------------------------------------------------------------------

_ADJ_CACHE = BoundedCache()


def make_energy_fn(kernel_func: Callable, num_qubits: int,
                   hamiltonian: PauliOperator, num_params: int,
                   reversible: Optional[bool] = None, device=None):
    """``energy(params) -> 0-d float64 tensor`` for a kernel + Hamiltonian
    on ``device`` (default: the card); ``torch.autograd.grad`` of it, or
    ``.backward()``, is true adjoint differentiation: one forward and one
    backward sweep instead of 2P circuit executions.

    ``reversible`` (default: auto) selects the O(1)-memory backward sweep
    (autodiff.make_reversible_execute): intermediates are RECONSTRUCTED by
    inverse gates instead of stored, so memory stays a few state planes
    whatever the depth. In single precision it runs the fused kernel both
    ways; in double precision (``"double"`` and ``"df64"``, as the JAX
    package differentiates its exact float64 pair engine) the exact
    complex128 engine. Auto falls back to plain autograd (``energy``,
    autodiff.execute_plain) only when the kernel body cannot be traced
    with symbolic ParamRef arguments (it does host arithmetic on the
    parameters).
    """
    from . import autodiff

    device = torch.device(device) if device is not None \
        else default_device()
    exact = config.get_precision() == "double"
    if reversible is None or reversible:
        try:
            return autodiff.reversible_energy_fn(
                kernel_func, num_qubits, hamiltonian, num_params, device,
                exact)
        except (TypeError, AttributeError):
            # ParamRef has no arithmetic: the body computes on its
            # parameters
            if reversible:
                raise

    terms = tuple(tuple(ops) for ops, _ in hamiltonian.terms)
    coeffs = tuple(float(c) for _, c in hamiltonian.terms)
    func = getattr(kernel_func, "__wrapped__", kernel_func)

    def energy(param_vec):
        rec = _Recorder(num_qubits)
        func(rec, *[param_vec[i] for i in range(num_params)])
        state = autodiff.execute_plain(rec.ops, param_vec, num_qubits,
                                       device, config.complex_dtype())
        return pairsim.energy_pair(state.real, state.imag, terms, coeffs)

    return energy


def adjoint_grad(kernel_func: Callable, num_qubits: int, simulator: Simulator,
                 initial_params: Sequence[float], observable: PauliOperator,
                 return_value: bool = False):
    """Gradient by adjoint differentiation on the simulator's device: the
    energy function is made once per (kernel structure, observable,
    precision, device) and differentiated by ``torch.autograd.grad``.
    Returns numpy, as the JAX package does. A request of its own: the
    host span ``rq.grad``."""
    with profiling.span("rq.grad", request=profiling.NEW):
        values = np.asarray(initial_params, dtype=float)
        # Key on the kernel's traced circuit STRUCTURE, not id(func): id() is
        # reused after GC, so a new kernel could silently hit a dead kernel's
        # energy function. Tracing with concrete host params is cheap (pure
        # Python) and gives the exact structure energy() will re-trace.
        rec = _Recorder(num_qubits)
        func = getattr(kernel_func, "__wrapped__", kernel_func)
        func(rec, *[float(p) for p in values])
        ir_key = CircuitIR(num_qubits, rec.ops).structural_key()
        key = (ir_key, num_qubits, repr(observable), values.shape[0],
               config.get_precision(), str(simulator.device))
        fn = _ADJ_CACHE.get(key)
        if fn is None:
            fn = make_energy_fn(kernel_func, num_qubits, observable,
                                values.shape[0], device=simulator.device)
            _ADJ_CACHE[key] = fn
        params = torch.tensor(values, dtype=config.real_dtype(),
                              requires_grad=True)
        value = fn(params)
        (grads,) = torch.autograd.grad(value, params, allow_unused=True)
        grads = np.zeros(values.shape, params.dtype) if grads is None \
            else grads.numpy()
        if return_value:
            return float(value.detach()), grads
        return grads
