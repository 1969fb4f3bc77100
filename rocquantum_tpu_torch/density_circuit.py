"""DensityCircuit: a gate and noise-channel queue over a density matrix.

Counterpart of ``rocquantum_tpu/density_circuit.py`` on one device
(no ``mesh``). rho is the flattened ``2^n x 2^n`` matrix, a 2n-qubit
"state" of ``(4^n,)`` float planes ``(re, im_or_None)`` with the ROW (ket)
bits high. A flush lowers every queued item to GateOps on that 2n-bit
view, in the order queued:

- a gate to a row op at ``q + n`` and a conjugated column op at ``q``
  (:func:`_gate_items_2n`; a gate without a named rule to a row
  ``UNITARY(m)`` and a column ``UNITARY(conj m)``);
- a one-qubit channel to the kernel kinds its superoperator factors into
  (ops/density.superop_kernel_ops: CNOT/U/CU/CNOT, one D2 diagonal, or two
  U), else one dense 4x4 on ``(q, q + n)``; a wider Kraus channel to its
  dense superoperator.

The precision at rho's creation fixes its planes, as for ``Circuit``. In
single precision the 2n-view IR runs through ``compile_pair32_ir``: its
kernel blocks launch the fused kernel, rho starts as the fill kernel's
real plane and stays single-plane (``im`` None) while every op is real.
Under ``set_precision("df64")`` the same IR runs through
``compile_df64_fused_ir`` on a float64 pair; under ``"double"`` the exact
engine (ops/pairdm.py) applies every item on complex128. Gate angles with
a conjugation rule are runtime parameters (the column side's sign flips
become extra entries), so flushes that differ only in angles share one
plan; channel probabilities and matrices are part of the plan.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import config
from .api import (PauliOperator, Simulator, _engine, _GateMethods,
                  _restore_sharded, _schedule, check_mesh)
from .compiler.interpreter import _split_op, parametrize
from .compiler.ir import CircuitIR, GateOp, ParamRef
from .ops import gates as _g
from .ops import pairdm, pairsim
from .parallel import sharded
from .ops.density import (CHANNELS, channel_kraus, kraus_superoperator,
                          superop_kernel_ops)
from .utils.cache import BoundedCache

# flush plans by queue structure: (run, ref_map, 2n-view IR)
_DM_PLAN_CACHE = BoundedCache()

# conjugation rules for named gates (U rho U†: the COLUMN side applies
# conj(U); with the op's is_adjoint flag kept, (conj U)† == conj(U†))
_CONJ_SELF = {"H", "X", "Z", "RY", "CRY", "CNOT", "CX", "CZ", "SWAP",
              "MCX", "CCX", "TOFFOLI", "CSWAP", "I", "ID"}
_CONJ_NAME = {"S": "SDG", "SDG": "S", "T": "TDG", "TDG": "T"}
_CONJ_NEGATE = {"RX", "RZ", "P", "PHASE", "CRX", "CRZ"}


def _slot_rule(name, vals, mat_key):
    """Which runtime-parameter rule a parameterized gate's column side
    uses ("self", "negate", "u3"), or None when its values stay baked into
    the plan (matrix gates, names without a sign rule)."""
    if not vals or mat_key is not None:
        return None
    key = name.upper()
    if key in _CONJ_SELF:
        return "self"
    if key in _CONJ_NEGATE:
        return "negate"
    if key == "U3" and len(vals) == 3:
        return "u3"
    return None


def _gate_items_2n(n, name, tgt, ctrl, vals, mat_key, adj):
    """(row_op, col_op) GateOps on the 2n-bit view of rho, or (None, None)
    when the gate has no named conjugation rule."""
    row_t = tuple(q + n for q in tgt)
    row_c = tuple(q + n for q in ctrl)
    if mat_key is not None:
        m = _matrix_of(mat_key)
        row = GateOp("UNITARY", row_t, row_c, (), m, adj)
        col = GateOp("UNITARY", tuple(tgt), tuple(ctrl), (), np.conj(m), adj)
        return row, col
    key = name.upper()
    row = GateOp(key, row_t, row_c, tuple(vals), None, adj)
    if key in _CONJ_SELF:
        return row, GateOp(key, tuple(tgt), tuple(ctrl), tuple(vals), None,
                           adj)
    if key in _CONJ_NAME:
        return row, GateOp(_CONJ_NAME[key], tuple(tgt), tuple(ctrl), (),
                           None, adj)
    if key in _CONJ_NEGATE:
        return row, GateOp(key, tuple(tgt), tuple(ctrl),
                           tuple(-v for v in vals), None, adj)
    if key == "Y":
        return row, GateOp("UNITARY", tuple(tgt), tuple(ctrl), (),
                           np.conj(np.array([[0, -1j], [1j, 0]])), adj)
    if key == "U3" and len(vals) == 3:
        return row, GateOp(key, tuple(tgt), tuple(ctrl),
                           (vals[0], -vals[1], -vals[2]), None, adj)
    return None, None


def _dense_items_2n(n, name, tgt, ctrl, vals, adj):
    """(row_op, col_op) for a gate without a conjugation rule: its matrix
    m as a row ``UNITARY(m)`` and a column ``UNITARY(conj m)``, the
    adjoint flag kept."""
    base, controls, targets = _split_op(GateOp(name, tuple(tgt), tuple(ctrl)))
    m = _g.gate_matrix(base, vals)
    row = GateOp("UNITARY", tuple(t + n for t in targets),
                 tuple(c + n for c in controls), (), m, adj)
    col = GateOp("UNITARY", tuple(targets), tuple(controls), (), np.conj(m),
                 adj)
    return row, col


def _kraus_ops_2n(ks, tgt, n) -> List[GateOp]:
    """A Kraus channel on ``tgt`` as 2n-view ops: the kernel kinds of a
    one-qubit superoperator that factors, else one dense superoperator on
    ``tgt + (tgt + n)``."""
    s = kraus_superoperator(ks)
    fops = superop_kernel_ops(s, tgt[0], tgt[0] + n) if len(tgt) == 1 \
        else None
    if fops is not None:
        return fops
    return [GateOp("UNITARY", tuple(tgt) + tuple(q + n for q in tgt), (),
                   (), s)]


def _item_ops_2n(item, n) -> List[GateOp]:
    """The 2n-view GateOps of one queue item, with concrete parameters."""
    kind = item[0]
    if kind == "gate":
        _, name, tgt, ctrl, vals, mat_key, adj = item
        row, col = _gate_items_2n(n, name, tgt, ctrl, vals, mat_key, adj)
        if row is None:
            row, col = _dense_items_2n(n, name, tgt, ctrl, vals, adj)
        return [row, col]
    if kind == "channel":
        _, channel, prob, tgt = item
        ks = channel_kraus(channel, prob)
        return [op for q in tgt for op in _kraus_ops_2n(ks, (q,), n)]
    _, mats, tgt = item
    return _kraus_ops_2n(_kraus_of(mats), tgt, n)


def _matrix_of(mat_key) -> np.ndarray:
    """A queued matrix (bytes, shape) as a writable complex128 array."""
    m = np.frombuffer(mat_key[0], np.complex128).reshape(mat_key[1])
    return m.copy()


def _kraus_of(mats):
    return [_matrix_of(m) for m in mats]


def _build_plan(queue, n: int, engine):
    """(run, ref_map, ir) for a queue: its 2n-view IR, compiled by
    ``engine`` (api._engine's "pair32" or "df64"). Gates with a slot rule
    take ParamRefs; ``ref_map`` says which hoisted queue value, with which
    sign, fills each slot."""
    ref_map: List[Tuple[int, float]] = []  # param[j] = sign * qvalues[i]
    base = 0  # position in the hoisted queue-values vector
    ops = []
    for item in queue:
        rule = _slot_rule(item[1], item[4], item[5]) \
            if item[0] == "gate" else None
        if rule is None:
            ops.extend(_item_ops_2n(item, n))
            continue
        _, name, tgt, ctrl, vals, _, adj = item
        key = name.upper()
        row_refs = []
        for j in range(len(vals)):
            ref_map.append((base + j, 1.0))
            row_refs.append(ParamRef(len(ref_map) - 1))
        row_refs = tuple(row_refs)
        if rule == "self":
            col_refs = row_refs
        elif rule == "negate":
            col_refs = []
            for j in range(len(vals)):
                ref_map.append((base + j, -1.0))
                col_refs.append(ParamRef(len(ref_map) - 1))
            col_refs = tuple(col_refs)
        else:  # u3: col = (v0, -v1, -v2)
            ref_map.append((base + 1, -1.0))
            ref_map.append((base + 2, -1.0))
            col_refs = (row_refs[0], ParamRef(len(ref_map) - 2),
                        ParamRef(len(ref_map) - 1))
        base += len(vals)
        ops.append(GateOp(key, tuple(q + n for q in tgt),
                          tuple(q + n for q in ctrl), row_refs, None, adj))
        ops.append(GateOp(key, tuple(tgt), tuple(ctrl), col_refs, None, adj))
    ir = CircuitIR(2 * n, ops)
    return engine.compile(ir), tuple(ref_map), ir


def _flush_exact(queue, rho, n: int):
    """The exact double engine: every item in order on the complex128
    rho (ops/pairdm.py). Returns the full float64 pair."""
    state = pairdm.to_complex(*rho)
    for item in queue:
        kind = item[0]
        if kind == "gate":
            _, name, tgt, ctrl, vals, mat_key, adj = item
            mat = None if mat_key is None else _matrix_of(mat_key)
            state = pairdm.apply_op_dm(
                state, GateOp(name, tgt, ctrl, vals, mat, adj), n)
        elif kind == "channel":
            _, channel, prob, tgt = item
            ks = channel_kraus(channel, prob)
            for q in tgt:
                state = pairdm.apply_kraus_at_dm(state, ks, [q + n], [q])
        else:
            _, mats, tgt = item
            state = pairdm.apply_kraus_at_dm(state, _kraus_of(mats),
                                             [q + n for q in tgt], list(tgt))
    return pairdm.to_planes(state)


class DensityCircuit(_GateMethods):
    """Gate and channel queue over a density matrix on ``device`` (default:
    the simulator's); ``flush`` runs the queue through one cached plan per
    queue structure (reference DensityCircuit, density_circuit.py:152).

    With ``mesh`` (a ``parallel.Mesh`` with an ``sv`` axis) rho's 2n-bit
    view is sharded over it, the top index bits (high row qubits)
    selecting the shard: a flush lowers the queue to its 2n-view ops,
    schedules them for locality (``schedule_for_sharding(ops, 2n, M,
    layout)``, the layout kept across flushes; a non-factoring channel's
    dense superoperator is an op like any gate, a factored phase flip a
    diagonal that moves nothing) and runs them shard by shard: complex64
    rho through ``compile_ir(sharding=...)`` in single precision, the df64
    engine or the exact one in double. Readouts restore the identity
    layout (one merged relabel) and read per-shard partials."""

    def __init__(self, num_qubits: int, simulator: Simulator,
                 noise_model=None, mesh=None, device=None):
        if not isinstance(simulator, Simulator):
            raise TypeError("A valid Simulator instance is required.")
        if num_qubits < 0:
            raise ValueError("Number of qubits must be non-negative.")
        self.num_qubits = num_qubits
        self.simulator = simulator
        self.noise_model = noise_model
        self.batch_size = 1
        self.mesh = mesh
        self._layout2n: List[int] = list(range(2 * num_qubits))
        if mesh is not None:
            check_mesh(mesh)
            n_global = sharded.num_global_qubits(mesh)
            if n_global >= 2 * num_qubits:
                raise ValueError(
                    f"mesh has {n_global} device-selecting bits but rho has "
                    f"only {2 * num_qubits} index bits")
        self.device = torch.device(device) if device is not None \
            else simulator.device
        self._queue: List[tuple] = []
        self._rho = None  # (re, im_or_None), made at first use
        # the 2n-view IR of the last fused flush (None before one)
        self.last_ir: Optional[CircuitIR] = None

    def _sharding(self):
        return None if self.mesh is None else \
            sharded.state_sharding(self.mesh)

    # -- queueing -------------------------------------------------------------

    def _enqueue(self, name, targets, controls=(), params=(), matrix=None,
                 is_adjoint=False):
        mat_key = None
        if matrix is not None:
            m = np.ascontiguousarray(matrix, np.complex128)
            mat_key = (m.tobytes(), m.shape)
        self._queue.append(("gate", name.upper(), tuple(targets),
                            tuple(controls),
                            tuple(float(p) for p in params), mat_key,
                            bool(is_adjoint)))
        if self.noise_model is not None:
            for ch in self.noise_model.get_channels():
                if ch["op"] is not None and ch["op"] != name.lower():
                    continue
                qs = ch["qubits"] if ch["qubits"] is not None else \
                    list(targets) + list(controls)
                self.apply_channel(ch["type"], ch["prob"], qs)

    def apply_channel(self, channel_type: str, probability: float,
                      qubits: List[int]):
        """Queue a named noise channel on each of ``qubits``."""
        if channel_type.lower() not in CHANNELS:
            raise ValueError(f"Unknown noise channel: {channel_type!r}")
        self._queue.append(("channel", channel_type.lower(),
                            float(probability), tuple(qubits)))

    def apply_kraus(self, kraus_ops, qubits: List[int]):
        """Queue a channel given by its Kraus operators on ``qubits``
        (``qubits[0]`` the least significant bit of their index)."""
        mats = tuple((np.ascontiguousarray(k, np.complex128).tobytes(),
                      np.asarray(k).shape) for k in kraus_ops)
        self._queue.append(("kraus", mats, tuple(qubits)))

    # -- execution ------------------------------------------------------------

    def _engine(self, f64: Optional[bool] = None):
        """api._engine of rho's 2n-qubit view (``f64``: rho's own)."""
        return _engine(2 * self.num_qubits, self.device,
                       sharding=self._sharding(), f64=f64)

    def _init_rho(self):
        """|0...0><0...0| in the precision set now: a real float32 plane
        (the fill kernel on CUDA), a real float64 plane for the df64
        engine, else the full float64 pair of the exact engine."""
        return self._engine().zero()

    def _plan_key(self, queue, mode):
        """(plan key, hoisted queue values): slot-rule gate angles leave
        the key; channel probabilities and matrix bytes stay in it."""
        parts, values = [], []
        for item in queue:
            if item[0] == "gate" and _slot_rule(item[1], item[4], item[5]):
                parts.append(item[:4] + (("slots", len(item[4])),)
                             + item[5:])
                values.extend(item[4])
            else:
                parts.append(item)
        return (tuple(parts), self.num_qubits, mode), values

    def flush(self):
        if self._rho is None:
            self._rho = self._init_rho()
        if not self._queue:
            return
        queue, self._queue = list(self._queue), []
        if self.mesh is not None:
            self._flush_sharded(queue)
            return
        engine = self._engine(f64=self._rho[0].dtype == torch.float64)
        if engine.name == "exact":
            self._rho = _flush_exact(queue, self._rho, self.num_qubits)
            return
        key, qvalues = self._plan_key(queue, engine.name)
        plan = _DM_PLAN_CACHE.get(key)
        if plan is None:
            plan = _build_plan(queue, self.num_qubits, engine)
            _DM_PLAN_CACHE[key] = plan
        run, ref_map, self.last_ir = plan
        params = np.asarray([s * qvalues[i] for i, s in ref_map],
                            engine.dtype)
        self._rho = tuple(run(self._rho, params))

    def _flush_sharded(self, queue):
        """The sharded flush: the queue's 2n-view ops, parametrized and
        scheduled for locality, run on the sharded rho."""
        n2 = 2 * self.num_qubits
        ops = [op for item in queue for op in _item_ops_2n(item,
                                                           self.num_qubits)]
        ops, values = parametrize(ops)
        sharding = self._sharding()
        ops, self._layout2n = _schedule(ops, n2, sharding.n_global,
                                        self._layout2n)
        self.last_ir = CircuitIR(n2, ops)
        engine = self._engine(f64=not self._rho.parts[0][0].is_complex())
        self._rho = engine.compile(self.last_ir)(
            self._rho, np.asarray(values, engine.dtype))

    def _restore_layout(self):
        """Undo the locality relabels (one merged relabel), so readouts
        address logical bits."""
        if self._layout2n != list(range(2 * self.num_qubits)):
            self._rho = _restore_sharded(self._rho, self._layout2n)
            self._layout2n = list(range(2 * self.num_qubits))

    def _ready(self):
        """Flush; on a mesh also restore the identity layout."""
        self.flush()
        if self.mesh is not None:
            self._restore_layout()

    def _diagonal(self) -> torch.Tensor:
        """diag(rho), float64 (from the shards that hold it, on a
        mesh)."""
        n = self.num_qubits
        if self.mesh is None:
            return pairdm.probabilities_pair_dm(self._rho[0], n)
        r = torch.arange(1 << n)
        return sharded.take(self._rho, (r << n) | r)[0]

    @property
    def state(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """rho as float planes ``(re, im_or_None)`` of the flattened
        ``(4^n,)`` view, row bits high (the JAX package returns one complex
        array, or its double engine's pair); ``im`` is None while rho is
        real. Kernel passes update these planes in place at the next
        flush. On a mesh, the sharded rho in the identity layout."""
        self._ready()
        return self._rho

    def reset(self):
        """Back to |0...0><0...0|, in the precision set now."""
        self._queue.clear()
        self._layout2n = list(range(2 * self.num_qubits))
        self._rho = None
        self._rho = self._init_rho()

    # -- measurement / readback ----------------------------------------------

    def measure(self, qubit: int) -> Tuple[int, float]:
        """Projective measurement of one qubit: (outcome, its probability);
        rho collapses. The draw is the simulator's host random number, so
        one seed gives the JAX package's outcomes."""
        self._ready()
        self._validate_qubit_index(qubit)
        n = self.num_qubits
        if self.mesh is not None:
            probs = self._diagonal()
            p1 = float(probs.view(1 << (n - 1 - qubit), 2,
                                  1 << qubit)[:, 1].sum())
            outcome = 1 if self.simulator.host_random() < p1 else 0
            sharded.project(self._rho, qubit + n, outcome)
            sharded.project(self._rho, qubit, outcome)
            trace = float(self._diagonal().sum())
            sharded.scale(self._rho, 1.0 / max(trace, config.eps()))
            return outcome, (p1 if outcome == 1 else 1.0 - p1)
        re, im = self._rho
        p1 = float(pairdm.prob_one_pair_dm(re, qubit, n))
        outcome = 1 if self.simulator.host_random() < p1 else 0
        self._rho = pairdm.collapse_pair_dm(re, im, qubit, outcome, n)
        return outcome, (p1 if outcome == 1 else 1.0 - p1)

    def sample(self, measured_qubits: List[int], num_shots: int) -> np.ndarray:
        """Shots over ``measured_qubits`` (qubits[0] the least significant
        bit of each outcome), int32, drawn on the device."""
        self._ready()
        if not measured_qubits:
            raise ValueError("List of measured_qubits cannot be empty.")
        for idx in measured_qubits:
            self._validate_qubit_index(idx, f"measured_qubits element {idx}")
        if num_shots <= 0:
            raise ValueError("Number of shots must be positive.")
        marg = pairdm.marginal_probs(self._diagonal(), tuple(measured_qubits),
                                     self.num_qubits)
        out = pairsim.sample_marginal(marg, num_shots,
                                      self.simulator.generator(marg.device))
        return out.cpu().numpy()

    def get_density_matrix(self) -> np.ndarray:
        """rho as a complex128 ``(2^n, 2^n)`` host array, row index high."""
        self._ready()
        dim = 1 << self.num_qubits
        rho = self._rho
        if self.mesh is not None:
            rho = sharded._as_pair(sharded.gather(rho))
        re, im = rho
        out = re.reshape(dim, dim).cpu().numpy().astype(np.complex128)
        if im is not None:
            out += 1j * im.reshape(dim, dim).cpu().numpy()
        return out

    def purity(self) -> float:
        self.flush()
        if self.mesh is not None:
            # basis-independent: no layout restore needed
            return float(sharded.norm2(self._rho))
        return float(pairdm.purity_pair_dm(*self._rho))

    def expval(self, pauli_operator: PauliOperator) -> float:
        """Tr(H rho) for a PauliOperator, from the 2^n entries each term
        reads, accumulated in float64."""
        if not isinstance(pauli_operator, PauliOperator):
            raise TypeError("Input must be a PauliOperator object.")
        self._ready()
        terms = [tuple(ops) for ops, _ in pauli_operator.terms]
        coeffs = [float(c) for _, c in pauli_operator.terms]
        n = self.num_qubits
        if self.mesh is None:
            return float(pairdm.expval_terms_pair_dm(*self._rho, terms,
                                                     coeffs, n))
        total = 0.0
        for term, c in zip(terms, coeffs):
            if all(p == "Z" for p, _ in term):
                # a repeated qubit counts once, as in the JAX package
                term = [("Z", q) for q in sorted({int(q) for _, q in term})]
            idx, sign, phase = pairdm.pauli_entries(term, n)
            re_v, im_v = sharded.take(self._rho, idx)
            total += c * float(pairdm.pauli_value(re_v, im_v,
                                                  sign.to(re_v.device),
                                                  phase))
        return total
