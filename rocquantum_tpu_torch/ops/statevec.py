"""State-vector primitives on a flat ``(2^n,)`` complex tensor, in plain
torch on the device that holds it: gate application, measurement,
collapse, marginals, sampling and expectations (the JAX package's
``rocquantum_tpu/ops/statevec.py``, which it leaves to XLA).

Conventions (the reference's bit layout): index bit ``q`` is qubit ``q``,
qubit 0 the least significant; for multi-target matrices ``targets[0]`` is
the least significant bit of the matrix index. Every function returns a new
tensor. Views expose only the qubits an operation touches
(:func:`exposed_view_dims`), so a view's rank stays 2m+1 for m qubits
whatever n is. Sums accumulate in float64 and the readouts return float64
values; draws take an explicit ``torch.Generator`` and are int32, as the JAX
package's.

A state may carry a leading batch axis, ``(b, 2^n)`` for b states (any b
>= 1), where the JAX package vmaps the unbatched function: gates apply to
every element (the batch folds into the top axis of a view and is never
read as qubits), and readouts return one value, row or draw set per
element.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import config
from . import gates as _g

_F64 = torch.float64


def num_qubits_of(state: torch.Tensor) -> int:
    size = state.shape[-1]
    n = size.bit_length() - 1
    if (1 << n) != size:
        raise ValueError(f"state size {size} is not a power of two")
    return n


def view_dims(state: torch.Tensor, qubits_desc: Sequence[int]) -> List[int]:
    """:func:`exposed_view_dims` of the state with its batch (if any)
    folded into the top axis."""
    n = num_qubits_of(state)
    dims = exposed_view_dims(n, qubits_desc)
    dims[0] *= state.numel() >> n
    return dims


def _default_device():
    from ..api import default_device
    return default_device()


def init_state(num_qubits: int, dtype=None, device=None) -> torch.Tensor:
    """|0...0> as a flat complex tensor (``dtype`` defaults to the
    precision's complex type, ``device`` to the card)."""
    return basis_state(num_qubits, 0, dtype, device)


def basis_state(num_qubits: int, index: int, dtype=None,
                device=None) -> torch.Tensor:
    """The computational basis state ``|index>``."""
    state = torch.zeros(1 << num_qubits, dtype=dtype or config.complex_dtype(),
                        device=device if device is not None
                        else _default_device())
    state[index] = 1.0
    return state


def exposed_view_dims(n: int, qubits_desc: Sequence[int]) -> List[int]:
    """Shape exposing each qubit of ``qubits_desc`` (strictly descending)
    as its own size-2 axis, with flat axes between: [2^(n-1-q_a), 2,
    2^(q_a-q_b-1), 2, ..., 2, 2^q_last]. Qubit ``qubits_desc[i]`` is axis
    ``2 i + 1``. The rank stays 2m+1 for m qubits whatever n is."""
    dims = []
    prev = n
    for q in qubits_desc:
        dims.append(1 << (prev - 1 - q))
        dims.append(2)
        prev = q
    dims.append(1 << prev)
    return dims


def apply_matrix(state: torch.Tensor, matrix: torch.Tensor,
                 targets: Sequence[int]) -> torch.Tensor:
    """Apply a dense ``2^m x 2^m`` matrix to ``targets``."""
    targets = list(targets)
    n = num_qubits_of(state)
    m = len(targets)
    if len(set(targets)) != m:
        raise ValueError(f"duplicate target qubits: {targets}")
    if tuple(matrix.shape) != (1 << m, 1 << m):
        raise ValueError(f"matrix shape {tuple(matrix.shape)} != "
                         f"{(1 << m, 1 << m)}")
    mat = torch.as_tensor(matrix, dtype=state.dtype, device=state.device)
    # the consolidated low and high blocks: one matmul on a plain view
    if targets == list(range(m)):
        return (state.reshape(-1, 1 << m) @ mat.T).reshape(state.shape)
    if targets == list(range(n - m, n)):
        return (mat @ state.reshape(-1, 1 << m, 1 << (n - m))).reshape(
            state.shape)
    desc = sorted(targets, reverse=True)
    axis_of = {q: 2 * i + 1 for i, q in enumerate(desc)}
    # matrix index MSB first: targets[m-1], ..., targets[0]
    src = [axis_of[targets[m - 1 - j]] for j in range(m)]
    rank = 2 * m + 1
    dst = list(range(rank - m, rank))
    view = state.reshape(view_dims(state, desc)).movedim(src, dst)
    shape = view.shape
    out = (view.reshape(-1, 1 << m) @ mat.T).reshape(shape)
    return out.movedim(dst, src).reshape(state.shape)


def apply_controlled_matrix(state: torch.Tensor, matrix: torch.Tensor,
                            controls: Sequence[int],
                            targets: Sequence[int]) -> torch.Tensor:
    """Apply ``matrix`` to ``targets`` where every control is 1: the
    control-active 1/2^c of the amplitudes is sliced out, updated and
    written back."""
    controls = list(controls)
    targets = list(targets)
    if set(controls) & set(targets):
        raise ValueError("control and target qubits overlap")
    if not controls:
        return apply_matrix(state, matrix, targets)
    n = num_qubits_of(state)
    desc = sorted(controls, reverse=True)
    out = state.clone()
    view = out.view(view_dims(out, desc))
    idx = tuple(1 if i % 2 == 1 else slice(None) for i in range(view.dim()))
    sub = view[idx]
    remaining = [q for q in range(n) if q not in set(controls)]
    pos = {q: i for i, q in enumerate(remaining)}
    sub_new = apply_matrix(sub.reshape(state.shape[:-1] + (-1,)), matrix,
                           [pos[t] for t in targets])
    view[idx] = sub_new.reshape(sub.shape)
    return out


def swap_index_bits(state: torch.Tensor, q1: int, q2: int) -> torch.Tensor:
    """Exchange index bits q1 and q2 (a qubit relabel)."""
    if q1 == q2:
        return state
    desc = [max(q1, q2), min(q1, q2)]
    view = state.reshape(view_dims(state, desc))
    return view.transpose(1, 3).reshape(state.shape)


def permute_index_bits(state: torch.Tensor, dsts: Sequence[int],
                       srcs: Sequence[int]) -> torch.Tensor:
    """Composed multi-bit relabel: new index bit ``dsts[i]`` takes the
    value of old index bit ``srcs[i]`` (``dsts`` and ``srcs`` are the same
    set). One view transpose, one copy, where the equivalent chain of
    :func:`swap_index_bits` makes one copy per swap."""
    dsts = tuple(int(d) for d in dsts)
    srcs = tuple(int(s) for s in srcs)
    if dsts == srcs:
        return state
    if sorted(dsts) != sorted(srcs):
        raise ValueError(f"permutation mismatch: {dsts} vs {srcs}")
    touched = sorted(set(dsts), reverse=True)
    dims = view_dims(state, touched)
    axis_of = {b: 2 * j + 1 for j, b in enumerate(touched)}
    perm = list(range(len(dims)))
    for d, s in zip(dsts, srcs):
        perm[axis_of[d]] = axis_of[s]
    return state.reshape(dims).permute(perm).reshape(state.shape)


def apply_gate(state: torch.Tensor, name: str, targets: Sequence[int],
               controls: Sequence[int] = (),
               params: Sequence = ()) -> torch.Tensor:
    """Apply a named gate (the rocsvApplyH/X/.../CRZ family). CNOT/CZ take
    ``[control, target]`` as ``targets`` when ``controls`` is empty."""
    name = name.upper()
    controls, targets = list(controls), list(targets)
    if name in ("CNOT", "CX", "CZ"):
        c, t = (controls + targets) if controls else targets
        return apply_controlled_matrix(state, _g.X if name != "CZ" else _g.Z,
                                       [c], [t])
    if name in ("MCX", "CCX", "TOFFOLI"):
        return apply_controlled_matrix(state, _g.X, controls, targets)
    if name == "CSWAP":
        return apply_controlled_matrix(state, _g.SWAP, controls, targets)
    if name in ("CRX", "CRY", "CRZ"):
        name = name[1:]
    return apply_controlled_matrix(state, _g.gate_matrix(name, params),
                                   controls, targets)


# ---------------------------------------------------------------------------
# Measurement, collapse, sampling
# ---------------------------------------------------------------------------

def _abs2(state: torch.Tensor) -> torch.Tensor:
    """|amplitude|^2 in the state's real dtype."""
    return state.real.square() + state.imag.square()


def _bit_view(state: torch.Tensor, qubit: int) -> torch.Tensor:
    """The state as (batch..., high bits, qubit, low bits)."""
    n = num_qubits_of(state)
    return state.reshape(state.shape[:-1]
                         + (1 << (n - 1 - qubit), 2, 1 << qubit))


def prob_one(state: torch.Tensor, qubit: int) -> torch.Tensor:
    """P(qubit = 1), float64: 0-d, or ``(b,)`` for a batch."""
    return torch.sum(_abs2(_bit_view(state, qubit)[..., 1, :]),
                     dim=(-2, -1), dtype=_F64)


def _renormalized(keep: torch.Tensor) -> torch.Tensor:
    """``keep`` (batch..., high bits, 1 or 2, low bits) over its norm per
    element, guarded by the precision's eps."""
    norm = torch.sqrt(torch.sum(_abs2(keep), dim=(-3, -2, -1), dtype=_F64,
                                keepdim=True))
    inv = 1.0 / torch.clamp(norm, min=config.eps())
    return keep * inv.to(keep.real.dtype)


def collapse(state: torch.Tensor, qubit: int, outcome: int) -> torch.Tensor:
    """Project onto ``qubit = outcome`` and renormalize (every element of
    a batch onto the same outcome)."""
    st = _bit_view(state, qubit)
    o = int(outcome)
    out = torch.zeros_like(st)
    out[..., o:o + 1, :] = _renormalized(st[..., o:o + 1, :])
    return out.reshape(state.shape)


def collapse_dyn(state: torch.Tensor, qubit: int,
                 outcome: torch.Tensor) -> torch.Tensor:
    """:func:`collapse` with the outcome (0 or 1) as a tensor, read on the
    device: no host synchronization. A batch takes one outcome per element
    (``(b,)``)."""
    st = _bit_view(state, qubit)
    lead = st.shape[:-3]
    idx = torch.as_tensor(outcome, device=state.device).to(torch.int64)
    idx = idx.reshape(lead + (1, 1, 1)).expand(
        lead + (st.shape[-3], 1, st.shape[-1]))
    out = torch.zeros_like(st)
    out.scatter_(-2, idx, _renormalized(st.gather(-2, idx)))
    return out.reshape(state.shape)


def marginal_probs(state: torch.Tensor,
                   qubits: Sequence[int]) -> torch.Tensor:
    """Marginal probability vector over ``qubits`` (``qubits[0]`` the least
    significant bit of the outcome index), float64; ``(b, 2^k)`` rows for a
    batch.

    The index bits are cut into runs from the top down: a run of dropped
    bits, or of kept bits that are also consecutive in ``qubits``. The
    probabilities are viewed with one axis a run, the dropped axes summed
    out and the kept ones put in output order, so the rank stays small
    however many qubits are kept (the full register in order is one
    axis)."""
    qubits = [int(q) for q in qubits]
    n = num_qubits_of(state)
    pos = {q: j for j, q in enumerate(qubits)}
    if len(pos) != len(qubits):
        raise ValueError(f"duplicate qubits: {qubits}")
    runs = []  # [kept, bits, output bit of the run's lowest qubit]
    for q in range(n - 1, -1, -1):
        kept = q in pos
        if runs and runs[-1][0] == kept and (
                not kept or pos[q] == runs[-1][2] - 1):
            runs[-1][1] += 1
            runs[-1][2] = pos.get(q)
            continue
        runs.append([kept, 1, pos.get(q)])
    lead = tuple(state.shape[:-1])
    t = _abs2(state).reshape(lead + tuple(1 << bits for _, bits, _ in runs))
    drop = [len(lead) + i for i, r in enumerate(runs) if not r[0]]
    t = t.sum(dim=drop, dtype=_F64) if drop else t.to(_F64)
    kept_at = [r[2] for r in runs if r[0]]
    order = sorted(range(len(kept_at)), key=lambda i: -kept_at[i])
    order = list(range(len(lead))) + [len(lead) + i for i in order]
    return t.permute(order).reshape(lead + (-1,))


def sample(state: torch.Tensor, qubits: Sequence[int], shots: int,
           generator: torch.Generator) -> torch.Tensor:
    """``shots`` outcomes over ``qubits`` (int32) drawn from the marginal
    by inverse-CDF search on the state's device (``torch.multinomial``
    takes at most 2^24 categories); ``(b, shots)``, drawn independently per
    element, for a batch."""
    from .pairsim import sample_marginal
    return sample_marginal(marginal_probs(state, qubits), shots, generator)


# ---------------------------------------------------------------------------
# Expectation values
# ---------------------------------------------------------------------------

def expval_z(state: torch.Tensor, qubit: int) -> torch.Tensor:
    """<Z_q> = P(0) - P(1)."""
    return 1.0 - 2.0 * prob_one(state, qubit)


def expval_pauli_product_z(state: torch.Tensor,
                           qubits: Sequence[int]) -> torch.Tensor:
    """<Z_{q1} Z_{q2} ...>: the probabilities signed by the parity of
    ``qubits``."""
    from .pairsim import expval_pauli_product_z_pair
    return expval_pauli_product_z_pair(state.real, state.imag, qubits)


def apply_pauli_string(state: torch.Tensor,
                       ops: Sequence[tuple]) -> torch.Tensor:
    """Apply a product of one-qubit Paulis ``[(char, qubit), ...]``."""
    for ch, q in ops:
        if ch != "I":
            state = apply_matrix(state, _g.PAULI[ch], [q])
    return state


def expval_pauli_string(state: torch.Tensor,
                        ops: Sequence[tuple]) -> torch.Tensor:
    """<psi| P |psi> for a Pauli string ``[(char, qubit), ...]``."""
    from .pairsim import expval_pauli_string_pair
    return expval_pauli_string_pair(state.real, state.imag,
                                    [(ch, int(q)) for ch, q in ops])


def expval_x(state: torch.Tensor, qubit: int) -> torch.Tensor:
    return expval_pauli_string(state, [("X", qubit)])


def expval_y(state: torch.Tensor, qubit: int) -> torch.Tensor:
    return expval_pauli_string(state, [("Y", qubit)])


def apply_matrix_and_measure(state: torch.Tensor, matrix,
                             targets: Sequence[int], measure_qubit: int):
    """(state after ``matrix``, P(measure_qubit = 1))."""
    state = apply_matrix(state, matrix, targets)
    return state, prob_one(state, measure_qubit)


# ---------------------------------------------------------------------------
# Float planes
# ---------------------------------------------------------------------------

def state_slice_parts(state: torch.Tensor, start: int, size: int):
    """(real, imag) of amplitudes [start, start + size) (of each
    element)."""
    sl = state[..., start:start + size]
    return sl.real, sl.imag


def state_to_parts(state: torch.Tensor):
    """The state as contiguous (real, imag) planes."""
    return state.real.contiguous(), state.imag.contiguous()


def parts_to_state(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re, im)
