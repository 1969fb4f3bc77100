"""State-vector primitives the flush needs outside the fused kernel, in
plain torch on a flat ``(2^n,)`` complex64 state (the JAX package leaves
these to XLA: ``rocquantum_tpu/ops/statevec.py``).

Conventions (the reference's bit layout): index bit ``q`` is qubit ``q``,
qubit 0 the least significant; for multi-target matrices ``targets[0]`` is
the least significant bit of the matrix index. Every function returns a new
tensor.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def num_qubits_of(state: torch.Tensor) -> int:
    size = state.shape[-1]
    n = size.bit_length() - 1
    if (1 << n) != size:
        raise ValueError(f"state size {size} is not a power of two")
    return n


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
    desc = sorted(targets, reverse=True)
    axis_of = {q: 2 * i + 1 for i, q in enumerate(desc)}
    # matrix index MSB first: targets[m-1], ..., targets[0]
    src = [axis_of[targets[m - 1 - j]] for j in range(m)]
    rank = 2 * m + 1
    dst = list(range(rank - m, rank))
    view = state.reshape(exposed_view_dims(n, desc)).movedim(src, dst)
    shape = view.shape
    out = (view.reshape(-1, 1 << m) @ mat.T).reshape(shape)
    return out.movedim(dst, src).reshape(-1)


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
    view = out.view(exposed_view_dims(n, desc))
    idx = tuple(1 if i % 2 == 1 else slice(None) for i in range(view.dim()))
    sub = view[idx]
    remaining = [q for q in range(n) if q not in set(controls)]
    pos = {q: i for i, q in enumerate(remaining)}
    sub_new = apply_matrix(sub.reshape(-1), matrix, [pos[t] for t in targets])
    view[idx] = sub_new.view(sub.shape)
    return out


def swap_index_bits(state: torch.Tensor, q1: int, q2: int) -> torch.Tensor:
    """Exchange index bits q1 and q2 (a qubit relabel)."""
    if q1 == q2:
        return state
    n = num_qubits_of(state)
    desc = [max(q1, q2), min(q1, q2)]
    view = state.reshape(exposed_view_dims(n, desc))
    return view.transpose(1, 3).reshape(-1)
