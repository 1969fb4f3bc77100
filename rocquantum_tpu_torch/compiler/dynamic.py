"""Shot-batched execution of dynamic (measurement + classical control)
QASM programs: the counterpart of ``rocquantum_tpu/compiler/dynamic.py``.

The reference ran dynamic circuits only through the Python API
(examples/dynamic_circuit_example.py): measure synchronously, branch on the
host. Here a whole shot ensemble runs as ONE batched simulation: each batch
element is one shot, mid-circuit measurements collapse per element
(Circuit.measure's batched path, one host draw per shot in element order,
so a seed gives the JAX package's outcomes), and conditioned gates apply
to the whole batch and are kept, per element, where the shot's condition
holds (a ``torch.where`` select): no per-shot Python loop, and the card
runs the batched fused-kernel passes of the unconditioned gates.

A 1-shot ensemble is an unbatched Circuit, whose state is a float pair
``(re, im)`` (``im`` None while it is real); a conditioned gate there runs
on the pair's complex form and returns the full pair.
"""

from __future__ import annotations

import warnings
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .interpreter import apply_op, run_ops_f64
from .qasm_parser import Cond, DynamicProgram, Measure, Switch, While


def _select(flag, new, old):
    """``new`` where ``flag`` holds, else ``old``: one plane, a batch of
    rows against ``(b,)`` flags, or None planes (a real carry)."""
    if new is None and old is None:
        return None
    if new is None:
        new = torch.zeros_like(old)
    if old is None:
        old = torch.zeros_like(new)
    if flag.dim():
        flag = flag.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(flag, new, old)


def _apply_conditional(state_b, flags: np.ndarray, ops):
    """Apply ``ops`` to the batch elements where ``flags`` is True. A
    1-shot ensemble holds an UNBATCHED state (Circuit batch_size == 1): the
    float pair, f32 (im None while real) or float64 under double
    precision; a batch is a complex64 ``(b, 2^n)`` tensor or a float64
    pair of ``(b, 2^n)`` planes."""
    if isinstance(state_b, tuple):
        re, im = state_b
        f = torch.as_tensor(flags, device=re.device)
        if re.dim() == 1:
            f = f[0]
        if re.dtype == torch.float64:
            r2, i2 = run_ops_f64(re, im, ops)
        else:
            s2 = torch.complex(re, im if im is not None
                               else torch.zeros_like(re))
            for op in ops:
                s2 = apply_op(s2, op, None)
            r2, i2 = s2.real.contiguous(), s2.imag.contiguous()
        return _select(f, r2, re), _select(f, i2, im)
    s2 = state_b
    for op in ops:
        s2 = apply_op(s2, op, None)
    f = torch.as_tensor(flags, device=state_b.device)
    return _select(f, s2, state_b)


def _reg_values(clbit, clbits: np.ndarray) -> np.ndarray:
    """Per-shot classical value: one bit, or the packed register
    (c[0] = LSB) when ``clbit`` is None."""
    if clbit is None:
        reg = np.zeros(clbits.shape[1], dtype=np.int64)
        for b in range(clbits.shape[0]):
            reg |= clbits[b] << b
        return reg
    return clbits[clbit]


def _flags_for(clbit, value, clbits: np.ndarray) -> np.ndarray:
    """Per-shot condition mask: bit compare, or whole-register compare when
    ``clbit`` is None (OpenQASM 2.0 'if (c == v)' semantics)."""
    return _reg_values(clbit, clbits) == value


def _masked_measure(circ, clbits: np.ndarray, item: Measure,
                    mask: Optional[np.ndarray]) -> None:
    """Measure ``item.qubit``; with a mask, only the active shots collapse
    and record their outcome (inactive shots keep state AND classical bit
    unchanged — required for measurements inside ``while`` bodies)."""
    if mask is None:
        outcomes, _ = circ.measure(item.qubit)
        clbits[item.clbit] = np.asarray(outcomes)
        return
    circ.flush()
    saved = circ.state
    outcomes, _ = circ.measure(item.qubit)
    new = circ.state
    if isinstance(saved, tuple):
        f = torch.as_tensor(mask, device=saved[0].device)
        if saved[0].dim() == 1:  # 1-shot ensemble
            f = f[0]
        circ._state = (_select(f, new[0], saved[0]),
                       _select(f, new[1], saved[1]))
    else:
        circ._state = _select(torch.as_tensor(mask, device=saved.device),
                              new, saved)
    clbits[item.clbit] = np.where(mask, np.asarray(outcomes),
                                  clbits[item.clbit])


def _exec_items(items, circ, clbits: np.ndarray,
                mask: Optional[np.ndarray]) -> None:
    """Run program items on a shot-batched Circuit. ``mask`` (None = all
    shots active) gates every state change per element — the while-loop
    bodies run through here with the still-active mask."""
    pend = []  # consecutive masked GateOps applied as one select

    def flush_pend():
        if pend:
            circ.flush()
            circ._state = _apply_conditional(circ.state, mask, list(pend))
            pend.clear()

    for item in items:
        if isinstance(item, Measure):
            flush_pend()
            _masked_measure(circ, clbits, item, mask)
        elif isinstance(item, Cond):
            flush_pend()
            circ.flush()
            flags = _flags_for(item.clbit, item.value, clbits)
            if mask is not None:
                flags = flags & mask
            if item.ops and flags.any():
                circ._state = _apply_conditional(circ.state, flags, item.ops)
        elif isinstance(item, Switch):
            flush_pend()
            circ.flush()
            # arm bodies may measure/branch/loop: each runs via _exec_items
            # with the mask of shots it matched; values are read ONCE up
            # front so arm-body measurements cannot re-route later arms
            vals = _reg_values(item.clbit, clbits).copy()
            matched = np.zeros(clbits.shape[1], dtype=bool)
            for case_vals, arm_items in item.cases:
                flags = np.isin(vals, case_vals) & ~matched
                matched |= flags
                if mask is not None:
                    flags = flags & mask
                if arm_items and flags.any():
                    _exec_items(arm_items, circ, clbits, flags)
                    circ.flush()
            flags = ~matched
            if mask is not None:
                flags = flags & mask
            if item.default and flags.any():
                _exec_items(item.default, circ, clbits, flags)
                circ.flush()
        elif isinstance(item, While):
            flush_pend()
            circ.flush()
            for _ in range(item.max_iter):
                flags = _flags_for(item.clbit, item.value, clbits)
                if mask is not None:
                    flags = flags & mask
                if not flags.any():
                    break
                _exec_items(item.items, circ, clbits, flags)
                circ.flush()
            else:
                flags = _flags_for(item.clbit, item.value, clbits)
                if mask is not None:
                    flags = flags & mask
                if flags.any():
                    # shots whose condition never cleared would otherwise be
                    # returned as normal results, indistinguishable from
                    # converged ones
                    warnings.warn(
                        f"while loop stopped after max_iter={item.max_iter} "
                        f"iterations with {int(flags.sum())} shot(s) still "
                        "active; their results did not converge",
                        RuntimeWarning, stacklevel=2)
        elif mask is None:
            circ._enqueue(item.name, item.targets, item.controls,
                          item.params, item.matrix,
                          is_adjoint=item.is_adjoint)
        else:
            pend.append(item)
    flush_pend()


# cap the shot-batch working set: batch * 2^n amplitudes (complex64)
_MAX_BATCH_ELEMENTS = 1 << 27  # 1 GiB of amplitudes per chunk


def run_dynamic(program: DynamicProgram, shots: int, seed: int = 0,
                measured_qubits: Optional[Sequence[int]] = None,
                device=None) -> Dict[str, int]:
    """Execute a dynamic program for ``shots`` shots on ``device`` (the
    card unless the caller names another); returns a bitstring histogram
    over ``measured_qubits`` (default: all qubits, qubits[0] = rightmost
    bit, the cloud-provider format).

    Shots run batched (one batch element per shot); when shots * 2^n
    exceeds the working-set cap the ensemble runs in chunks, chunk k seeded
    ``seed + k``, and the histograms merge."""
    max_batch = max(1, _MAX_BATCH_ELEMENTS >> program.num_qubits)
    if shots > max_batch:
        counts: Dict[str, int] = {}
        done = 0
        chunk_idx = 0
        while done < shots:
            take = min(max_batch, shots - done)
            sub = _run_dynamic_batch(program, take, seed + chunk_idx,
                                     measured_qubits, device)
            for k, v in sub.items():
                counts[k] = counts.get(k, 0) + v
            done += take
            chunk_idx += 1
        return dict(sorted(counts.items()))
    return _run_dynamic_batch(program, shots, seed, measured_qubits, device)


def _run_dynamic_batch(program: DynamicProgram, shots: int, seed: int,
                       measured_qubits: Optional[Sequence[int]],
                       device=None) -> Dict[str, int]:
    from .. import api as _api

    sim = _api.Simulator(seed=seed, device=device)
    circ = _api.Circuit(program.num_qubits, sim, batch_size=max(shots, 1))
    clbits = np.zeros((program.num_clbits, shots), dtype=np.int64)
    _exec_items(program.items, circ, clbits, None)
    circ.flush()

    qubits = list(measured_qubits) if measured_qubits is not None \
        else list(range(program.num_qubits))
    # each batch element is one shot: draw exactly one sample per element
    # (a 1-shot ensemble is an unbatched circuit: sample is already flat)
    samples = circ.sample(qubits, 1)
    if samples.ndim == 2:
        samples = samples[:, 0]
    k = len(qubits)
    return {format(int(v), f"0{k}b"): c
            for v, c in sorted(Counter(samples.tolist()).items())}


def expval_z_dynamic(program: DynamicProgram, qubit: int, shots: int,
                     seed: int = 0, device=None) -> float:
    """Shot-estimated <Z_qubit> after running a dynamic program."""
    counts = run_dynamic(program, shots, seed=seed, measured_qubits=[qubit],
                         device=device)
    total = sum(counts.values())
    return (counts.get("0", 0) - counts.get("1", 0)) / max(total, 1)
