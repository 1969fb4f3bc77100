"""Quantum register abstraction (reference: rocq/qvec.py)."""

from __future__ import annotations


class qvec:
    """A register of qubits; indexing yields global qubit ids."""

    _current_kernel_context = None

    def __init__(self, size: int):
        if not isinstance(size, int) or size <= 0:
            raise ValueError("qvec size must be a positive integer.")
        ctx = qvec._current_kernel_context
        base = ctx.num_qubits if ctx is not None else 0
        self.size = size
        self.qubits = list(range(base, base + size))
        if ctx is not None:
            ctx.register_qvec(self)

    def __getitem__(self, key):
        return self.qubits[key]

    def __len__(self):
        return self.size

    def __iter__(self):
        return iter(self.qubits)
