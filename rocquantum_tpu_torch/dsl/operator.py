"""Operator algebra for the rocq DSL, a copy of
``rocquantum_tpu/dsl/operator.py`` (reference: rocq/operator.py —
QuantumOperator ABC, PauliOperator, HermitianOperator, SumOperator,
get_expectation_value). The reference's expectation was a placeholder
returning 42.0 (operator.py:116); here it is computed for real on the
selected backend.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from numbers import Number

import numpy as np

from .kernel import QuantumKernel, execute


class QuantumOperator(ABC):
    """Abstract operator with scalar multiplication and addition."""

    def __init__(self, coefficient: Number = 1.0):
        self.coefficient = complex(coefficient)

    def __mul__(self, other):
        if isinstance(other, Number):
            new_op = self.__class__.__new__(self.__class__)
            new_op.__dict__.update(self.__dict__)
            new_op.coefficient = self.coefficient * other
            return new_op
        raise NotImplementedError(
            f"Cannot multiply QuantumOperator by {type(other)}")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __add__(self, other):
        if isinstance(other, QuantumOperator):
            return SumOperator([self, other])
        raise NotImplementedError(
            f"Cannot add QuantumOperator to {type(other)}")

    @abstractmethod
    def to_string(self) -> str:
        ...


def _parse_pauli_string(pauli_string: str):
    """'X0 Y1' -> [('X', 0), ('Y', 1)]."""
    ops = []
    for comp in pauli_string.strip().upper().split():
        if comp == "I":
            continue
        p = comp[0]
        if p not in "IXYZ":
            raise ValueError(f"Invalid Pauli '{p}' in '{comp}'")
        if p == "I":
            continue
        ops.append((p, int(comp[1:])))
    return ops


class PauliOperator(QuantumOperator):
    """A weighted Pauli string, e.g. 0.5 * X0 Y1 Z2."""

    def __init__(self, pauli_string: str, coefficient: Number = 1.0):
        super().__init__(coefficient)
        self.pauli_string = pauli_string

    def to_string(self) -> str:
        return f"{self.coefficient} * {self.pauli_string}"

    def parsed(self):
        return _parse_pauli_string(self.pauli_string)


class HermitianOperator(QuantumOperator):
    """An operator given by a dense Hermitian matrix on ``targets``."""

    def __init__(self, matrix, coefficient: Number = 1.0, targets=None):
        super().__init__(coefficient)
        self.matrix = np.asarray(matrix)
        m = int(np.log2(self.matrix.shape[0]))
        self.targets = list(targets) if targets is not None else list(range(m))

    def to_string(self) -> str:
        return f"{self.coefficient} * Hermitian(matrix)"


class SumOperator(QuantumOperator):
    """A sum of operators (a Hamiltonian)."""

    def __init__(self, operators, coefficient: Number = 1.0):
        super().__init__(coefficient)
        self.terms = list(operators)

    def __add__(self, other):
        if isinstance(other, SumOperator):
            self.terms.extend(other.terms)
        elif isinstance(other, QuantumOperator):
            self.terms.append(other)
        else:
            raise NotImplementedError
        return self

    def to_string(self) -> str:
        return " + ".join(f"({t.to_string()})" for t in self.terms)


def _expectation_on_backend(be, operator) -> float:
    # duck-typed support for the main-API PauliOperator (list-of-terms form)
    if not isinstance(operator, QuantumOperator) and hasattr(operator, "terms"):
        total = 0.0
        for ops, coeff in operator.terms:
            total += coeff * (be.expectation_pauli(list(ops)) if ops else 1.0)
        return total
    if isinstance(operator, SumOperator):
        return float(operator.coefficient.real) * sum(
            _expectation_on_backend(be, t) for t in operator.terms)
    if isinstance(operator, PauliOperator):
        val = be.expectation_pauli(operator.parsed())
        return float(operator.coefficient.real) * val
    if isinstance(operator, HermitianOperator):
        val = be.expectation_matrix(operator.matrix, operator.targets)
        return float(operator.coefficient.real) * val
    raise TypeError(f"Unsupported operator type: {type(operator)}")


def get_expectation_value(kernel: QuantumKernel, operator: QuantumOperator,
                          backend: str, noise_model=None, device=None,
                          **kwargs) -> float:
    """Prepare the state with ``kernel`` on ``device`` (default: the card)
    and compute <operator> (reference rocq/operator.py:90-127, now a real
    computation)."""
    from .backends import get_backend

    be = get_backend(backend, max(kernel.num_qubits, 1), device=device)
    if noise_model is not None and noise_model.get_channels():
        be.validate_noise_support()
    for g in kernel.bound_sequence(kwargs):
        be.apply_gate(g["op"], g["targets"], g["params"])
        if noise_model is not None:
            for ch in noise_model.get_channels():
                if ch["op"] is not None and ch["op"] != g["op"]:
                    continue
                targets = ch["qubits"] if ch["qubits"] is not None else g["targets"]
                be.apply_noise(ch["type"], targets, ch["prob"])
    return _expectation_on_backend(be, operator)
