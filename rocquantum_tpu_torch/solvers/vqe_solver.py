"""Variational Quantum Eigensolver.

A copy of ``rocquantum_tpu/solvers/vqe_solver.py`` on this package's API:
the reference solver's Optimizer strategy ABC, SciPyOptimizer wrapper and
VQE_Solver.solve recording intermediate results
(rocquantum/solvers/vqe_solver.py), plus ``use_adjoint_gradients=True``,
which feeds the optimizer an analytic jacobian from one adjoint sweep
(``api.adjoint_grad``) per evaluation instead of 2P parameter-shift circuit
executions.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict

import numpy as np
from scipy.optimize import OptimizeResult, minimize

from .. import api as roc_q
from ..api import PauliOperator

AnsatzKernel = Callable[..., None]


class Optimizer(ABC):
    """Classical optimizer strategy (reference vqe_solver.py:26-55)."""

    @abstractmethod
    def minimize(self, fun: Callable[[np.ndarray], float], x0: np.ndarray,
                 args: tuple = (), jac=None) -> OptimizeResult:
        ...


class SciPyOptimizer(Optimizer):
    """scipy.optimize.minimize wrapper (reference vqe_solver.py:57-87)."""

    def __init__(self, options: Dict[str, Any] = None):
        self.options = options if options is not None else {
            "method": "COBYLA", "tol": 1e-6}

    def minimize(self, fun, x0, args=(), jac=None) -> OptimizeResult:
        kwargs = dict(self.options)
        if jac is not None and kwargs.get("method", "").upper() not in (
                "COBYLA", "NELDER-MEAD", "POWELL"):
            kwargs["jac"] = True  # fun returns (value, grad)
            return minimize(fun=fun, x0=x0, args=args, **kwargs)
        return minimize(fun=fun, x0=x0, args=args, **kwargs)


class VQE_Solver:
    """High-level VQE driver (reference vqe_solver.py:91-165)."""

    def __init__(self, simulator: roc_q.Simulator, optimizer: Optimizer = None,
                 use_adjoint_gradients: bool = False, verbose: bool = False):
        if not isinstance(simulator, roc_q.Simulator):
            raise TypeError("A valid roc_q.Simulator instance is required.")
        self.simulator = simulator
        self.optimizer = optimizer if optimizer is not None else SciPyOptimizer()
        self.use_adjoint_gradients = use_adjoint_gradients
        self.verbose = verbose
        self._intermediate_results = []

    def _objective_function(self, params: np.ndarray,
                            hamiltonian: PauliOperator,
                            ansatz_kernel: AnsatzKernel,
                            num_qubits: int) -> float:
        program = roc_q.build(ansatz_kernel, num_qubits, self.simulator, *params)
        energy = roc_q.get_expval(program, hamiltonian)
        self._intermediate_results.append(
            {"params": np.asarray(params).tolist(), "energy": energy})
        if self.verbose:
            print(f"Evaluated parameters {np.asarray(params).tolist()}, "
                  f"Energy: {energy:.8f}")
        return energy

    def _objective_with_grad(self, params, hamiltonian, ansatz_kernel,
                             num_qubits):
        value, grads = roc_q.adjoint_grad(
            ansatz_kernel, num_qubits, self.simulator, params, hamiltonian,
            return_value=True)
        self._intermediate_results.append(
            {"params": np.asarray(params).tolist(), "energy": value})
        if self.verbose:
            print(f"Evaluated parameters {np.asarray(params).tolist()}, "
                  f"Energy: {value:.8f}")
        return value, grads

    def solve(self, hamiltonian: PauliOperator, ansatz_kernel: AnsatzKernel,
              num_qubits: int, initial_params: np.ndarray) -> Dict[str, Any]:
        self._intermediate_results = []
        if self.use_adjoint_gradients:
            result = self.optimizer.minimize(
                fun=self._objective_with_grad,
                x0=np.asarray(initial_params, dtype=float),
                args=(hamiltonian, ansatz_kernel, num_qubits),
                jac=True)
        else:
            result = self.optimizer.minimize(
                fun=self._objective_function,
                x0=np.asarray(initial_params, dtype=float),
                args=(hamiltonian, ansatz_kernel, num_qubits))
        return {
            "optimal_energy": result.fun,
            "optimal_parameters": result.x,
            "optimizer_result": result,
            "intermediate_results": self._intermediate_results,
        }
