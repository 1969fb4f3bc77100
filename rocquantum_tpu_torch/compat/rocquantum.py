"""``rocquantum``: the reference's third front end (``import rocquantum as
rocq``, examples/vqe_h2.py; counterpart of the repository's
``rocquantum/__init__.py``): the DSL kernel decorator and free gates,
``get_expval(kernel, pauli_string, params)`` and ``grad`` taking
positional Pauli strings ('ZZ': character i acts on qubit i), and the
reference package's submodules as attributes (``circuit``, ``core``,
``backends``, ``solvers``, ``qec``, ``utils``, ``python.rocq``)."""

import types as _types

import numpy as _np

from .. import api as _api
from .. import backends, core, qec, solvers, utils  # noqa: F401
from .. import qcircuit as circuit
from ..dsl import (  # noqa: F401
    NoiseModel,
    QuantumKernel,
    ccx,
    cnot,
    cx,
    cz,
    execute,
    h,
    kernel,
    mcx,
    qvec,
    rx,
    ry,
    rz,
    s,
    sdg,
    swap,
    t,
    tdg,
    x,
    y,
    z,
)
from ..dsl.backends import StateVectorBackend, get_backend  # noqa: F401

# reference import path ``rocquantum.python.rocq`` (qec/framework.py:19,
# solvers/vqe_solver.py:16): the main programming model
python = _types.SimpleNamespace(rocq=_api)

QuantumCircuit = circuit.QuantumCircuit
set_target = core.set_target
get_active_backend = core.get_active_backend


def _positional_ops(pauli_string: str):
    ops = []
    for i, p in enumerate(pauli_string.strip().upper()):
        if p == "I":
            continue
        if p not in "XYZ":
            raise ValueError(f"Invalid Pauli '{p}' in '{pauli_string}'")
        ops.append((p, i))
    return ops


def _run_kernel(kernel_obj: QuantumKernel, params, device=None):
    be = get_backend("state_vector", max(kernel_obj.num_qubits, 1),
                     device=device)
    bindings = dict(zip(kernel_obj.param_names, [list(params)]
                        if len(kernel_obj.param_names) == 1 else list(params)))
    for g in kernel_obj.bound_sequence(bindings):
        be.apply_gate(g["op"], g["targets"], g["params"])
    return be


def get_expval(kernel_obj: QuantumKernel, pauli_string: str, params,
               device=None) -> float:
    """<P> for a positional Pauli string after running the kernel on
    ``device`` (default: the card; reference examples/vqe_h2.py:99)."""
    be = _run_kernel(kernel_obj, params, device)
    ops = _positional_ops(pauli_string)
    return be.expectation_pauli(ops) if ops else 1.0


def grad(kernel_obj: QuantumKernel, pauli_string: str, params, device=None):
    """Parameter-shift gradient of :func:`get_expval` with respect to each
    parameter (reference examples/vqe_h2.py:120)."""
    params = _np.asarray(params, dtype=float)
    out = _np.zeros_like(params)
    for i in range(len(params)):
        plus = params.copy()
        plus[i] += _np.pi / 2
        minus = params.copy()
        minus[i] -= _np.pi / 2
        out[i] = 0.5 * (get_expval(kernel_obj, pauli_string, plus, device)
                        - get_expval(kernel_obj, pauli_string, minus, device))
    return out
