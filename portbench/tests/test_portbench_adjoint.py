"""The plain adjoint reference agrees with central differences of the
plain energy, and the port's ``adjoint_grad`` on the CPU agrees with it;
the gradient kind imports nothing of the program at module level and
nothing of JAX."""

import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import workload  # noqa: E402
from portbench.reference import adjoint  # noqa: E402
from portbench.reference import statevector as ref  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64

# RY, RZ and CX on 6 qubits, parameter 1 shared by an RY and an RZ
SHARED = [("RY", (0,), 0), ("RY", (3,), 1), ("CX", (0, 1), None),
          ("RZ", (1,), 2), ("RY", (5,), 3), ("CX", (3, 4), None),
          ("RZ", (4,), 1), ("CX", (5, 0), None), ("RY", (2,), 4),
          ("CX", (1, 2), None), ("RZ", (0,), 5), ("RY", (4,), 6),
          ("CX", (2, 3), None), ("RY", (1,), 7), ("CX", (4, 5), None),
          ("RZ", (3,), 8)]
TERMS = (workload.observable({"num_qubits": 6, "observable": {
    "name": "tfim", "j": 1.0, "h": 0.5}})
    + [(0.3, (("Y", 1), ("Y", 4))), (-0.7, (("X", 0), ("Y", 2), ("Z", 5)))])


def energy(gates, theta, terms, n=6):
    return ref.energy(ref.simulate(n, gates, theta, F64, [CPU]), terms)


def test_reference_gradient_matches_central_differences():
    theta = np.random.default_rng(4).uniform(0, 2 * math.pi, 9)
    value, grads = adjoint.gradient(6, SHARED, theta, TERMS, F64, [CPU])
    assert abs(value - energy(SHARED, theta, TERMS)) < 1e-12
    h = 1e-5
    for j in range(theta.size):
        up, down = theta.copy(), theta.copy()
        up[j] += h
        down[j] -= h
        want = (energy(SHARED, up, TERMS) - energy(SHARED, down, TERMS)) / (
            2 * h)
        assert abs(grads[j] - want) < 1e-9, (j, grads[j], want)
    assert abs(grads[1]) > 1e-3  # the shared entry sums two gates


def test_reference_gradient_of_every_rotation_the_reference_knows():
    gates = [("H", (0,), None), ("RX", (0,), 0), ("CRY", (0, 1), 1),
             ("CRZ", (1, 2), 2), ("CRX", (2, 0), 3), ("RZZ", (0, 2), 4),
             ("H", (1,), None), ("RY", (1,), 5)]
    terms = [(1.0, (("Z", 0),)), (0.5, (("X", 1), ("Y", 2))),
             (-0.8, (("Y", 0), ("Z", 1)))]
    theta = np.random.default_rng(6).uniform(0, 2 * math.pi, 6)
    _, grads = adjoint.gradient(3, gates, theta, terms, F64, [CPU])
    h = 1e-5
    for j in range(theta.size):
        up, down = theta.copy(), theta.copy()
        up[j] += h
        down[j] -= h
        want = (energy(gates, up, terms, 3)
                - energy(gates, down, terms, 3)) / (2 * h)
        assert abs(grads[j] - want) < 1e-9, (j, grads[j], want)


def test_reference_gradient_refuses_more_than_one_device():
    with pytest.raises(ValueError, match="one device"):
        adjoint.gradient(6, SHARED, np.zeros(9), TERMS, F64, [CPU] * 2)


def test_port_adjoint_grad_matches_the_reference_on_the_ring():
    import rocquantum_tpu_torch as rq
    n = 10
    cfg = {"num_qubits": n, "generator": "basic_entangler", "layers": 8,
           "rotation": "RY", "observable": {"name": "tfim", "j": 1.0,
                                            "h": 0.5}}
    gates, terms = workload.circuit(cfg), workload.observable(cfg)
    theta = np.random.default_rng(8).uniform(0, 2 * math.pi,
                                              workload.num_params(gates))

    def kernel(q, *t):
        for name, qubits, p in gates:
            angle = () if p is None else (t[p],)
            getattr(q, name.lower())(*angle, *qubits)

    op = rq.PauliOperator()
    for c, term in terms:
        op = op + rq.PauliOperator({" ".join(f"{p}{q}" for p, q in term): c})
    value, grads = rq.adjoint_grad(kernel, n, rq.Simulator(seed=1,
                                                           device="cpu"),
                                   theta, op, return_value=True)
    want_e, want_g = adjoint.gradient(n, gates, theta, terms, F64, [CPU])
    scale = sum(abs(c) for c, _ in terms)
    assert abs(value - want_e) / scale < 1e-6
    assert np.max(np.abs(grads - want_g)) / scale < 1e-6
    assert np.max(np.abs(want_g)) / scale > 1e-3


def test_gradient_kind_imports_nothing_of_the_program_or_jax():
    with open(os.path.join(smallcopy.BENCH, "requests", "grad.py")) as f:
        tree = ast.parse(f.read())
    seen = set()
    for node in tree.body:  # module level
        if isinstance(node, ast.Import):
            seen |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            seen.add(node.module.split(".")[0])
    assert seen <= {"numpy", "portbench"}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module])
            assert not {m.split(".")[0] for m in names} & {
                "rocquantum_tpu_torch", "rocquantum_tpu", "jax", "jaxlib",
                "flax"}
