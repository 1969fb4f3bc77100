"""The adjoint step (``ops/adjoint_step.py``) on the CPU: its plain version,
which walks the kernel's index geometry, against the sequence it replaces
(a one-gate step on the ket, ``autodiff._correlation``'s sums, a one-gate
step on the bra); the sweep routed through it against the JAX package's
``adjoint_grad``; and the counters that say which steps it served.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``). On
CPU float32 planes the sweep sends every step to the plain version, so
the host side (plans, target order, matrices packed a request, the
float64 M buffer) runs as on the card.

Tolerances: planes within 1e-6 of max|amp| (float32 steps of unit
states); M within 1e-7 of sum|M| (the replaced sums round their products
to float32, the plain version's are float64); values within 1e-5
relative and gradients within 2e-5 absolute of the JAX package
(tests/test_torch_autodiff.py's own).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rocquantum_tpu as jrq
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import autodiff
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch.compiler.interpreter import (_split_op,
                                                       compile_pair32_ir)
from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp, ParamRef
from rocquantum_tpu_torch.ops import adjoint_step, gates
from rocquantum_tpu_torch.utils import profiling

# (name, targets, controls, angles): the gradient's users' gates, controls
# above and below the targets, both target orders, targets on and above
# index bits 0-1
CASES = [
    ("RY", (0,), (), (0.7,)), ("RY", (1,), (), (0.7,)),
    ("RY", (4,), (), (0.7,)), ("RX", (1,), (), (1.3,)),
    ("RX", (3,), (), (-0.6,)), ("RZ", (0,), (), (-0.4,)),
    ("RZ", (5,), (), (2.2,)), ("CRY", (2,), (0,), (2.1,)),
    ("CRY", (0,), (5,), (2.1,)), ("CRY", (1,), (0,), (2.1,)),
    ("RZZ", (0, 1), (), (0.9,)), ("RZZ", (1, 0), (), (0.9,)),
    ("RZZ", (5, 2), (), (0.9,)), ("RZZ", (0, 3), (), (0.9,)),
    ("U3", (2,), (), (0.3, -1.1, 2.5)),
    ("U3", (0,), (3, 1), (0.3, -1.1, 2.5)),
]


def _ids(case):
    name, targets, controls, _ = case
    return "-".join([name, "t" + "_".join(map(str, targets)),
                     "c" + "_".join(map(str, controls))])


def _unit_planes(rng, n, complex_):
    re = rng.normal(size=1 << n)
    im = rng.normal(size=1 << n) if complex_ else np.zeros(1 << n)
    scale = np.sqrt(np.sum(re ** 2) + np.sum(im ** 2))
    return (torch.tensor(re / scale, dtype=torch.float32),
            torch.tensor(im / scale, dtype=torch.float32)
            if complex_ else None)


def _copy(pair):
    return tuple(None if p is None else p.clone() for p in pair)


def _filled(pair):
    return tuple(torch.zeros_like(pair[0]) if p is None else p
                 for p in pair)


@pytest.mark.parametrize("n,complex_", [(6, False), (6, True), (15, False),
                                        (15, True)])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_step_matches_the_sequence_it_replaces(n, complex_, case):
    """At n = 6 the sequence runs the plain engine, at n = 15 the fused
    kernel's plain version."""
    name, targets, controls, angles = case
    rng = np.random.default_rng(n + 7 * len(targets))
    ket, bra = _unit_planes(rng, n, complex_), _unit_planes(rng, n,
                                                            complex_)
    op = GateOp(name, targets, controls,
                tuple(ParamRef(i) for i in range(len(angles))))
    run = compile_pair32_ir(CircuitIR(n, [dataclasses.replace(
        op, is_adjoint=True)]), every_run=True)
    values = np.asarray(angles)
    want_k = run(_copy(ket), values)
    want_m = autodiff._correlation(bra, want_k, *_split_op(op)[1:])
    want_b = run(_copy(bra), values)

    base, c, t = _split_op(op)
    u = gates.gate_matrix(base, angles)
    d = u.shape[0]
    v = np.zeros((1, 4, 4), np.complex128)
    v[0, :d, :d] = u.conj().T
    step = adjoint_step.plan(n, c, t)
    out = torch.zeros(2, 4, 4, dtype=torch.float64)
    got_k, got_b = adjoint_step.apply(_copy(ket), _copy(bra),
                                      adjoint_step.pack(v, [step.swap])[0],
                                      step, out)
    for got, want in ((got_k, want_k), (got_b, want_b)):
        for g, w in zip(_filled(got), _filled(want)):
            assert float((g - w).abs().max()) <= 1e-6
    assert float((out[:, :d, :d] - want_m).abs().max()) <= \
        1e-7 * float(want_m.abs().sum())
    assert not out[:, d:].any() and not out[:, :, d:].any()


@pytest.mark.parametrize("n,controls,targets,lt,swap,nvec", [
    (8, (), (3,), 0, False, 32), (8, (), (0,), 1, False, 64),
    (8, (), (1,), 2, False, 64), (8, (), (1, 0), 3, True, 64),
    (8, (0,), (6, 2), 0, True, 16), (9, (7, 1), (0,), 1, False, 64),
])
def test_plan_places_targets_and_controls(n, controls, targets, lt, swap,
                                          nvec):
    step = adjoint_step.plan(n, controls, targets)
    assert (step.lt, step.swap, int(step.geo[6])) == (lt, swap, nvec)
    # the groups cover each amplitude whose controls are 1 once
    idx = adjoint_step._groups(step, torch.device("cpu"))
    flat = idx.reshape(-1)
    assert flat.unique().numel() == flat.numel()
    cmask = sum(1 << q for q in controls)
    assert flat.numel() == (1 << n) >> len(controls)
    assert bool(((flat & cmask) == cmask).all())
    # a group's amplitudes differ in the target bits alone, the lowest
    # target the low bit of the group's index
    order = sorted(targets)
    for j in range(idx.shape[1]):
        want = sum(((j >> k) & 1) << q for k, q in enumerate(order))
        assert bool(((idx[:, j] ^ idx[:, 0]) == want).all())


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        adjoint_step.plan(8, (), (0, 1, 2))
    with pytest.raises(ValueError):
        adjoint_step.plan(8, (3,), (3,))
    with pytest.raises(ValueError):
        adjoint_step.plan(8, (), (8,))


N = 10


def mixed(q, *t):
    """Two layers of RX and RZ columns, CRY with the control above and
    below, RZZ in both orders, a U3 of three angles, a CNOT ring."""
    k = 0
    for _ in range(2):
        for j in range(N):
            q.rx(t[k], j)
            k += 1
        for j in range(0, N, 2):
            q.rz(t[k], j)
            k += 1
        q.cry(t[k], 0, 5)
        q.cry(t[k + 1], 7, 1)
        q.rzz(t[k + 2], 3, 0)
        q.rzz(t[k + 3], 2, 8)
        q._enqueue("U3", [4], params=[t[k + 4], t[k + 5], t[k + 6]])
        k += 7
        for j in range(N):
            q.cx(j, (j + 1) % N)


MIXED_PARAMS = 2 * (N + N // 2 + 7)
MIXED_GATES = 2 * (N + N // 2 + 5)
MIXED_H = {"Z0 Z1": -1.0, "X3": 0.5, "Y4 Z7": 0.3, "X9 X0": -0.2, "Z5": 0.7}


@pytest.fixture(scope="module")
def jax_mixed():
    theta = np.random.default_rng(10).uniform(0, 2 * np.pi, MIXED_PARAMS)
    value, grads = jrq.adjoint_grad(jrq.kernel(mixed), N, jrq.Simulator(),
                                    theta, jrq.PauliOperator(MIXED_H),
                                    return_value=True)
    return theta, value, np.asarray(grads)


def _traced_grad(theta, precision="single"):
    old = ("df64" if port_config.df64_enabled()
           else port_config.get_precision())
    rq.set_precision(precision)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            value, grads = rq.adjoint_grad(
                rq.kernel(mixed), N, rq.Simulator(device="cpu"), theta,
                rq.PauliOperator(MIXED_H), return_value=True)
        (req,) = profiling.records()
    finally:
        rq.set_precision(old)
        profiling.clear()
    return value, grads, req


@pytest.mark.parametrize("route", ["step", "correlation"])
def test_mixed_circuit_gradient_matches_jax(jax_mixed, route):
    """Single precision walks every parameterized gate back through the
    adjoint step; double precision through the exact engine's one-gate
    steps around ``autodiff._correlation``."""
    theta, want_v, want_g = jax_mixed
    value, grads, req = _traced_grad(
        theta, "single" if route == "step" else "double")
    assert abs(value - want_v) <= 1e-5 * abs(want_v)
    np.testing.assert_allclose(grads, want_g, atol=2e-5)
    # one request (rq.grad) counts every parameterized gate walked back,
    # and those the step served: the adjoint_kernel_share of 100 or 0
    assert [s.name for s in req.spans if s.parent is None] == ["rq.grad"]
    served = MIXED_GATES if route == "step" else 0
    assert req.counters.get("adjoint_steps") == MIXED_GATES
    assert req.counters.get("adjoint_kernel_steps", 0) == served


def test_exact_sweep_keeps_its_engine(jax_mixed):
    """Double precision walks back on the exact complex128 engine: no step
    goes to the adjoint step, whose plain version would take the CPU
    planes."""
    theta, want_v, want_g = jax_mixed
    for precision in ("double", "df64"):
        value, grads, req = _traced_grad(theta, precision)
        assert abs(value - want_v) <= 1e-5 * abs(want_v)
        np.testing.assert_allclose(grads, want_g, atol=2e-5)
        assert req.counters.get("adjoint_steps") == MIXED_GATES
        assert req.counters.get("adjoint_kernel_steps", 0) == 0


def test_batched_matrices_match_the_gate_builders():
    rng = np.random.default_rng(5)
    for name, width in (("RX", 1), ("RY", 1), ("RZ", 1), ("P", 1),
                        ("RZZ", 1), ("U3", 3)):
        params = rng.uniform(-3, 3, (4, width))
        got = gates.gate_matrices_t(name, torch.tensor(params)).numpy()
        for row, p in zip(got, params):
            np.testing.assert_allclose(row, gates.gate_matrix(name, p),
                                       atol=1e-15)

