"""The comparison that decides ``correct`` fails the control (the
reference in the precision below the configuration's) and every fault a
cell can have, planted under the timed path, at sizes a CPU test holds.
The harness's look for a card is skipped; the rest of a run is driven as
on the chip, with the cells' own limits. The cells whose request kind
reads the engine's state compare exactly what they compared before the
harness let a kind own its request."""

import sys
import time

import numpy as np
import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import harness  # noqa: E402

CPU = torch.device("cpu")
CELLS = ["ring29_f32.energy", "ring29_f32.shots", "ring29_df64.energy"]
GRAD = "ring26_f32.grad"


def run(bench_dir, cell, devices=1, **kw):
    return harness.run(harness.Cell(cell, bench_dir),
                       harness.Devices([CPU] * devices), 2**31 + 5, 0.5,
                       False, time.perf_counter(), **kw)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return smallcopy.make(tmp_path_factory.mktemp("small"), num_qubits=15)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small, cell):
    r = run(small, cell, system=harness.Control)
    assert not r["correct"]
    assert r["checks"]["state_err"]["value"] > \
        3 * r["checks"]["state_err"]["limit"]


class StateUnchanged(harness.Program):
    """run(theta) hands back |0...0>: the circuit is never applied."""

    def engine(self, theta):
        handle = self.prog.run(theta)
        handle._state = self.prog._init_fn()
        return handle


class HalfLeftOut(harness.Program):
    """Half of the work left out, the rest scaled to stand for it: the
    even terms of the observable at twice their weight, or half the shots
    drawn twice."""

    def expval(self, handle, terms):
        half = [(2 * c, t) for k, (c, t) in enumerate(terms) if k % 2 == 0]
        return super().expval(handle, half)

    def sample(self, handle, qubits, shots):
        drawn = handle.sample(qubits, shots // 2)
        return np.concatenate([drawn, drawn])


class AnswerAltered(harness.Program):
    """The answer changed where it is produced: the energy moved by 0.01,
    each drawn outcome with its lowest bit flipped."""

    def expval(self, handle, terms):
        return super().expval(handle, terms) + 0.01

    def sample(self, handle, qubits, shots):
        return super().sample(handle, qubits, shots) ^ 1


@pytest.mark.parametrize("fault", [StateUnchanged, HalfLeftOut,
                                   AnswerAltered])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(small, cell, fault):
    r = run(small, cell, system=fault)
    assert not r["correct"], r["checks"]


def test_exchange_left_out_is_not_correct(tmp_path, monkeypatch):
    bench_dir = smallcopy.make(tmp_path, num_qubits=10)
    smallcopy.write_json(bench_dir, "limits", "su2ring32_c64_4card.energy",
                         {"energy_err": 1e-5, "state_err": 1e-4})
    smallcopy.add_cell(bench_dir, "su2ring32_c64_4card.energy",
                       "su2ring32_c64_4card", "energy", chips=4)
    from rocquantum_tpu_torch.parallel import sharded
    assert run(bench_dir, "su2ring32_c64_4card.energy", 4)["correct"]
    monkeypatch.setattr(sharded, "permute_bits", lambda state, *a, **k:
                        state)
    r = run(bench_dir, "su2ring32_c64_4card.energy", 4)
    assert not r["correct"], r["checks"]


def test_gradient_cell_is_correct(small):
    r = run(small, GRAD)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"energy_err", "grad_err"}
    assert r["failed"] == 0 and r["attempted"] >= 1


def test_gradient_control_is_not_correct(small):
    r = run(small, GRAD, system=harness.Control)
    assert not r["correct"]
    assert r["checks"]["grad_err"]["value"] > \
        3 * r["checks"]["grad_err"]["limit"]


def _around_adjoint_grad(monkeypatch, change):
    import rocquantum_tpu_torch as rq
    real = rq.adjoint_grad
    monkeypatch.setattr(rq, "adjoint_grad",
                        lambda *a, **k: change(real(*a, **k)))


def entry_zeroed(monkeypatch):
    """The gradient's first entry set to 0 where the port produces it."""
    def change(answer):
        value, grads = answer
        grads = grads.copy()
        grads[0] = 0.0
        return value, grads
    _around_adjoint_grad(monkeypatch, change)


def previous_answer(monkeypatch):
    """Each request answered with the previous request's value and
    gradient."""
    last = []

    def change(answer):
        last.append(answer)
        return last[-2] if len(last) > 1 else answer
    _around_adjoint_grad(monkeypatch, change)


def half_the_terms(monkeypatch):
    """The even terms of the observable at twice their weight."""
    real = harness.Program.operator
    monkeypatch.setattr(harness.Program, "operator", lambda self, terms: real(
        self, [(2 * c, t) for k, (c, t) in enumerate(terms) if k % 2 == 0]))


def forward_unchanged(monkeypatch):
    """The sweep's forward run hands back |0...0>: the circuit is never
    applied before the energy and the backward walk."""
    from rocquantum_tpu_torch import autodiff
    from rocquantum_tpu_torch.compiler.interpreter import init_real
    monkeypatch.setattr(autodiff._Sweep, "forward", lambda self, values: (
        init_real(self.n, self.device), None))


@pytest.mark.parametrize("fault", [forward_unchanged, entry_zeroed,
                                   previous_answer, half_the_terms])
def test_gradient_faults_are_not_correct(small, fault, monkeypatch):
    fault(monkeypatch)
    r = run(small, GRAD)
    assert not r["correct"], r["checks"]


class Clock:
    """A host clock that moves one second a reading: a 10-s window then
    holds four requests, whatever the machine."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


# the numbers compared in four requests of each cell, as the harness
# before request kinds could own their requests printed them: one torch
# thread, seed 2**31 + 5, the counting clock
BEFORE = {
    "ring29_f32.energy": {"energy_err": 2.1304825289749886e-09,
                          "state_err": 6.869924192041648e-07},
    "ring29_f32.shots": {"xeb_dev": 0.009582686632206627,
                         "dup_z": 1.9439593421892338,
                         "state_err": 6.869924192041648e-07},
    "ring29_df64.energy": {"energy_err": 9.629642762200143e-17,
                           "state_err": 1.9427781597232207e-14},
    "su2ring32_c64_4card.energy": {"energy_err": 7.059416053574926e-09,
                                   "state_err": 1.1020502852492223e-06},
}


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_state_cells_compare_what_they_compared_before(cell, tmp_path,
                                                       monkeypatch):
    sharded = cell.startswith("su2ring32")
    bench_dir = smallcopy.make(tmp_path, num_qubits=10 if sharded else 15)
    monkeypatch.setattr(harness, "time", Clock())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run(harness.Cell(cell, bench_dir),
                        harness.Devices([CPU] * (4 if sharded else 1)),
                        2**31 + 5, 10, False, 0.0,
                        log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(threads)
    assert r["attempted"] == 4
    assert {k: c["value"] for k, c in r["checks"].items()} == BEFORE[cell]
