"""The comparison that decides ``correct`` fails the control (the
reference in the precision below the configuration's) and every fault a
cell can have, planted under the timed path, at sizes a CPU test holds.
The harness's look for a card is skipped; the rest of a run is driven as
on the chip, with the cells' own limits."""

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
