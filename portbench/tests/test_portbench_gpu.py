"""The harness on a CUDA card at sizes a test run holds: every cell is
correct with its own limits, the traced run reads the device, and the
control is not correct. Each test skips without a card; the decision is
made inside the test."""

import sys
import time

import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import harness  # noqa: E402

CELLS = ["ring29_f32.energy", "ring29_f32.shots", "ring29_df64.energy",
         "ring26_f32.grad"]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return harness.Devices([torch.device("cuda", 0)])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return smallcopy.make(tmp_path_factory.mktemp("gpu"), num_qubits=20)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_the_card(small, cell):
    devices = card()
    c = harness.Cell(cell, small)
    r = harness.run(c, devices, 2**31 + 3, 1.0, False, time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    t = harness.run(c, devices, 2**31 + 4, 1.0, True, time.perf_counter())
    assert t["correct"], t["checks"]
    assert 0 < t["busy_s"] <= t["window_s"]
    assert set(t["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in t["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(small, cell):
    devices = card()
    r = harness.run(harness.Cell(cell, small), devices, 2**31 + 5, 1.0,
                    False, time.perf_counter(), system=harness.Control)
    assert not r["correct"], r["checks"]
