"""The per-layer readers of the program's own spans and counters
(``rocquantum_tpu_torch.utils.profiling``) get a number from a traced
window on the CPU, and none from a program that keeps no records."""

import sys
import time
import types

import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import harness, program_spans, trace, workload  # noqa: E402
from rocquantum_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
SPAN_READERS = ["engine_device_ms", "readout_device_ms", "readout_passes"]
N = 15


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return smallcopy.make(tmp_path_factory.mktemp("tracing"), num_qubits=N)


def traced_run(bench_dir, cell, devices=1):
    profiling.clear()
    c = harness.Cell(cell, bench_dir)
    r = harness.run(c, harness.Devices([CPU] * devices), 2**31 + 11, 0.5,
                    True, time.perf_counter())
    assert r["correct"], r["checks"]
    return c, r


# readout passes a request on the CPU at n = 15: a Z Z term of the TFIM
# ring 5 passes on a float32 plane (a square, two half-plane sign flips, a
# cast, a sum), 4 on a float64 one (no cast); an X term 4 and 3 (a flip,
# a product, [a cast,] a sum); shots of every qubit 3 (square, cast,
# cumsum)
PASSES = {"ring29_f32.energy": N * 5 + N * 4, "ring29_f32.shots": 3,
          "ring29_df64.energy": N * 4 + N * 3}


@pytest.mark.parametrize("cell", sorted(PASSES))
def test_one_card_cells_read_the_program_spans(small, cell):
    c, r = traced_run(small, cell)
    got = r["metrics"]
    assert set(SPAN_READERS) <= set(got)
    assert got["readout_passes"]["value"] == PASSES[cell]
    for name in ("engine_device_ms", "readout_device_ms"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    # the window's requests alone: no warm-up request, no comparison
    requests = [q for q in profiling.records() if q.id is not None]
    assert len(requests) == r["attempted"]
    # no timeline on the CPU: the idle reader and the exchange give none
    assert "program_idle_ms" not in got and "exchange_ms" not in got
    profiling.clear()


def test_four_card_cell_reads_its_exchange_rounds(tmp_path):
    bench_dir = smallcopy.make(tmp_path, num_qubits=10)
    c, r = traced_run(bench_dir, "su2ring32_c64_4card.energy", 4)
    got = r["metrics"]
    assert got["exchange_ms"]["value"] > 0
    assert got["readout_passes"]["value"] > 0
    assert set(SPAN_READERS) <= set(got)
    # four virtual shards of one device, each standing for a card
    assert got["exchange_gib"]["value"] > 0
    profiling.clear()


class Timeline:
    """A traced window of 10 s with one card, busy in [0, 2], [3, 5] and
    [7, 10]; the program's span rq.run over [1, 4] and a host range of
    another kind over [5, 6.5]."""

    start, end, window_s, devices = 0.0, 10.0, 10.0, 1
    host = [(1.0, 4.0, "rq.run"), (5.0, 6.5, "portbench.readout")]

    @staticmethod
    def busy(card):
        return [(0.0, 2.0), (3.0, 5.0), (7.0, 10.0)]


def test_program_idle_counts_the_gaps_inside_program_spans(small):
    traced_run(small, "ring29_f32.energy")
    c = harness.Cell("ring29_f32.energy", small)
    rec = trace.Records(c.config, c.traffic, c.gates, 2, {}, {}, Timeline(),
                        1)
    read = c.reader("program_idle_ms")
    # the gap [2, 3] (middle 2.5, inside rq.run) counts; [5, 7] (middle 6,
    # in no program span) does not: 1 s over 2 requests
    assert read(rec) == pytest.approx(500.0)
    profiling.clear()
    assert read(rec) is None


def test_readers_give_nothing_without_program_records(small, monkeypatch):
    """A program whose profiling module keeps no records (the parent of
    this benchmark's span readers) gives no number and raises nothing."""
    c = harness.Cell("su2ring32_c64_4card.energy", small)
    rec = trace.Records(c.config, c.traffic, c.gates, 3, {}, {}, Timeline(),
                        4)
    monkeypatch.delattr(profiling, "records")
    for name in SPAN_READERS + ["program_idle_ms", "exchange_ms"]:
        assert workload.load_module("metrics", name, small).read(rec) is None


def test_the_window_leaves_out_requests_that_raised(monkeypatch):
    """A request that raised opened spans of its own, so the window's
    completed requests are the last ones whose spans all ended cleanly."""
    def request(rid, failed=False):
        span = profiling.SpanRecord("rq.run", rid, None, rid, 0.0, 1.0, {},
                                    {}, failed)
        return profiling.RequestRecord(rid, [span], {})

    done = [request(1), request(2), request(3, failed=True), request(4)]
    monkeypatch.setattr(profiling, "records", lambda: done)
    got = program_spans.window_requests(types.SimpleNamespace(requests=2))
    assert [r.id for r in got] == [2, 4]
