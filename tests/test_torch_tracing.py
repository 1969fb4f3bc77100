"""The port's own spans and counters (``utils/profiling.py``): recorded
only while a ``torch.profiler`` session runs, nested by parent, grouped by
request, timed on the cards only where asked, with counts of readout
passes; and the bytes an exchange moves between mesh devices."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch.parallel import make_mesh, sharded
from rocquantum_tpu_torch.utils import profiling

CPU = torch.device("cpu")
N = 15  # the fused path's smallest state: a real float32 plane


def ring(q, *theta):
    for layer in range(2):
        for j in range(N):
            q.ry(theta[layer * N + j], j)
        for j in range(N):
            q.cx(j, (j + 1) % N)


def tfim(n, pairs=None, fields=None):
    """-sum Z_i Z_{i+1} - 0.5 sum X_i over ``pairs`` / ``fields`` (default
    the whole ring)."""
    op = rq.PauliOperator()
    for j in (range(n) if pairs is None else pairs):
        op = op + rq.PauliOperator({f"Z{j} Z{(j + 1) % n}": -1.0})
    for j in (range(n) if fields is None else fields):
        op = op + rq.PauliOperator({f"X{j}": -0.5})
    return op


@pytest.fixture
def program():
    profiling.clear()
    rng = np.random.default_rng(3)
    ir = rq.trace_kernel(ring, N, *rng.uniform(0, 6, 2 * N))
    yield rq.compile_program(ir, rq.Simulator(seed=3, device=CPU)), rng
    profiling.clear()


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_nothing_is_recorded_without_a_profiler(program):
    prog, rng = program
    before = dict(profiling.COUNTERS)
    handle = prog.run(rng.uniform(0, 6, 2 * N))
    handle.expval(tfim(N))
    handle.sample(list(range(N)), 16)
    assert profiling.records() == []
    assert profiling.RECORDER.stack == []
    # the counters count all the same
    assert profiling.COUNTERS["readout_passes"] > before["readout_passes"]


def test_spans_nest_under_their_parents(program):
    prog, rng = program

    def request():
        handle = prog.run(rng.uniform(0, 6, 2 * N))
        handle.expval(tfim(N))
        handle.sample(list(range(N)), 16)

    _, prof = traced(request)
    (req,) = profiling.records()
    by_id = {s.id: s for s in req.spans}
    parent = {s.name: by_id[s.parent].name if s.parent else None
              for s in req.spans}
    assert parent["rq.run"] is None
    assert parent["rq.run.params"] == parent["rq.run.init"] == "rq.run"
    assert parent["rq.run.gates"] == "rq.run"
    assert {by_id[s.parent].name for s in req.named("rq.run.pass")} == \
        {"rq.run"}
    assert parent["rq.expval"] is None and parent["rq.sample"] is None
    assert len(req.named("rq.expval.term")) == 2 * N
    assert {by_id[s.parent].name for s in req.named("rq.expval.term")} == \
        {"rq.expval"}
    for child in ("marginal", "draw", "to_host"):
        assert parent["rq.sample." + child] == "rq.sample"
    # the host clock on the CPU: a span's self time is what its children
    # leave uncovered
    run = req.named("rq.run")[0]
    kids = [s for s in req.spans if s.parent == run.id]
    assert run.ms["host"] >= run.self_ms["host"] >= 0
    assert run.self_ms["host"] == pytest.approx(
        run.ms["host"] - sum(k.ms["host"] for k in kids), abs=1e-6)
    # each span is also a profiler host range of its name
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {s.name for s in req.spans} <= ranges


def test_a_request_covers_run_and_the_readouts_on_its_handle(program):
    prog, rng = program

    def requests():
        handle = prog.run(rng.uniform(0, 6, 2 * N))
        handle.expval(tfim(N))
        again = prog.run(rng.uniform(0, 6, 2 * N))
        assert again is handle  # one Circuit handle, a new request
        handle.sample(list(range(N)), 8)
        handle.expval(tfim(N))

    traced(requests)
    first, second = profiling.records()
    assert second.id > first.id
    assert [s.name for s in first.spans if s.parent is None] == \
        ["rq.run", "rq.expval"]
    assert [s.name for s in second.spans if s.parent is None] == \
        ["rq.run", "rq.sample", "rq.expval"]
    assert all(s.request == first.id for s in first.spans)


def test_a_request_that_raises_is_marked_failed(program):
    prog, rng = program

    def requests():
        prog.run(rng.uniform(0, 6, 2 * N))
        with pytest.raises(ValueError):
            prog.run(rng.uniform(0, 6, 3))  # too few angles

    traced(requests)
    done, raised = profiling.records()
    assert not done.failed
    assert raised.failed and raised.named("rq.run")[0].failed
    assert not raised.named("rq.run.params")[0].failed


def test_readout_passes_match_a_hand_count(program):
    prog, rng = program
    handle = prog.run(rng.uniform(0, 6, 2 * N))
    assert handle.state[1] is None  # the real float32 plane
    # -Z0 Z1 - Z5 Z6 - 0.5 X2 - 0.5 X14 on a real float32 plane:
    # a Z Z term squares the plane (1), flips the sign of two half-planes
    # (2), casts to float64 (1) and sums (1): 5; an X term flips the plane
    # (1), multiplies by the state (1), casts (1) and sums (1): 4
    op = tfim(N, pairs=(0, 5), fields=(2, 14))
    traced(lambda: handle.expval(op))
    (req,) = profiling.records()
    assert req.counters["readout_passes"] == 2 * 5 + 2 * 4
    # sampling every qubit in order: the squares (1), their cast (1), the
    # cumulative sum (1)
    profiling.clear()
    traced(lambda: handle.sample(list(range(N)), 64))
    (req,) = profiling.records()
    assert req.counters["readout_passes"] == 3


def test_annotate_is_a_span():
    profiling.clear()
    with profiling.annotate("outside"):
        pass
    assert profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("phase"):
            pass
    (req,) = profiling.records()
    assert req.id is None and [s.name for s in req.spans] == ["phase"]
    profiling.clear()


class FakeStream:
    """A card's current stream."""

    def __init__(self, device):
        self.device = device

    def __str__(self):
        return f"stream of {self.device}"


class FakeEvent:
    """A CUDA event's calls, logged."""

    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream):
        FakeEvent.log.append(("record", str(stream)))
        self.t = float(len(FakeEvent.log))

    def synchronize(self):
        FakeEvent.log.append(("synchronize", None))

    def elapsed_time(self, other):
        return other.t - self.t


def test_spans_record_card_events_and_never_synchronize(monkeypatch):
    profiling.clear()
    FakeEvent.log.clear()
    card = torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: FakeStream(device))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a span synchronized"))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", request=profiling.NEW,
                            devices=[card, CPU, card]):
            with profiling.span("inner", devices=lambda: [card]):
                with profiling.span("host only"):
                    pass
    assert [k for k, _ in FakeEvent.log] == ["record"] * 4
    assert {s for _, s in FakeEvent.log} == {"stream of cuda:1"}
    (req,) = profiling.records()
    assert ("synchronize", None) in FakeEvent.log  # only when read
    outer, inner, host = req.spans
    assert outer.device == {"cuda:1": (0.0, 3.0)}
    assert inner.device == {"cuda:1": (1.0, 2.0)}
    assert outer.ms["cuda:1"] == 3.0 and outer.self_ms["cuda:1"] == 2.0
    assert outer.longest_ms == 3.0  # the card's clock, not the host's
    # a span given no cards keeps host times only, and its host interval
    # counts against the self time of the spans around it
    assert host.device == {} and set(host.ms) == {"host"}
    assert host.longest_ms == host.ms["host"]
    assert inner.self_ms["host"] == pytest.approx(
        inner.ms["host"] - host.ms["host"])
    assert host.request == inner.request == outer.request == req.id
    profiling.clear()


def test_cover_is_the_union_clipped():
    assert profiling._cover([(1, 3), (2, 5), (7, 20)], 0, 10) == 7
    assert profiling._cover([], 0, 10) == 0


def sharded_state(devices):
    """|psi> of a 6-qubit random state over a mesh of ``devices``."""
    rng = np.random.default_rng(5)
    psi = rng.normal(size=64) + 1j * rng.normal(size=64)
    psi = torch.as_tensor(psi / np.linalg.norm(psi), dtype=torch.complex64)
    return sharded.shard_state(psi, make_mesh(len(devices), devices=devices))


ALTERNATE = [CPU, torch.device("cpu", 0)] * 2  # shards 0, 2 | 1, 3


def test_bytes_moved_count_what_crosses_mesh_devices():
    """A round that moves shard bit 1 (global bit 5) keeps every chunk on
    its mesh device (shards 0 and 2 share one, 1 and 3 the other): no
    byte crosses. One that moves shard bit 0 sends one of the two
    8-amplitude chunks of each of 4 shards across (8 bytes an
    amplitude)."""
    state = sharded_state(ALTERNATE)
    sharded.reset_collectives()
    sharded.permute_bits(state, (3, 5), (5, 3))
    assert sharded.count_collectives()["all-to-all"] == 1
    assert sharded.BYTES_MOVED == 0
    sharded.permute_bits(state, (3, 4), (4, 3))
    assert sharded.BYTES_MOVED == 4 * 8 * 8
    # a mesh that repeats one device stands for one card a shard: the
    # round that moves shard bit 1 then crosses cards with half the state
    state = sharded_state([CPU] * 4)
    sharded.reset_collectives()
    sharded.permute_bits(state, (3, 5), (5, 3))
    assert sharded.BYTES_MOVED == 4 * 8 * 8


def test_gathers_and_reductions_count_only_other_devices():
    state = sharded_state(ALTERNATE)
    sharded.reset_collectives()
    sharded.gather(state)
    assert sharded.BYTES_MOVED == 2 * 16 * 8  # shards 1 and 3
    sharded.reset_collectives()
    sharded.gather_slice(state, 8, 32)  # 8 of shard 0, 16 of 1, 8 of 2
    assert sharded.BYTES_MOVED == 16 * 8
    sharded.reset_collectives()
    sharded.norm2(state)
    assert sharded.BYTES_MOVED == 2 * 8  # two float64 partials


def test_exchange_rounds_are_spans_of_the_sharded_program():
    profiling.clear()
    n = 12
    mesh = make_mesh(4, devices=ALTERNATE)

    def su2(q, *theta):
        for j in range(n):
            q.ry(theta[j], j)
        for j in range(n):
            q.cx((j - 1) % n, j)

    ir = rq.trace_kernel(su2, n, *np.linspace(0.1, 1.2, n))
    prog = rq.compile_program(ir, rq.Simulator(device=CPU), mesh=mesh)

    def request():
        handle = prog.run(np.linspace(0.3, 2.0, n))
        return handle.expval(tfim(n))

    sharded.reset_collectives()
    energy, _ = traced(request)
    (req,) = [r for r in profiling.records() if r.id is not None]
    rounds = req.named("rq.exchange")
    assert rounds and sharded.BYTES_MOVED > 0
    assert {s.parent for s in rounds} == {req.named("rq.run")[0].id}
    assert len(req.named("rq.expval.term")) == 2 * n
    assert req.counters["readout_passes"] > 0
    handle = prog.run(np.linspace(0.3, 2.0, n))
    assert handle.expval(tfim(n)) == pytest.approx(energy, abs=1e-6)
    profiling.clear()
