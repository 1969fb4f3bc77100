"""Tracing / profiling helpers: the counterpart of
``rocquantum_tpu/utils/profiling.py``.

The reference had only wall-clock timing in examples (SURVEY §5). Here:
phase timers aggregated per name, which wait for the CUDA device at each
phase's edges so that a phase times the device work it issued; optional
trace capture through ``torch.profiler`` (a Chrome trace, viewable in
Perfetto or chrome://tracing); and the program's own spans and counters.

Spans (:func:`span`) sit where the work happens: the engine's run and its
kernel passes, the readouts and their Pauli terms, the sharded exchange
rounds. They record only while a ``torch.profiler`` session is running,
checked by the profiler's own enabled flag at each span's entry;
otherwise a span is that flag check and nothing else. While on, a span
opens a profiler host range of its name, so the profiler's timeline
carries the program's spans, and keeps the counters (:data:`COUNTERS`)
that changed inside it. A span given the cards it runs on (``devices``)
also records a CUDA event at each edge on the current stream of each of
them, never synchronizing; the others keep host times only. Spans and
request records stay in memory until :func:`clear`; :func:`records`
resolves the events, once the caller has synchronized the device.

A request begins at ``CompiledProgram.run`` (a new request id); the
readouts on the Circuit handle it returns carry the same id until the
next run. ``adjoint_grad`` is a request of its own (``rq.grad``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

try:  # a range that stays on the host (a record_function range would also
    # put a ``gpu_user_annotation`` on the device's timeline)
    from torch._C._profiler import _RecordFunctionFast as _HostRange
except ImportError:  # pragma: no cover - older torch
    _HostRange = None

# Counters of work at the program's boundaries, plain integer adds whether
# or not a profiler runs: the readouts' plane passes, the Pauli terms they
# evaluate, and those of them the Pauli readout kernel served; the plans
# made because a plan cache missed; the dense two-qubit (4x4) gates the
# engines applied, and those of them the fused kernel applied; the
# parameterized gates the adjoint sweep walked back, and those of them the
# adjoint step kernel served; the diagonal items on global bits the sharded
# runner applied, and those of them it scaled in place.
COUNTERS: Dict[str, int] = {"readout_passes": 0, "readout_terms": 0,
                             "readout_kernel_terms": 0, "plan_misses": 0,
                             "dense2q_gates": 0, "dense2q_kernel_gates": 0,
                             "adjoint_steps": 0, "adjoint_kernel_steps": 0,
                             "shard_diagonals": 0,
                             "shard_diagonals_in_place": 0}

# what a span given ``request=NEW`` does: start a new request
NEW = object()


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name``."""
    COUNTERS[name] += k


def _synchronize(device) -> None:
    """Wait for ``device``'s queued work when it is a CUDA device (None:
    the current CUDA device, if CUDA has been used)."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Off:
    """The span of a process with no profiler running: does nothing."""

    request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _cards(devices) -> Tuple[torch.device, ...]:
    """The CUDA devices among ``devices`` (or among what it returns, when
    it is a function; None: none), each once."""
    if callable(devices):
        devices = devices()
    if devices is None:
        return ()
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            d = torch.device("cuda", d.index if d.index is not None
                             else torch.cuda.current_device())
            if d not in out:
                out.append(d)
    return tuple(out)


def _event(card: torch.device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(card))
    return ev


class _Span:
    __slots__ = ("name", "id", "parent", "request", "cards", "t0", "t1",
                 "ev0", "ev1", "start_counts", "counters", "range", "rec",
                 "failed")

    def __init__(self, rec: "Recorder", name: str, request, devices):
        parent = rec.stack[-1] if rec.stack else None
        self.rec = rec
        self.name = name
        self.id = next(rec.span_ids)
        self.parent = None if parent is None else parent.id
        if request is NEW:
            request = next(rec.request_ids)
        elif request is None and parent is not None:
            request = parent.request
        self.request = request
        self.cards = _cards(devices)

    def __enter__(self):
        self.start_counts = dict(COUNTERS)
        self.range = None
        if _HostRange is not None:
            self.range = _HostRange(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        # a span on no card keeps the empty tuple, which the collector
        # does not track: a window holds thousands of finished spans
        self.ev0 = tuple(_event(c) for c in self.cards) if self.cards else ()
        self.rec.stack.append(self)
        return self

    def __exit__(self, exc_type, *exc):
        self.failed = exc_type is not None
        self.ev1 = tuple(_event(c) for c in self.cards) if self.cards else ()
        self.t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        stack = self.rec.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.counters = {k: v - self.start_counts.get(k, 0)
                         for k, v in COUNTERS.items()
                         if v != self.start_counts.get(k, 0)}
        self.rec.done.append(self)
        return False


@dataclasses.dataclass
class SpanRecord:
    """A finished span. ``start_s``/``end_s`` are host seconds
    (``time.perf_counter``). ``device`` maps each card the span touched
    (``"cuda:0"``) to its ``(start_ms, end_ms)`` from CUDA events, counted
    from that card's first recorded event; a span on no card has none.
    ``ms`` is the duration by clock (``"host"`` and each card) and
    ``self_ms`` the same less the part its child spans cover on that clock
    (on a card's, only children timed there). ``failed``: the span ended
    by an exception."""

    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_s: float
    end_s: float
    device: Dict[str, Tuple[float, float]]
    counters: Dict[str, int]
    failed: bool = False
    ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    self_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def intervals(self) -> Dict[str, Tuple[float, float]]:
        """(start, end) in ms by clock: the host's and each card's."""
        return {"host": (1e3 * self.start_s, 1e3 * self.end_s),
                **self.device}

    @property
    def card_ms(self) -> Dict[str, float]:
        """The duration on each card, or on the host for a span timed on
        no card."""
        if not self.device:
            return {"host": self.ms["host"]}
        return {card: self.ms[card] for card in self.device}

    @property
    def longest_ms(self) -> float:
        """The longest of :attr:`card_ms`."""
        return max(self.card_ms.values())


@dataclasses.dataclass
class RequestRecord:
    """The spans of one request (``id`` None: spans of no request) in start
    order, and the counters that changed inside its outermost spans."""

    id: Optional[int]
    spans: List[SpanRecord]
    counters: Dict[str, int]

    def named(self, name: str) -> List[SpanRecord]:
        return [s for s in self.spans if s.name == name]

    @property
    def failed(self) -> bool:
        """Some span of the request ended by an exception."""
        return any(s.failed for s in self.spans)


def _cover(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, edge = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, edge), min(e, hi)
        if e > s:
            total += e - s
            edge = e
    return total


class Recorder:
    """Spans of the process, in memory: the open ones (a stack) and the
    finished ones."""

    def __init__(self):
        self.stack: List[_Span] = []
        self.done: List[_Span] = []
        self.span_ids = itertools.count(1)
        self.request_ids = itertools.count(1)
        self.resolved: Tuple[int, List[RequestRecord]] = (0, [])

    def clear(self):
        self.done.clear()
        self.resolved = (0, [])

    def records(self) -> List[RequestRecord]:
        """Finished spans resolved and grouped by request, in request
        order (spans of no request first); resolved again only after more
        spans finished. Waits for each span's closing events, which the
        caller's synchronize has normally completed."""
        if self.resolved[0] != len(self.done):
            self.resolved = (len(self.done), self._resolve())
        return self.resolved[1]

    def _resolve(self) -> List[RequestRecord]:
        spans = sorted(self.done, key=lambda s: s.t0)
        origin = {}
        for s in spans:
            for card, ev in zip(s.cards, s.ev0):
                origin.setdefault(str(card), ev)
        out: List[SpanRecord] = []
        for s in spans:
            device = {}
            for card, e0, e1 in zip(s.cards, s.ev0, s.ev1):
                e1.synchronize()
                o = origin[str(card)]
                device[str(card)] = (o.elapsed_time(e0), o.elapsed_time(e1))
            out.append(SpanRecord(s.name, s.id, s.parent, s.request,
                                  s.t0 * 1e-9, s.t1 * 1e-9, device,
                                  dict(s.counters), s.failed))
        children = defaultdict(list)
        for r in out:
            if r.parent is not None:
                children[r.parent].append(r)
        for r in out:
            for clock, (lo, hi) in r.intervals().items():
                r.ms[clock] = hi - lo
                kids = [k.intervals()[clock] for k in children[r.id]
                        if clock in k.intervals()]
                r.self_ms[clock] = hi - lo - _cover(kids, lo, hi)
        by_request: Dict[Optional[int], RequestRecord] = {}
        known = {r.id for r in out}
        for r in out:
            req = by_request.setdefault(r.request,
                                        RequestRecord(r.request, [], {}))
            req.spans.append(r)
            if r.parent is None or r.parent not in known:
                for k, v in r.counters.items():
                    req.counters[k] = req.counters.get(k, 0) + v
        return sorted(by_request.values(),
                      key=lambda q: -1 if q.id is None else q.id)


RECORDER = Recorder()


def span(name: str, request=None, devices: Optional[Sequence] = None):
    """A span named ``name`` (a context manager), recorded while a
    ``torch.profiler`` session runs. ``request``: :data:`NEW` starts a
    request, an id joins one, None takes the enclosing span's. ``devices``:
    the cards whose current streams get an event at the span's edges, or a
    function that returns them, called only while recording; None (the
    default) keeps host times only, for a span whose device time nothing
    reads."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(RECORDER, name, request, devices)


def records() -> List[RequestRecord]:
    """The recorded spans by request (:meth:`Recorder.records`)."""
    return RECORDER.records()


def clear() -> None:
    """Forget every finished span."""
    RECORDER.clear()


class PhaseTimer:
    """Accumulates wall-clock per named phase. ``device`` (default: the
    current CUDA device, when there is one) is synchronized when a phase
    starts and when it ends, so a phase counts the device work it issued.

    >>> timer = PhaseTimer()
    >>> with timer.phase("compile"):
    ...     ...
    >>> timer.summary()
    """

    def __init__(self, device=None):
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        _synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_s": self.totals[name] / self.counts[name]}
                for name in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Record a ``torch.profiler`` Chrome trace (host and, when there is a
    card, CUDA activity) of the block into ``log_dir/trace.json``; the
    program's spans inside it are recorded too. The name is the JAX
    package's, whose version records an XLA trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace: a :func:`span`."""
    with span(name):
        yield
