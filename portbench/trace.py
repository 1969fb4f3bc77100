"""Spans, the profiler, and the records the per-layer readers take.

Spans are the benchmark's own: a host clock around a public call of the
program, the device synchronized at both edges, in the traced run only.
Each is also a ``record_function`` range, so the profiler's timeline says
what the host was doing while the device sat idle.
"""

import bisect
import contextlib
import time
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
TOP = 10


class Spans:
    """Durations in seconds by span name; nothing is recorded when
    ``enabled`` is false."""

    def __init__(self, enabled, sync):
        self.enabled = enabled
        self.sync = sync
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name):
        if not self.enabled:
            yield
            return
        self.sync()
        t0 = time.perf_counter()
        with record_function("portbench." + name):
            yield
            self.sync()
        self.seconds[name].append(time.perf_counter() - t0)


def profiler(cuda):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    """The traced window read from a finished profiler: device operations
    by card, host ranges, and the window's edges (the benchmark's
    ``portbench.window`` range), all in seconds."""

    def __init__(self, prof, devices):
        self.device_ops = defaultdict(list)  # card -> [(name, start, end)]
        host = []
        window = None
        for e in prof.profiler.kineto_results.events():
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CUDA:
                # the device's copies of the benchmark's host ranges are
                # no device work
                if not e.name().startswith("portbench."):
                    self.device_ops[e.device_index()].append(
                        (e.name(), s, s + d))
            elif e.name() == WINDOW:
                window = (s, s + d)
            else:
                host.append((s, s + d, e.name()))
        if window is None:
            raise RuntimeError("the traced window has no portbench.window "
                               "range")
        self.start, self.end = window
        self.window_s = self.end - self.start
        self.devices = devices
        host.sort()
        self.host = host
        self.host_starts = [h[0] for h in host]

    def busy(self, card):
        """Merged intervals of device work on ``card`` inside the window."""
        clipped = [(max(s, self.start), min(e, self.end))
                   for _, s, e in self.device_ops.get(card, [])]
        return _merge([(s, e) for s, e in clipped if e > s])

    def busy_s(self):
        """Seconds in which an operation ran, averaged over the cards."""
        return sum(sum(e - s for s, e in self.busy(c))
                   for c in range(self.devices)) / self.devices

    def kernel_seconds(self, match):
        """Device seconds, summed over the cards, of the operations whose
        name ``match`` accepts, inside the window."""
        return sum(min(e, self.end) - max(s, self.start)
                   for ops in self.device_ops.values() for name, s, e in ops
                   if match(name) and e > self.start and s < self.end)

    def _host_at(self, t):
        """The innermost host range open at ``t``."""
        i = bisect.bisect_right(self.host_starts, t)
        for j in range(i - 1, max(i - 2000, 0) - 1, -1):
            s, e, name = self.host[j]
            if e >= t:
                return name
        return "host: nothing traced"

    def breakdown(self):
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at their middle."""
        ops = defaultdict(float)
        for card_ops in self.device_ops.values():
            for name, s, e in card_ops:
                if e > self.start and s < self.end:
                    ops[name[:160]] += min(e, self.end) - max(s, self.start)
        gaps = defaultdict(float)
        for c in range(self.devices):
            edge = self.start
            for s, e in self.busy(c) + [(self.end, self.end)]:
                if s > edge:
                    gaps[self._host_at((edge + s) / 2)[:160]] += s - edge
                edge = max(edge, e)
        top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


class Records:
    """What a per-layer reader takes: the cell's sizes and circuit, the
    requests completed in the traced window, the benchmark's spans, the
    program's counters over the window, and the device timeline (None
    without a card)."""

    def __init__(self, config, traffic, gates, requests, spans, counters,
                 timeline, chips):
        self.config = config
        self.traffic = traffic
        self.gates = gates
        self.requests = requests
        self.spans = spans
        self.counters = counters
        self.timeline = timeline
        self.chips = chips
