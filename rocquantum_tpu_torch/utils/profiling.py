"""Tracing / profiling helpers: the counterpart of
``rocquantum_tpu/utils/profiling.py``.

The reference had only wall-clock timing in examples (SURVEY §5). Here:
phase timers aggregated per name, which wait for the CUDA device at each
phase's edges so that a phase times the device work it issued, and
optional trace capture through ``torch.profiler`` (a Chrome trace, viewable
in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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
    card, CUDA activity) of the block into ``log_dir/trace.json``. The name
    is the JAX package's, whose version records an XLA trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield
