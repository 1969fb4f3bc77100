"""Device-idle ms a request inside the program: the idle gaps of each
card's traced timeline (the device operations' union, as
``device_idle_share`` reads it) whose middle falls inside the union of
the program's spans (their profiler host ranges; nested spans add
nothing to it), summed, averaged over the cards, over the window's
completed requests."""

import bisect

from portbench import program_spans


def read(rec):
    tl = rec.timeline
    if tl is None or program_spans.window_requests(rec) is None:
        return None
    spans = program_spans.host_ranges(tl)
    if not spans:
        return None
    starts = [s for s, _ in spans]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and spans[i][1] >= t

    idle = 0.0
    for card in range(tl.devices):
        edge = tl.start
        for s, e in tl.busy(card) + [(tl.end, tl.end)]:
            if s > edge and inside((edge + s) / 2):
                idle += s - edge
            edge = max(edge, e)
    return 1e3 * idle / tl.devices / rec.requests
