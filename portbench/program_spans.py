"""The program's own spans and counters (``rocquantum_tpu_torch.utils.
profiling``) over the traced window, for the per-layer readers.

The program records them only while the harness's profiler runs, which
is the window: its completed requests are the last ``rec.requests``
request records in which no span ended by an exception (earlier traced
windows of the same process come before them). A program that keeps no
such records gives None everywhere.
"""

PREFIX = "rq."  # the program's span names, and the profiler ranges of them


def window_requests(rec):
    """The request records of the window's completed requests, or None."""
    try:
        from rocquantum_tpu_torch.utils import profiling
        records = profiling.records
    except (ImportError, AttributeError):
        return None
    requests = [r for r in records()
                if r.id is not None and not getattr(r, "failed", False)]
    if not requests or not rec.requests:
        return None
    return requests[-rec.requests:]


def host_ranges(tl):
    """The union of the program's host ranges inside the window of
    timeline ``tl``: sorted, disjoint ``(start, end)`` pairs."""
    merged = []
    for s, e in sorted((s, e) for s, e, name in tl.host
                       if name.startswith(PREFIX)
                       and e > tl.start and s < tl.end):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def mean_span_ms(rec, names):
    """Mean over the window's requests of the summed duration of their
    spans named in ``names`` (each on the card where it is longest), in
    ms; None when no request has one."""
    requests = window_requests(rec)
    if requests is None:
        return None
    totals = [sum(s.longest_ms for s in r.spans if s.name in names)
              for r in requests]
    if not any(s.name in names for r in requests for s in r.spans):
        return None
    return sum(totals) / len(totals)
