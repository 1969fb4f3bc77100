"""Readout passes a request: the program's counter ``readout_passes``
(torch operations its readouts issue over a whole plane or a half-plane
view: products, sign flips, flips, clones, casts to float64, sums,
cumsums, copies between cards), averaged over the window's requests."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    if requests is None:
        return None
    return sum(r.counters.get("readout_passes", 0)
               for r in requests) / len(requests)
