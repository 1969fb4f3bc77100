"""Share of a request's Pauli terms that the Pauli readout kernel served:
100 x the program's counter ``readout_kernel_terms`` over its counter
``readout_terms``, a request, averaged over the window's requests that
read a term. None from a program that keeps no such counters."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    if requests is None:
        return None
    shares = [100.0 * r.counters.get("readout_kernel_terms", 0)
              / r.counters["readout_terms"]
              for r in requests if r.counters.get("readout_terms", 0) > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
