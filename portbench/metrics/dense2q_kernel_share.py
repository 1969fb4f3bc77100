"""Share of a request's dense two-qubit (4x4) gates that the fused kernel
applied: 100 x the program's counter ``dense2q_kernel_gates`` over its
counter ``dense2q_gates``, a request, averaged over the window's requests
that applied one. None from a program that keeps no such counters."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    if requests is None:
        return None
    shares = [100.0 * r.counters.get("dense2q_kernel_gates", 0)
              / r.counters["dense2q_gates"]
              for r in requests if r.counters.get("dense2q_gates", 0) > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
