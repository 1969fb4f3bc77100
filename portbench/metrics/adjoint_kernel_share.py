"""Share of a request's parameterized gates whose adjoint step the adjoint
step kernel served: 100 x the program's counter ``adjoint_kernel_steps``
over its counter ``adjoint_steps``, a request, averaged over the window's
requests that walked one back. None from a program that keeps no such
counters."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    if requests is None:
        return None
    shares = [100.0 * r.counters.get("adjoint_kernel_steps", 0)
              / r.counters["adjoint_steps"]
              for r in requests if r.counters.get("adjoint_steps", 0) > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
