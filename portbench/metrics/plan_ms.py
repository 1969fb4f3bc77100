"""Host time a request inside the program's ``rq.plan`` spans (a plan
made because ``compile_ir`` or ``compile_pair32_ir`` missed its cache),
averaged over the window's requests, in ms: 0 where every request found
its plan. None from a program that keeps no such span (no
``plan_misses`` counter) or no request records."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    try:
        from rocquantum_tpu_torch.utils import profiling
        kept = "plan_misses" in profiling.COUNTERS
    except (ImportError, AttributeError):
        kept = False
    if requests is None or not kept:
        return None
    return sum(sum(s.ms["host"] for s in r.named("rq.plan"))
               for r in requests) / len(requests)
