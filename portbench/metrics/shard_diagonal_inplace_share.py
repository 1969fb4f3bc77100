"""Share of a request's diagonal items on global bits that the sharded
runner scaled in place: 100 x the program's counter
``shard_diagonals_in_place`` over its counter ``shard_diagonals``, a
request, averaged over the window's requests that applied one. None from
a program that keeps no such counters."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    if requests is None:
        return None
    shares = [100.0 * r.counters.get("shard_diagonals_in_place", 0)
              / r.counters["shard_diagonals"]
              for r in requests if r.counters.get("shard_diagonals", 0) > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
