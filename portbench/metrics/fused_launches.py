"""Fused-kernel launches a request (the pass planner's passes), from the
program's counters ``fused_sv.LAUNCHES`` and ``fused_df64.LAUNCHES``."""


def read(rec):
    launches = rec.counters.get("fused_sv", 0) + rec.counters.get(
        "fused_df64", 0)
    return launches / rec.requests if launches and rec.requests else None
