"""Share of the traced window in which no operation ran on the device,
averaged over the cell's cards, in %."""


def read(rec):
    tl = rec.timeline
    if tl is None or tl.window_s <= 0:
        return None
    busy = tl.busy_s()
    return 100.0 * (1.0 - busy / tl.window_s) if busy > 0 else None
