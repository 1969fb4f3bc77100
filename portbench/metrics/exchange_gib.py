"""Bytes moved between shards a request (parallel/sharded.permute_bits'
all-to-all rounds and gathers), from ``sharded.BYTES_MOVED``, in GiB."""


def read(rec):
    moved = rec.counters.get("bytes_moved", 0)
    return moved / rec.requests / 2**30 if moved and rec.requests else None
