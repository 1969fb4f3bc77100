"""The reader of ``shard_diagonal_inplace_share``: the share of a
request's diagonal items on global bits that the sharded runner scaled in
place, from the program's counters, and nothing from a program that keeps
no such counters."""

import sys
import types

import pytest

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import workload  # noqa: E402
from rocquantum_tpu_torch.utils import profiling  # noqa: E402


@pytest.mark.parametrize("counters,want", [
    # the four-card cell: 9 global diagonal blocks a request, all in place
    ([{"shard_diagonals": 9, "shard_diagonals_in_place": 9}] * 2, 100.0),
    # df64 planes: counted, none in place; then a complex request
    ([{"shard_diagonals": 4},
      {"shard_diagonals": 4, "shard_diagonals_in_place": 4}], 50.0),
    # a one-card request counts none; a program that keeps no such
    # counters (the parent of the in-place path) likewise
    ([{"readout_passes": 3}] * 2, None),
])
def test_shard_diagonal_inplace_share_reads_the_counters(monkeypatch,
                                                         counters, want):
    done = [profiling.RequestRecord(i + 1, [], c)
            for i, c in enumerate(counters)]
    monkeypatch.setattr(profiling, "records", lambda: done)
    read = workload.load_module("metrics", "shard_diagonal_inplace_share",
                                smallcopy.BENCH).read
    rec = types.SimpleNamespace(requests=len(done))
    assert read(rec) == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "records")
    assert read(rec) is None
