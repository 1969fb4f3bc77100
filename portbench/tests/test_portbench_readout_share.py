"""The reader of ``readout_kernel_share``: the share of a request's Pauli
terms that the program's readout kernel served, from the program's term
counters, and nothing from a program that keeps no such counters."""

import sys
import types

import pytest

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import workload  # noqa: E402
from rocquantum_tpu_torch.utils import profiling  # noqa: E402


@pytest.mark.parametrize("counters,want", [
    # every term on the kernel in one request, 62 of 64 in the other
    ([{"readout_terms": 58, "readout_kernel_terms": 58},
      {"readout_terms": 64, "readout_kernel_terms": 62}], 98.4375),
    # the plain readout counts terms and serves none on the kernel
    ([{"readout_terms": 58, "readout_passes": 261}] * 2, 0.0),
    # a program that counts no terms (the parent of the kernel)
    ([{"readout_passes": 261}] * 2, None),
])
def test_readout_kernel_share_reads_the_term_counters(monkeypatch, counters,
                                                      want):
    done = [profiling.RequestRecord(i + 1, [], c)
            for i, c in enumerate(counters)]
    monkeypatch.setattr(profiling, "records", lambda: done)
    read = workload.load_module("metrics", "readout_kernel_share",
                                smallcopy.BENCH).read
    rec = types.SimpleNamespace(requests=len(done))
    assert read(rec) == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "records")
    assert read(rec) is None
