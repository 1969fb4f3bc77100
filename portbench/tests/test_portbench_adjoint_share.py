"""The reader of ``adjoint_kernel_share``: the share of a request's
parameterized gates whose adjoint step the program's kernel served, from
the program's step counters, and nothing from a program that keeps no
such counters."""

import sys
import types

import pytest

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import workload  # noqa: E402
from rocquantum_tpu_torch.utils import profiling  # noqa: E402


@pytest.mark.parametrize("counters,want", [
    # every step on the kernel in one request, 200 of 208 in the other
    ([{"adjoint_steps": 208, "adjoint_kernel_steps": 208},
      {"adjoint_steps": 208, "adjoint_kernel_steps": 200}], 98.07692307692308),
    # CPU planes or the exact engine: steps counted, none on the kernel
    ([{"adjoint_steps": 208, "readout_passes": 3}] * 2, 0.0),
    # a program that counts no steps (the parent of the kernel)
    ([{"readout_passes": 3}] * 2, None),
])
def test_adjoint_kernel_share_reads_the_step_counters(monkeypatch, counters,
                                                      want):
    done = [profiling.RequestRecord(i + 1, [], c)
            for i, c in enumerate(counters)]
    monkeypatch.setattr(profiling, "records", lambda: done)
    read = workload.load_module("metrics", "adjoint_kernel_share",
                                smallcopy.BENCH).read
    rec = types.SimpleNamespace(requests=len(done))
    assert read(rec) == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "records")
    assert read(rec) is None
