"""Contraction memory accounting.

A copy of ``rocquantum_tpu/tensornet/workspace.py``. The reference managed
scratch memory with a 256-byte-aligned bump allocator over one device
block (256 MiB default); here the allocator owns memory, and the
counterpart is planning-time accounting: simulate a ContractionPlan's
live-buffer footprint so the executor can decide which steps need slicing
before anything is allocated.
"""

from __future__ import annotations

from typing import List, Sequence

from .pathfinder import ContractionPlan

DEFAULT_WORKSPACE_BYTES = 256 * 1024 * 1024  # reference default (hipTensorNet.h:94)


class WorkspaceEstimator:
    """Simulates live-set memory over a plan's execution.

    ``peak_bytes`` is the maximum simultaneous footprint (inputs of the
    current step + all not-yet-consumed tensors + the step output), the
    quantity the reference's bump allocator had to cover per step.
    """

    def __init__(self, itemsize: int = 8):
        self.itemsize = itemsize

    def step_footprints(self, plan: ContractionPlan,
                        input_sizes: Sequence[int]) -> List[int]:
        """Bytes live at each step (inputs still alive + step output)."""
        live = [int(s) for s in input_sizes]
        footprints = []
        for step in plan.steps:
            out_elems = step.out_size
            total = (sum(live) + out_elems) * self.itemsize
            footprints.append(total)
            live = [s for k, s in enumerate(live) if k not in (step.i, step.j)]
            live.append(out_elems)
        return footprints

    def peak_bytes(self, plan: ContractionPlan,
                   input_sizes: Sequence[int]) -> int:
        fps = self.step_footprints(plan, input_sizes)
        return max(fps) if fps else sum(input_sizes) * self.itemsize

    def violating_steps(self, plan: ContractionPlan,
                        input_sizes: Sequence[int],
                        limit_bytes: int) -> List[int]:
        """Indices of steps whose OUTPUT alone exceeds the limit — the
        steps the executor slices (findSlicingPoint analog,
        hipTensorNet.cpp:318-396)."""
        return [k for k, step in enumerate(plan.steps)
                if step.out_size * self.itemsize > limit_bytes]
