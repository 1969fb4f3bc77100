"""roofline.py reproduces the per-pass bounds PERF.md reads the kernels
against: 1.282 ms for an f32 pass at n = 29, 0.432 ms on average for a
df64 pass of the ring's layer at n = 26."""

import sys

import numpy as np
import pytest

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import roofline, workload  # noqa: E402


# a representative benchmark gate for each kind the planner names
AS_GATE = {"U": ("RY", (0,), 0), "D2": ("RZ", (0,), 0),
           "CNOT": ("CX", (0, 1), None)}


def layer_passes(n, df):
    """The gates of each of the planner's passes of one ring layer, as
    ``chip_smoke.py`` takes them."""
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir
    from rocquantum_tpu_torch.ops import fused_df64, fused_sv
    (block,) = interpreter.plan_items(hardware_efficient_ansatz_ir(n, 1).ops,
                                      n)
    angles = np.random.default_rng(0).normal(size=n)
    if df:
        kinds, supports, _, _ = interpreter.pallas_block_specs_df64(
            block, angles)
    else:
        kinds, supports, _, _ = interpreter.pallas_block_specs(block, angles)
    plan = interpreter.kernel_plan(n, kinds, supports,
                                   fused_df64 if df else fused_sv)
    return [[AS_GATE[kinds[i]] for i in item.gate_idx] for item in plan]


@pytest.mark.parametrize("n, df, planes, want", [
    (29, False, 1, 1.282), (26, True, 2, 0.432)])
def test_per_pass_bounds(n, df, planes, want):
    """The mean over a layer's passes of each pass's least time (one
    launch), as PERF.md reads the kernels against."""
    passes = layer_passes(n, df)
    ms = 1e3 * np.mean([roofline.least_seconds(n, g, df, 1, 1, 0, planes,
                                                1)[0] for g in passes])
    assert round(ms, 3) == want


def ring(n, layers=8):
    return workload.circuit({"generator": "basic_entangler",
                             "num_qubits": n, "layers": layers,
                             "rotation": "RY"})


def test_request_bounds_of_the_cells():
    ring29 = ring(29)
    assert roofline.state_planes(ring29, False) == 1
    # 36 launches from the fill's plane: bytes bound the f32 request
    secs, by = roofline.least_seconds(29, ring29, False, 1, 36, 0, 1, 1)
    assert by == "bytes" and round(secs * 1e3, 1) == 46.2
    assert round(roofline.circuit_instructions(29, ring29, False)
                 / roofline.FP32_INSTR_PER_S * 1e3, 1) == 7.4
    # df64 at n = 26: the instructions bound 43 launches
    secs, by = roofline.least_seconds(26, ring(26), True, 1, 43, 0, 2, 1)
    assert by == "operations" and round(secs * 1e3, 1) == 15.8
    # a launch from |0...0> reads nothing; four cards share the bytes
    assert roofline.launch_bytes(20, 3, 1, 2, 4) == 5 * (1 << 18) * 8
    su2 = workload.circuit({"generator": "efficient_su2", "num_qubits": 6,
                            "reps": 1, "su2_gates": ["ry", "rz"],
                            "entanglement": "circular"})
    assert roofline.state_planes(su2, False) == 2
    assert roofline.state_planes(su2, True) == 4


def test_gates_are_counted_by_their_matrices():
    """A flip computes nothing, a diagonal is one product a component, a
    controlled matrix acts on half the amplitudes; RZZ is a diagonal
    between two flips and SWAP three flips."""
    n = 10
    count = lambda g: roofline.circuit_instructions(  # noqa: E731
        n, [g], False) / (1 << n)
    assert count(("CX", (0, 1), None)) == count(("SWAP", (0, 1), None)) \
        == count(("X", (3,), None)) == 0
    assert count(("RY", (0,), 0)) == roofline.gate_ops("U", True, False,
                                                       False)
    assert count(("RZ", (0,), 0)) == count(("RZZ", (0, 1), 0)) == \
        roofline.gate_ops("D2", False, True, False)
    assert count(("CRY", (0, 1), 0)) == roofline.gate_ops("CU", True, False,
                                                          False)
