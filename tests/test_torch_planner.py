"""The port's kernel-pass planning against the JAX package's.

With the TPU's window (reach = 17) and pair capacity (max_pairs = 3), the
port's ``fuse_pallas_runs`` -> ``plan_full_layer`` must give item-for-item
the plans the JAX package gives; and inside the port the native C++
planner and the Python planner must agree at the port's own geometry.
"""

import numpy as np
import pytest

from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.compiler import passes as jax_passes
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.ops import relabel as jax_relabel
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.compiler import interpreter as port_interp
from rocquantum_tpu_torch.compiler import passes as port_passes
from rocquantum_tpu_torch.ops import fused_sv
from rocquantum_tpu_torch.ops import relabel as port_relabel

TPU_REACH = 17
TPU_PAIRS = 3


def _plan_key(plan):
    return [(tuple(p.gate_idx), tuple(tuple(x) for x in p.positions),
             tuple(p.pair_bits)) for p in plan]


def _op_key(op):
    params = tuple(("p", p.index) if hasattr(p, "index") else p
                   for p in op.params)
    return (op.name, op.targets, op.controls, params, op.is_adjoint)


def _item_key(item):
    if isinstance(item, (jax_passes.PallasBlock, port_passes.PallasBlock)):
        return ("block", tuple(_op_key(op) for op in item.ops))
    return ("op", _op_key(item))


def _plans_for(items, interp, relabel, n, **kw):
    out = []
    for item in items:
        if type(item).__name__ != "PallasBlock":
            continue
        kinds, supports = zip(*(interp._classify_spec(op)
                                for op in item.ops))
        anchors = interp._spec_anchors(kinds, supports, TPU_REACH)
        out.append(_plan_key(relabel.plan_full_layer(
            n, list(supports), TPU_REACH, pair_ok=True, anchors=anchors,
            **kw)))
    return out


@pytest.mark.parametrize("n", [20, 23, 26, 29])
@pytest.mark.parametrize("layers", [1, 2])
def test_ring_ansatz_plans_match_reference(n, layers):
    jax_ir = jax_circuits.hardware_efficient_ansatz_ir(n, layers)
    port_ir = convert.ir_from_reference(jax_ir)
    j_items = jax_passes.fuse_pallas_runs(list(jax_ir.ops), n - 1,
                                          num_qubits=n,
                                          relabel_reach=TPU_REACH)
    p_items = port_passes.fuse_pallas_runs(list(port_ir.ops), n - 1,
                                           num_qubits=n,
                                           relabel_reach=TPU_REACH)
    assert [_item_key(i) for i in p_items] == [_item_key(i) for i in j_items]
    want = _plans_for(j_items, jax_interp, jax_relabel, n)
    got = _plans_for(p_items, port_interp, port_relabel, n,
                     max_pairs=TPU_PAIRS)
    assert want and got == want


def _random_layer(rng, n, count):
    """Random 1q / CNOT / CU / diagonal supports with their kinds."""
    kinds, supports = [], []
    for _ in range(count):
        r = rng.random()
        a, b = (int(q) for q in rng.choice(n, 2, replace=False))
        if r < 0.4:
            kinds.append("U")
            supports.append((a,))
        elif r < 0.7:
            kinds.append("CNOT")
            supports.append((a, b))
        elif r < 0.85:
            kinds.append("CU")
            supports.append((a, b))
        else:
            kinds.append("D2")
            supports.append((a, b))
    return kinds, supports


@pytest.mark.parametrize("seed", range(6))
def test_random_supports_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 30))
    kinds, supports = _random_layer(rng, n, 60)
    anchors = jax_interp._spec_anchors(kinds, supports, TPU_REACH)
    assert port_interp._spec_anchors(kinds, supports, TPU_REACH) == anchors
    want = jax_relabel.plan_full_layer(n, supports, TPU_REACH,
                                       anchors=anchors)
    got = port_relabel.plan_full_layer(n, supports, TPU_REACH,
                                       max_pairs=TPU_PAIRS, anchors=anchors)
    assert _plan_key(got) == _plan_key(want)


@pytest.mark.parametrize("seed", range(6))
def test_native_and_python_planners_agree(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(15, 31))
    kinds, supports = _random_layer(rng, n, 80)
    reach = fused_sv.window_bits(n)
    anchors = port_interp._spec_anchors(kinds, supports, reach)
    native = port_relabel.plan_full_layer(n, supports, reach,
                                          anchors=anchors)
    python = port_relabel.plan_full_layer(n, supports, reach,
                                          anchors=anchors, use_native=False)
    assert _plan_key(native) == _plan_key(python)


def test_plans_respect_kernel_geometry_and_order():
    """Every pass of the port's plan fits the kernel (anchored qubits in
    the window or the pass's <= MAX_PAIRS pair bits), and every gate is
    scheduled once, never overtaking an earlier gate on a shared qubit."""
    rng = np.random.default_rng(7)
    n = 26
    kinds, supports = _random_layer(rng, n, 120)
    reach = fused_sv.window_bits(n)
    anchors = port_interp._spec_anchors(kinds, supports, reach)
    plan = port_relabel.plan_full_layer(n, supports, reach, anchors=anchors)
    order = [i for p in plan for i in p.gate_idx]
    assert sorted(order) == list(range(len(supports)))
    position = {g: k for k, g in enumerate(order)}
    for i in range(len(supports)):
        for j in range(i):
            if set(supports[i]) & set(supports[j]):
                assert position[j] < position[i]
    for p in plan:
        assert len(p.pair_bits) <= fused_sv.MAX_PAIRS
        for i in p.gate_idx:
            assert all(q < reach or q in p.pair_bits for q in anchors[i])


def test_planner_rejects_unschedulable_gate():
    with pytest.raises(ValueError):
        port_relabel.plan_full_layer(24, [(20, 21)], 10, max_pairs=1)
    with pytest.raises(ValueError):
        port_relabel.plan_full_layer(12, [(12,)], 10)
