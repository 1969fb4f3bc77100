"""The port's kernel-pass planning against the JAX package's.

With the TPU's window (reach = 17) and pair capacity (max_pairs = 3), the
port's ``fuse_pallas_runs`` -> ``plan_full_layer`` must give item-for-item
the plans the JAX package gives; and inside the port the native C++
planner and the Python planner must agree at the port's own geometry.
"""

import numpy as np
import pytest
import torch

from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.compiler import passes as jax_passes
from rocquantum_tpu.models import circuits as jax_circuits
from rocquantum_tpu.ops import relabel as jax_relabel
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.compiler import interpreter as port_interp
from rocquantum_tpu_torch.compiler import passes as port_passes
from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp, ParamRef
from rocquantum_tpu_torch.ops import fused_sv
from rocquantum_tpu_torch.ops import statevec as sv
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
    """Every pass of the port's real-plane plan fits the f32 kernel's
    planner geometry (anchored qubits below the reach or among the pass's
    <= MAX_PAIRS pair bits, so a tile of at most 2^12 amplitudes), and
    every gate is scheduled once, never overtaking an earlier gate on a
    shared qubit."""
    rng = np.random.default_rng(7)
    n = 26
    kinds, supports = _random_layer(rng, n, 120)
    reach, limit = fused_sv.plan_geometry(n, complex_carry=False)
    assert limit == fused_sv.MAX_PAIRS
    anchors = port_interp._spec_anchors(kinds, supports, reach)
    plan = port_relabel.plan_full_layer(n, supports, reach, max_pairs=limit,
                                        anchors=anchors)
    order = [i for p in plan for i in p.gate_idx]
    assert sorted(order) == list(range(len(supports)))
    position = {g: k for k, g in enumerate(order)}
    for i in range(len(supports)):
        for j in range(i):
            if set(supports[i]) & set(supports[j]):
                assert position[j] < position[i]
    for p in plan:
        assert len(p.pair_bits) <= limit
        for i in p.gate_idx:
            assert all(q < reach or q in p.pair_bits for q in anchors[i])
        specs = fused_sv._normalize_specs(
            [(kinds[i],) + tuple(s) for i, s in zip(p.gate_idx, p.positions)])
        for launch in fused_sv.pass_schedule(n, specs):
            assert launch.tile_bits <= fused_sv.ROW_BITS + limit


def test_ring_ansatz_pass_counts_per_kernel():
    """Each fused kernel plans with its own geometry: the f32 kernel's
    real plane (reach 7, 5 pair bits) takes 36 passes for the n = 29,
    8-layer ring ansatz; the df64 kernel keeps the 10-bit window and 3 pair
    bits, 43 passes at n = 26."""
    from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir
    from rocquantum_tpu_torch.ops import fused_df64
    counts = {}
    for n, kernel in ((29, fused_sv), (26, fused_df64)):
        items = port_interp.plan_items(
            hardware_efficient_ansatz_ir(n, 8).ops, n)
        counts[n] = sum(port_interp.block_pass_count(item, n, kernel)
                        for item in items
                        if isinstance(item, port_passes.PallasBlock))
    assert counts == {29: 36, 26: 43}
    assert fused_df64.plan_geometry(26, False) == (10, 3)


def test_planner_rejects_unschedulable_gate():
    with pytest.raises(ValueError):
        port_relabel.plan_full_layer(24, [(20, 21)], 10, max_pairs=1)
    with pytest.raises(ValueError):
        port_relabel.plan_full_layer(12, [(12,)], 10)


def _cached_plan_case(path, n):
    """(IR, run(compiled, values) -> planes) of one engine path at n
    qubits: RY (real) or RX (complex) angles on every qubit and a CNOT
    ring, with two fixed dense 4x4 gates on the flat path."""
    gate = "RX" if path == "pair_complex" else "RY"
    ops = [GateOp(gate, (q,), (), (ParamRef(q),)) for q in range(n)]
    ops += [GateOp("CNOT", (q,), ((q + 1) % n,)) for q in range(n)]
    if path == "flat_u4":
        u = np.linalg.qr(np.arange(16).reshape(4, 4) + 1j * np.eye(4))[0]
        ops += [GateOp("UNITARY", (0, 5), (), (), u),
                GateOp("UNITARY", (3, 2), (), (), u.T)]
    ir = CircuitIR(n, ops)
    cpu = torch.device("cpu")
    if path == "flat_u4":
        return ir, lambda: port_interp.compile_ir(ir), \
            lambda fn, v: (fn(sv.init_state(n, device=cpu), v),)
    if path == "df64":
        return ir, lambda: port_interp.compile_df64_fused_ir(ir), \
            lambda fn, v: fn((port_interp.init_real64(n, cpu), None), v)
    return ir, lambda: port_interp.compile_pair32_ir(ir), \
        lambda fn, v: fn((None, None), v, device=cpu)


@pytest.mark.parametrize("path", ["pair_real", "pair_complex", "flat_u4",
                                  "df64"])
def test_a_cached_plan_runs_without_planning(monkeypatch, path):
    """A second run of a cached plan, at new angles, classifies no gate
    and plans no kernel pass (the kernel blocks hold their structure), and
    returns what a fresh plan returns at those angles."""
    n = 15
    ir, compile_, run = _cached_plan_case(path, n)
    rng = np.random.default_rng(3)
    first, second = rng.uniform(0, 2 * np.pi, (2, n))
    port_interp.clear_cache()
    run(compile_(), first)

    def refuse(*args, **kwargs):
        raise AssertionError("a cached plan was planned again")

    blocks = []
    run_block = port_interp._run_block
    with monkeypatch.context() as m:
        for name in ("_classify_spec", "kernel_plan"):
            m.setattr(port_interp, name, refuse)
        m.setattr(port_relabel, "plan_full_layer", refuse)
        m.setattr(port_interp, "_run_block",
                  lambda *a, **k: blocks.append(1) or run_block(*a, **k))
        got = run(compile_(), second)
    assert blocks
    port_interp.clear_cache()
    want = run(compile_(), second)
    planes = [(g, w) for g, w in zip(got, want) if w is not None]
    assert planes and all(torch.equal(g, w) for g, w in planes)
    assert all(g is None for g, w in zip(got, want) if w is None)
