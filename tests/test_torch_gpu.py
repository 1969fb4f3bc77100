"""The CUDA kernels on the card against their plain-torch versions: the
fused-layer kernels (f32 and df64), the index-bit rotation copy, the
two tensor-core region dots, the Pauli readout and the adjoint step; and
the paths that launch them: Circuit,
compile_program, the adjoint gradient, the flat-state engine
(execute/compile_ir) with its front ends, and the sharded Circuit on
virtual shards of one card (and over every card, where there are two or
more). Also the tensor-network
executor on the card: float32-grade GEMMs under a global TF32 setting,
the memory a sliced contraction takes from the allocator, and the native
pathfinder.

Marked ``gpu``: these tests need a CUDA device and skip without one. This
file imports no jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import contextlib

import numpy as np
import pytest
import torch

import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch.models import (hardware_efficient_ansatz_ir, qft_ir,
                                         random_circuit_ir)
from rocquantum_tpu_torch.ops import (adjoint_step, df64, fused_df64,
                                      fused_sv, gates, region_dot, relabel,
                                      rotate)
from rocquantum_tpu_torch.tensornet import (Tensor, TensorNetwork,
                                            _native_pathfinder, tensor_svd)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _random_pass(rng, n, pair_bits, real, count=40):
    """Random specs of every kind for one pass, with their 2x2 matrices as
    complex128."""
    w = fused_sv.window_bits(n)
    local = list(range(w)) + list(pair_bits)
    specs, mats = [], []
    for i in range(count):
        kind = ("U", "CNOT", "CU", "D2")[i % 4]
        t = int(rng.choice(local))
        if kind == "U":
            specs.append(("U", t))
        elif kind == "D2":
            specs.append(("D2", int(rng.integers(n)), int(rng.integers(n))))
        else:
            specs.append((kind, int(rng.choice([q for q in range(n)
                                                if q != t])), t))
        # unitary gates keep amplitudes O(2^-n/2), as on the main path
        if kind == "D2":
            m = rng.choice([-1.0, 1.0], (2, 2)) if real else \
                np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
        elif real:
            th = rng.normal()
            m = np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
        else:
            m, _ = np.linalg.qr(rng.normal(size=(2, 2))
                                + 1j * rng.normal(size=(2, 2)))
        mats.append(np.asarray(m, np.complex128))
    return specs, mats, [real] * count


def _pack_f32(mats):
    return np.stack([np.stack([m.real, m.imag], -1) for m in mats]).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["real", "complex", "zero"])
@pytest.mark.parametrize("pair_bits", [(), (12,), (10, 14, 17)])
def test_kernel_matches_reference(cuda, mode, pair_bits):
    n = 18
    rng = np.random.default_rng(len(pair_bits) * 3 + len(mode))
    specs, mats, flags = _random_pass(rng, n, pair_bits, mode != "complex")
    gm = _pack_f32(mats)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    re = im = None
    if mode != "zero":
        re = torch.randn(1 << n, generator=gen, device=cuda) * 2 ** (-n / 2)
    if mode == "complex":
        im = torch.randn(1 << n, generator=gen, device=cuda) * 2 ** (-n / 2)
    want = fused_sv.apply_fused_layer_reference(
        re, im, specs, gm, real_flags=flags, num_qubits=n, device=cuda)
    before = fused_sv.LAUNCHES
    got = fused_sv.apply_fused_layer(
        None if re is None else re.clone(), None if im is None else im.clone(),
        specs, gm, pair_bits=pair_bits, real_flags=flags, num_qubits=n,
        device=cuda)
    torch.cuda.synchronize()
    assert fused_sv.LAUNCHES == before + 1
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    if im is not None:
        torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)


# (n, pair bits, mode): the smallest kernel states, one tile (n = 15, 16)
# and more, chip_smoke's n = 22 pair sets, and five pair bits (2^15
# amplitudes a tile) on the real plane, the only carry that takes them
PATH_PASSES = [(n, pairs, mode)
               for n, pairs in [(15, ()), (15, (11, 14)), (16, (15,)),
                                (16, (10, 13, 15)), (22, ()), (22, (15,)),
                                (22, (11, 17, 21)),
                                (15, (10, 11, 12, 13, 14)),
                                (16, (10, 11, 13, 14, 15)),
                                (22, (11, 13, 17, 19, 21))]
               for mode in ("real", "complex", "zero")
               if len(pairs) <= fused_sv.MAX_PAIRS_COMPLEX
               or mode != "complex"]


@pytest.mark.parametrize("n,pair_bits,mode", PATH_PASSES)
def test_kernel_matches_reference_at_path_sizes(cuda, n, pair_bits, mode):
    """48 random gates of every kind (targets anywhere in the local set,
    controls and diagonal bits anywhere) per pass, as chip_smoke runs
    them."""
    rng = np.random.default_rng(n * 11 + len(pair_bits) * 3 + len(mode))
    specs, mats, flags = _random_pass(rng, n, pair_bits, mode != "complex",
                                      count=48)
    gm = _pack_f32(mats)
    v = rng.normal(size=(2, 1 << n))
    v /= np.linalg.norm(v)
    re = im = None
    if mode != "zero":
        re = torch.from_numpy(v[0].astype(np.float32)).to(cuda)
    if mode == "complex":
        im = torch.from_numpy(v[1].astype(np.float32)).to(cuda)
    want = fused_sv.apply_fused_layer_reference(
        re, im, specs, gm, real_flags=flags, num_qubits=n, device=cuda)
    launches = len(fused_sv.pass_schedule(
        n, fused_sv._normalize_specs(specs), mode == "complex"))
    before = (fused_sv.LAUNCHES, fused_sv.INIT_LAUNCHES)
    got = fused_sv.apply_fused_layer(
        None if re is None else re.clone(), None if im is None else im.clone(),
        specs, gm, pair_bits=pair_bits, real_flags=flags, num_qubits=n,
        device=cuda)
    torch.cuda.synchronize()
    assert (fused_sv.LAUNCHES, fused_sv.INIT_LAUNCHES) == (
        before[0] + launches, before[1] + (mode == "zero"))
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    if im is not None:
        torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 15, 29])
def test_init_zero_matches_plain_bitwise(cuda, n):
    before = fused_sv.ZERO_LAUNCHES
    got = fused_sv.init_zero(n, cuda)
    torch.cuda.synchronize()
    assert fused_sv.ZERO_LAUNCHES == before + 1
    assert torch.equal(got, fused_sv._zero_plane(n, cuda))


def test_wrapper_rejects_noncontiguous_plane(cuda):
    re = torch.zeros(1 << 16, device=cuda)[::2]
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(re, None, [("U", 0)],
                                   np.zeros((1, 2, 2, 2), np.float32),
                                   real_flags=[True])
    unaligned = torch.zeros((1 << 16) + 1, device=cuda)[1:]
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(unaligned, None, [("U", 0)],
                                   np.zeros((1, 2, 2, 2), np.float32),
                                   real_flags=[True])


def test_wrapper_rejects_more_pair_bits_than_the_geometry(cuda):
    re = torch.zeros(1 << 18, device=cuda)
    pairs = tuple(range(10, 11 + fused_sv.MAX_PAIRS))
    before = fused_sv.LAUNCHES
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(re, None, [("U", 10)],
                                   np.zeros((1, 2, 2, 2), np.float32),
                                   pair_bits=pairs, real_flags=[True])
    assert fused_sv.LAUNCHES == before


@pytest.mark.parametrize("mode", ["real", "complex"])
@pytest.mark.parametrize("pair_bits", [(), (12,), (10, 14, 17)])
def test_df64_kernel_matches_reference(cuda, mode, pair_bits):
    """The df64 kernel against its plain version on the same card, on the
    promoted float64 values of a normalized state (amplitudes ~2^-9)."""
    n = 18
    rng = np.random.default_rng(len(pair_bits) * 5 + len(mode))
    specs, mats, flags = _random_pass(rng, n, pair_bits, mode == "real")
    gm = fused_df64.pack_gate_mats_df64(mats)
    v = rng.normal(size=(2, 1 << n))
    v /= np.linalg.norm(v)
    re = torch.from_numpy(v[0]).to(cuda)
    im = None if mode == "real" else torch.from_numpy(v[1]).to(cuda)
    planes = df64.state_from_pair_f64(re, im)
    want = fused_df64.apply_fused_layer_df64_reference(
        *planes, specs, gm, real_flags=flags)
    launches = len(fused_df64.pass_schedule(
        n, fused_df64._normalize_specs(specs), mode == "complex"))
    before = fused_df64.LAUNCHES
    got = fused_df64.apply_fused_layer_df64(
        *(None if p is None else p.clone() for p in planes), specs, gm,
        pair_bits=pair_bits, real_flags=flags)
    torch.cuda.synchronize()
    assert fused_df64.LAUNCHES == before + launches > before
    for a, b in zip(df64.state_to_pair_f64(got),
                    df64.state_to_pair_f64(want)):
        if b is not None:
            torch.testing.assert_close(a, b, atol=1e-13, rtol=0)


# (n, pair bits, mode) for the df64 kernel: the smallest kernel states, a
# handful of tiles (n = 15, 16) and more, and chip_smoke's n = 22 pair sets
DF64_PATH_PASSES = [(n, pairs, mode)
                    for n, pairs in [(15, ()), (15, (11, 14)), (16, (15,)),
                                     (16, (10, 13, 15)), (22, ()),
                                     (22, (15,)), (22, (11, 17, 21))]
                    for mode in ("real", "complex")]


@pytest.mark.parametrize("n,pair_bits,mode", DF64_PATH_PASSES)
def test_df64_kernel_matches_reference_at_path_sizes(cuda, n, pair_bits,
                                                     mode):
    """48 random gates of every kind per pass on either carry, within 1e-13
    of the plain version after promotion; every launch counted."""
    rng = np.random.default_rng(n * 13 + len(pair_bits) * 3 + len(mode))
    specs, mats, flags = _random_pass(rng, n, pair_bits, mode == "real",
                                      count=48)
    gm = fused_df64.pack_gate_mats_df64(mats)
    v = rng.normal(size=(2, 1 << n))
    v /= np.linalg.norm(v)
    planes = df64.state_from_pair_f64(
        torch.from_numpy(v[0]).to(cuda),
        None if mode == "real" else torch.from_numpy(v[1]).to(cuda))
    want = fused_df64.apply_fused_layer_df64_reference(
        *planes, specs, gm, real_flags=flags)
    launches = len(fused_df64.pass_schedule(
        n, fused_df64._normalize_specs(specs), mode == "complex"))
    before = fused_df64.LAUNCHES
    got = fused_df64.apply_fused_layer_df64(
        *(None if p is None else p.clone() for p in planes), specs, gm,
        pair_bits=pair_bits, real_flags=flags)
    torch.cuda.synchronize()
    assert fused_df64.LAUNCHES == before + launches > before
    for a, b in zip(df64.state_to_pair_f64(got),
                    df64.state_to_pair_f64(want)):
        if b is not None:
            torch.testing.assert_close(a, b, atol=1e-13, rtol=0)


def test_df64_wrapper_rejects_noncontiguous_plane(cuda):
    rh = torch.zeros(1 << 16, device=cuda)[::2]
    with pytest.raises(ValueError):
        fused_df64.apply_fused_layer_df64(
            rh, torch.zeros_like(rh), None, None, [("U", 0)],
            np.zeros((1, 2, 2, 4), np.float32), real_flags=[True])


@pytest.mark.parametrize("pairs,extra,im", [
    ((10, 11, 12, 13), (0,), False),          # four pair bits, real carry
    ((10, 11, 12, 13), (0,), True),           # four, complex carry
    ((10, 11, 12), (13,), False),             # a target off the local set
])
def test_df64_wrapper_rejects_more_pair_bits_than_the_geometry(cuda, pairs,
                                                               extra, im):
    n = 18
    rh = torch.zeros(1 << n, device=cuda)
    ih = torch.zeros_like(rh) if im else None
    specs = [("U", q) for q in pairs + extra]
    before = fused_df64.LAUNCHES
    with pytest.raises(ValueError):
        fused_df64.apply_fused_layer_df64(
            rh, torch.zeros_like(rh), ih, None if ih is None else ih.clone(),
            specs, np.zeros((len(specs), 2, 2, 4), np.float32),
            pair_bits=pairs, real_flags=[True] * len(specs))
    assert fused_df64.LAUNCHES == before


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [8, 12, 19])
def test_rotation_kernel_matches_reference(cuda, n, batch):
    """Every shift of the region [7, n), bitwise (the kernel is a copy)."""
    x = torch.randn(batch, 1 << n, device=cuda)
    for shift in range(n - rotate.ROT_LO + 1):
        want = rotate.rotate_bits_down(x, n, shift)
        before = rotate.LAUNCHES
        got = rotate.rotate_region(x, n, shift)
        torch.cuda.synchronize()
        moved = shift % (n - rotate.ROT_LO) != 0
        assert rotate.LAUNCHES == before + moved
        assert torch.equal(got, want), (n, batch, shift)


def test_rotation_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    with pytest.raises(ValueError):
        rotate.rotate_region(torch.zeros(1 << 13, device=cuda)[1:], 12, 1)
    with pytest.raises(ValueError):
        rotate.rotate_region(torch.zeros(1 << 12, dtype=torch.float64,
                                         device=cuda), 12, 1)


def test_execute_plan_with_rotations_on_the_card_matches_cpu(cuda):
    """A hand-made plan of passes and Rotations from |0...0> (init on the
    card, rotations through the kernel) lands on the CPU run's state."""
    n = 17
    kinds = ["U"] * 6 + ["CNOT"]
    rng = np.random.default_rng(4)
    gm = _pack_f32([np.array([[np.cos(t), -np.sin(t)], [np.sin(t),
                                                       np.cos(t)]])
                    for t in rng.normal(size=len(kinds))])
    plan = [relabel.KernelPass((0, 1, 2), ((0,), (8,), (9,)), (16,)),
            relabel.Rotation(2),
            relabel.KernelPass((3, 4, 5, 6), ((7,), (9,), (3,), (9, 8))),
            relabel.Rotation(8)]
    flags = [True] * len(kinds)
    before = (rotate.LAUNCHES, fused_sv.INIT_LAUNCHES)
    got, _ = relabel.execute_plan(None, None, plan, gm, n, kinds, flags,
                                  device=cuda)
    torch.cuda.synchronize()
    assert (rotate.LAUNCHES, fused_sv.INIT_LAUNCHES) == (before[0] + 2,
                                                         before[1] + 1)
    want, _ = relabel.execute_plan(None, None, plan, gm, n, kinds, flags,
                                   device="cpu")
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


def test_rotation_first_plan_starts_from_the_fill(cuda):
    """A plan that starts with a Rotation from re=None writes |0...0> with
    the fill kernel first."""
    n = 17
    gm = _pack_f32([np.array([[0.6, -0.8], [0.8, 0.6]])])
    plan = [relabel.Rotation(3), relabel.KernelPass((0,), ((9,),)),
            relabel.Rotation(n - rotate.ROT_LO - 3)]
    before = (fused_sv.ZERO_LAUNCHES, fused_sv.INIT_LAUNCHES)
    got, _ = relabel.execute_plan(None, None, plan, gm, n, ["U"], [True],
                                  device=cuda)
    torch.cuda.synchronize()
    assert (fused_sv.ZERO_LAUNCHES, fused_sv.INIT_LAUNCHES) == (
        before[0] + 1, before[1])
    want, _ = relabel.execute_plan(None, None, plan, gm, n, ["U"], [True],
                                   device="cpu")
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("rows", [32, 128, 4096])
def test_region_dots_match_float64(cuda, rows):
    """Both 3xTF32 tensor-core dots against float64 products on the card:
    within 1e-5 of the largest output (float32-grade)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(rows)
    x = torch.randn(rows, region_dot.COLS, generator=gen, device=cuda)
    m = torch.randn(region_dot.LANE, region_dot.LANE, generator=gen,
                    device=cuda)
    a = torch.randn(region_dot.TILE, region_dot.TILE, generator=gen,
                    device=cuda)
    for fn, want, count in (
            (lambda y: region_dot.lane_dot(y, m),
             region_dot.lane_dot_reference(x.double(), m.double()),
             "LANE_LAUNCHES"),
            (lambda y: region_dot.row_dot(a, y),
             region_dot.row_dot_reference(a.double(), x.double()),
             "ROW_LAUNCHES")):
        before = getattr(region_dot, count)
        y = x.clone()
        got = fn(y)
        torch.cuda.synchronize()
        assert got is y and getattr(region_dot, count) == before + 1
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (count, err)


def _lane_case(cuda, rows, seed, scale=1.0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    x = torch.randn(rows, region_dot.COLS, generator=gen, device=cuda) * scale
    m = torch.randn(region_dot.LANE, region_dot.LANE, generator=gen,
                    device=cuda)
    return x, m, region_dot.lane_dot_reference(x.double(), m.double())


@pytest.mark.parametrize("scale", [2.0 ** -20, 2.0 ** 20])
def test_lane_dot_keeps_float32_accuracy_at_any_scale(cuda, scale):
    """The 3xTF32 split is relative: inputs scaled by 2^-20 or 2^20 stay
    within 1e-6 of max|y| of the float64 product."""
    x, m, want = _lane_case(cuda, 4096, 11, scale)
    got = region_dot.lane_dot(x, m)
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err


def test_lane_dot_runs_on_the_current_stream(cuda):
    """A launch on a non-default stream runs there, in order with the
    stream's other work, and counts one launch."""
    x, m, want = _lane_case(cuda, 2048, 12)
    y = torch.empty_like(x)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    before = region_dot.LANE_LAUNCHES
    with torch.cuda.stream(stream):
        y.copy_(x)
        region_dot.lane_dot(y, m)
        y.mul_(2.0)
    stream.synchronize()
    assert region_dot.LANE_LAUNCHES == before + 1
    err = float((y.double() / 2 - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_lane_dot_applies_a_composed_ry_layer_as_the_fused_kernel(cuda):
    """Seven RY gates on qubits 0-6 as one 128x128 lane dot on the card,
    against the fused-layer kernel on the same gates: within 1e-5 of
    max|y|."""
    n = 22
    thetas = np.random.default_rng(13).normal(size=7)
    rot = [np.array([[np.cos(t / 2), -np.sin(t / 2)],
                     [np.sin(t / 2), np.cos(t / 2)]]) for t in thetas]
    composed = np.eye(1)
    for r in rot:  # the later (higher) qubit is the more significant
        composed = np.kron(r, composed)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    state = torch.randn(1 << n, generator=gen, device=cuda)
    state /= torch.linalg.vector_norm(state)
    specs = [("U", q) for q in range(7)]
    want, _ = fused_sv.apply_fused_layer(
        state.clone(), None, specs, _pack_f32([r.astype(complex) for r in rot]),
        real_flags=[True] * 7)
    got = region_dot.lane_dot(
        state.clone().view(-1, region_dot.COLS),
        torch.tensor(np.ascontiguousarray(composed.T), dtype=torch.float32,
                     device=cuda))
    torch.cuda.synchronize()
    top = float(want.abs().max())
    assert float((got.reshape(-1) - want).abs().max()) <= 1e-5 * top


@contextlib.contextmanager
def _plain_layers():
    kernel_fn = fused_sv.apply_fused_layer
    fused_sv.apply_fused_layer = fused_sv.apply_fused_layer_reference
    try:
        yield
    finally:
        fused_sv.apply_fused_layer = kernel_fn


def _run(ir, device, theta=None):
    c = rq.Circuit(ir.num_qubits, rq.Simulator(seed=3, device=device))
    for op in ir.ops:
        params = [float(theta[p.index]) for p in op.params] \
            if theta is not None else op.params
        c._enqueue(op.name, op.targets, op.controls, params)
    return c.get_statevector()


@pytest.mark.parametrize("name", ["ansatz", "qft"])
def test_circuit_kernel_path_matches_plain_path(cuda, name):
    n = 20
    if name == "ansatz":
        ir = hardware_efficient_ansatz_ir(n, 3)
        theta = np.random.default_rng(0).normal(size=ir.num_params)
    else:
        ir, theta = qft_ir(n), None
    before = fused_sv.LAUNCHES
    got = _run(ir, cuda, theta)
    assert fused_sv.LAUNCHES > before
    with _plain_layers():
        want = _run(ir, cuda, theta)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _flat_circuits(n):
    """(name, IR, params) of the flat path's circuits at n qubits."""
    ansatz = hardware_efficient_ansatz_ir(n, 3)
    theta = np.random.default_rng(n).normal(size=ansatz.num_params)
    return [("ansatz", ansatz, theta),
            ("random", random_circuit_ir(n, 6, n), None),
            ("qft", qft_ir(n), None)]


@pytest.mark.parametrize("n", [16, 18, 20])
def test_flat_execute_matches_the_plain_plan(cuda, n):
    """execute / compile_ir on a complex64 state on the card: the kernel
    passes against the same plan with the plain layer function, launches
    counted; a complex128 state never reaches the kernel."""
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.ops import statevec

    for name, ir, theta in _flat_circuits(n):
        start = statevec.basis_state(n, 5, device=cuda)
        before = fused_sv.LAUNCHES
        got = interpreter.compile_ir(ir)(start, theta)
        torch.cuda.synchronize()
        assert fused_sv.LAUNCHES > before, name
        with _plain_layers():
            mid = fused_sv.LAUNCHES
            want = interpreter.compile_ir(ir)(start, theta)
            assert fused_sv.LAUNCHES == mid
        assert got.dtype == torch.complex64 and got.device == start.device
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * top, name
        assert torch.equal(start, statevec.basis_state(n, 5, device=cuda))
        exact = interpreter.execute(start.to(torch.complex128), ir.ops, theta)
        assert fused_sv.LAUNCHES == mid
        assert float((got - exact).abs().max()) <= 1e-5 * top, name


def test_flat_front_ends_on_the_card(cuda):
    """QuantumSimulator, the local backend and a dsl kernel at n = 16 run on
    the card and launch the fused kernel."""
    from rocquantum_tpu_torch import core, dsl
    from rocquantum_tpu_torch.compiler.qasm import to_qasm3
    from rocquantum_tpu_torch.simulator import QuantumSimulator

    n = 16
    before = fused_sv.LAUNCHES
    sim = QuantumSimulator(n)
    for q in range(n):
        sim.apply_gate("RY", [q], [0.1 * (q + 1)])
    for q in range(n):
        sim.apply_gate("CNOT", [q, (q + 1) % n])
    probs = sim.get_probabilities([0, 5])
    assert sim.device.type == "cuda" and abs(probs.sum() - 1.0) < 1e-5
    core.set_target("local")
    backend = core.get_active_backend()
    from rocquantum_tpu_torch.models import ghz_ir
    hist = backend.get_job_result(backend.submit_job(to_qasm3(ghz_ir(n)),
                                                     1000))
    assert set(hist) <= {"0" * n, "1" * n}

    @dsl.kernel
    def ring(theta):
        q = dsl.qvec(n)
        for i in range(n):
            dsl.ry(theta, q[i])
        for i in range(n):
            dsl.cnot(q[i], q[(i + 1) % n])

    zz = dsl.get_expectation_value(ring, dsl.PauliOperator("Z0 Z1"),
                                   "state_vector", theta=0.2)
    assert np.isfinite(zz)
    assert fused_sv.LAUNCHES > before


def test_readout_on_the_card_matches_cpu(cuda):
    """Measurement, probabilities, expectations and samples of the same
    circuit on the card and on the CPU (same seed: same host draws)."""
    n = 16
    ir = hardware_efficient_ansatz_ir(n, 2)
    theta = np.random.default_rng(5).normal(size=ir.num_params)
    circuits = {}
    for dev in (cuda, torch.device("cpu")):
        c = rq.Circuit(n, rq.Simulator(seed=9, device=dev))
        for op in ir.ops:
            c._enqueue(op.name, op.targets, op.controls,
                       [float(theta[p.index]) for p in op.params])
        circuits[dev.type] = c
    gpu, cpu = circuits["cuda"], circuits["cpu"]
    op = rq.PauliOperator({"Z0 Z5": -1.0, "X3": 0.5, "Y2 Y7": 0.25})
    assert abs(gpu.expval(op) - cpu.expval(op)) < 1e-6
    np.testing.assert_allclose(gpu.get_probabilities([4, 1, 9]),
                               cpu.get_probabilities([4, 1, 9]), atol=1e-6)
    for q in (2, 11):
        (og, pg), (oc, pc) = gpu.measure(q), cpu.measure(q)
        assert og == oc and abs(pg - pc) < 1e-6
    assert gpu.state[1] is None
    np.testing.assert_allclose(gpu.get_statevector(), cpu.get_statevector(),
                               atol=1e-6)
    shots = gpu.sample([0, 1, 2], 20000)
    probs = cpu.get_probabilities([0, 1, 2])
    hist = np.bincount(shots, minlength=8) / len(shots)
    assert 0.5 * np.abs(hist - probs).sum() <= 0.03


@pytest.fixture
def df64_mode():
    old = "df64" if rq.df64_enabled() else rq.get_precision()
    rq.set_precision("df64")
    yield
    rq.set_precision(old)


@pytest.mark.parametrize("name", ["ansatz", "qft"])
def test_df64_circuit_on_the_card_matches_cpu(cuda, df64_mode, name,
                                              monkeypatch):
    """set_precision("df64"): the flush on the card launches the df64
    kernel, never its plain version, and lands on the CPU run's state
    (plain df64 version)."""
    n = 17
    if name == "ansatz":
        ir = hardware_efficient_ansatz_ir(n, 3)
        theta = np.random.default_rng(2).normal(size=ir.num_params)
    else:
        ir, theta = qft_ir(n), None
    plain = fused_df64.apply_fused_layer_df64_reference

    def refuse(*args, **kwargs):
        raise AssertionError("the plain df64 layer ran on the card")

    monkeypatch.setattr(fused_df64, "apply_fused_layer_df64_reference",
                        refuse)
    before = fused_df64.LAUNCHES
    got = _run(ir, cuda, theta)
    assert fused_df64.LAUNCHES > before
    monkeypatch.setattr(fused_df64, "apply_fused_layer_df64_reference",
                        plain)
    want = _run(ir, torch.device("cpu"), theta)
    np.testing.assert_allclose(got, want, atol=1e-13)


def _ring_kernel(q, *theta):
    n = q.num_qubits
    for layer in range(len(theta) // n):
        for qq in range(n):
            q.ry(theta[layer * n + qq], qq)
        for qq in range(n):
            q.cx(qq, (qq + 1) % n)


def _tfim(n):
    terms = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    terms.update({f"X{q}": -0.5 for q in range(n)})
    return rq.PauliOperator(terms)


def _value_and_grad(n, theta, device):
    energy = rq.make_energy_fn(rq.kernel(_ring_kernel), n, _tfim(n),
                               len(theta), device=device)
    p = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    value = energy(p)
    (g,) = torch.autograd.grad(value, p)
    return float(value.detach()), g.numpy()


def test_reversible_gradient_on_the_card_matches_plain_layers(cuda):
    """The sweep's forward and its parameter-free steps launch the fused
    kernel, each angle's step the adjoint step kernel; the same sweep with
    the plain layer function and the plain adjoint step agrees."""
    n = 20
    theta = np.random.default_rng(20).normal(size=3 * n)
    before = (fused_sv.LAUNCHES, adjoint_step.LAUNCHES)
    value, grads = _value_and_grad(n, theta, cuda)
    launches = fused_sv.LAUNCHES - before[0]
    # the forward's passes, then two passes per CNOT ring at least
    assert launches >= 2 * 3
    assert adjoint_step.LAUNCHES - before[1] == len(theta)
    kernel_step = adjoint_step.apply
    adjoint_step.apply = \
        lambda *args: adjoint_step.apply_reference(*args[:5])
    try:
        with _plain_layers():
            want_v, want_g = _value_and_grad(n, theta, cuda)
    finally:
        adjoint_step.apply = kernel_step
    assert fused_sv.LAUNCHES - before[0] == launches
    assert adjoint_step.LAUNCHES - before[1] == len(theta)
    assert abs(value - want_v) <= 1e-5 * abs(want_v)
    np.testing.assert_allclose(grads, want_g, atol=1e-4)


def test_compile_program_replay_on_the_card_matches_circuit(cuda):
    n = 20
    ir = hardware_efficient_ansatz_ir(n, 2)
    theta = np.random.default_rng(4).normal(size=ir.num_params)
    bound = rq.trace_kernel(rq.kernel(_ring_kernel), n, *theta)
    obs = _tfim(n)
    prog = rq.compile_program(bound, rq.Simulator(device=cuda),
                              observable=obs)
    before = fused_sv.LAUNCHES
    first, again = prog.run(), prog.run()
    assert fused_sv.LAUNCHES > before
    c = rq.Circuit(n, rq.Simulator(device=cuda))
    for op in bound.ops:
        c._enqueue(op.name, op.targets, op.controls, op.params)
    want = c.expval(obs)
    assert abs(first - again) <= 1e-9 * abs(first)
    assert abs(first - want) <= 1e-6 * abs(want)


def test_adjoint_grad_on_a_cuda_simulator_launches_the_fused_kernel(cuda):
    n = 16
    theta = np.random.default_rng(6).normal(size=n)
    before = (fused_sv.LAUNCHES, fused_df64.LAUNCHES, adjoint_step.LAUNCHES)
    value, grads = rq.adjoint_grad(rq.kernel(_ring_kernel), n,
                                   rq.Simulator(device=cuda), theta,
                                   _tfim(n), return_value=True)
    assert fused_sv.LAUNCHES - before[0] >= 2
    assert fused_df64.LAUNCHES == before[1]
    assert adjoint_step.LAUNCHES - before[2] == n
    cpu_v, cpu_g = rq.adjoint_grad(rq.kernel(_ring_kernel), n,
                                   rq.Simulator(device="cpu"), theta,
                                   _tfim(n), return_value=True)
    assert abs(value - cpu_v) <= 1e-5 * abs(cpu_v)
    np.testing.assert_allclose(grads, cpu_g, atol=1e-4)


def _density_workload(c, layers=1):
    """The complex-carry density workload of chip_smoke.py phase 12: H and
    RZ on every qubit, a CNOT ring, a CRZ, amplitude damping and phase
    flip on every qubit; then bench.py:485's RY + depolarizing layer."""
    n = c.num_qubits
    for q in range(n):
        c.h(q)
        c.rz(0.1 + 0.05 * q, q)
    for q in range(n):
        c.cx(q, (q + 1) % n)
    c.crz(0.7, 0, n - 1)
    c.apply_channel("amplitude_damping", 0.05, list(range(n)))
    c.apply_channel("phase_flip", 0.03, list(range(n)))
    for _ in range(layers):
        for q in range(n):
            c.ry(0.3 + 0.01 * q, q)
        c.apply_channel("depolarizing", 0.02, list(range(n)))
    return c


def _density_planes(n, device):
    c = _density_workload(rq.DensityCircuit(n, rq.Simulator(seed=4,
                                                            device=device)))
    re, im = c.state
    return re.clone(), None if im is None else im.clone()


@pytest.mark.parametrize("n", [10, 14])
def test_density_f32_kernel_path_matches_plain_layers(cuda, n):
    before = fused_sv.LAUNCHES
    got = _density_planes(n, cuda)
    assert fused_sv.LAUNCHES > before and got[1] is not None
    with _plain_layers():
        mid = fused_sv.LAUNCHES
        want = _density_planes(n, cuda)
        assert fused_sv.LAUNCHES == mid
    top = float(want[0].abs().max())
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * top
    dim = 1 << n
    re, im = got
    assert float((re.view(dim, dim) - re.view(dim, dim).T).abs().max()) \
        <= 1e-6 * top
    assert float((im.view(dim, dim) + im.view(dim, dim).T).abs().max()) \
        <= 1e-6 * top


def test_density_df64_kernel_path_matches_plain_layers(cuda, df64_mode,
                                                       monkeypatch):
    n = 10
    before = fused_df64.LAUNCHES
    got = _density_planes(n, cuda)
    assert fused_df64.LAUNCHES > before and got[0].dtype == torch.float64
    monkeypatch.setattr(fused_df64, "apply_fused_layer_df64",
                        fused_df64.apply_fused_layer_df64_reference)
    want = _density_planes(n, cuda)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-13


def test_density_circuit_on_a_cuda_simulator_launches_the_fused_kernel(
        cuda):
    """A DensityCircuit on a CUDA simulator starts from the fill kernel,
    launches rocq_fused_pass, keeps the bench workload real and lands on
    the CPU run's rho, measurement included (same seed, same draws)."""
    n = 8
    circuits = {}
    counts = (fused_sv.LAUNCHES, fused_sv.ZERO_LAUNCHES, fused_df64.LAUNCHES)
    for dev in (cuda, torch.device("cpu")):
        c = rq.DensityCircuit(n, rq.Simulator(seed=6, device=dev))
        for q in range(n):
            c.ry(0.3 + 0.01 * q, q)
        c.apply_channel("depolarizing", 0.02, list(range(n)))
        c.flush()
        assert c.state[1] is None
        circuits[dev.type] = c
    assert fused_sv.LAUNCHES > counts[0]
    assert fused_sv.ZERO_LAUNCHES == counts[1] + 1
    assert fused_df64.LAUNCHES == counts[2]
    gpu, cpu = circuits["cuda"], circuits["cpu"]
    obs = rq.PauliOperator({"Z0": 1.0, "X3 X4": 0.5, "Y1 Y6": -0.25})
    assert abs(gpu.expval(obs) - cpu.expval(obs)) < 1e-6
    for q in (1, 5):
        (og, pg), (oc, pc) = gpu.measure(q), cpu.measure(q)
        assert og == oc and abs(pg - pc) < 1e-6
    np.testing.assert_allclose(gpu.get_density_matrix(),
                               cpu.get_density_matrix(), atol=1e-6)


def _random_complex(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.complex64,
                       device=device)


def test_tensornet_gemms_stay_float32_under_tf32(cuda):
    """torch.set_float32_matmul_precision("high") turns TF32 on for
    complex64 GEMMs; the executor turns it off around its einsums (about
    3e-6 of max|out| against complex128 at d = 2048, where TF32 gives
    ~1e-4) and leaves the caller's setting as it was."""
    d = 2048
    a, b = _random_complex((d, d), 1, cuda), _random_complex((d, d), 2, cuda)
    want = a.to(torch.complex128) @ b.to(torch.complex128)
    old = torch.backends.cuda.matmul.fp32_precision
    torch.set_float32_matmul_precision("high")
    try:
        tn = TensorNetwork(device=cuda)
        tn.add_tensor(Tensor(a, ("a", "k")))
        tn.add_tensor(Tensor(b, ("k", "b")))
        got = tn.contract().data
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = old
    err = float((got.to(torch.complex128) - want).abs().max()
                / want.abs().max())
    assert err <= 3e-5, err


def test_sliced_contraction_memory_from_the_allocator(cuda):
    """A 2^24-element output (128 MiB) under a limit of 1/64 of it: the
    allocator's peak rises over the inputs by at most the output plus 4
    slabs, and the executor's tally is within one slab of it."""
    dim, k = 1 << 12, 16
    a = _random_complex((dim, k), 3, cuda)
    b = _random_complex((k, dim), 4, cuda)
    tn = TensorNetwork(device=cuda)
    tn.add_tensor(Tensor(a, ("a", "k")))
    tn.add_tensor(Tensor(b, ("k", "b")))
    want = tn.contract()  # also allocates cuBLAS's workspace
    out_bytes = dim * dim * 8
    slab = out_bytes // 64
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = tn.compiled_memory_stats({"memory_limit": slab})
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert tn.last_num_slices >= 64
    assert rise <= out_bytes + 4 * slab, (rise, out_bytes)
    assert abs(stats.temp_size_in_bytes - rise) <= slab, (
        stats.temp_size_in_bytes, rise)
    got = tn.contract({"memory_limit": slab}).data
    assert float((got - want.data).abs().max()) <= \
        1e-6 * float(want.data.abs().max())


def test_pathfinder_is_native_on_the_card(cuda):
    assert _native_pathfinder.pathfinder_name() == "native"


def test_tensor_svd_on_the_card_is_float32_grade(cuda):
    """A 1024^2 complex64 SVD on the card reconstructs its tensor and
    matches complex128 singular values to float32 grade."""
    t = Tensor(_random_complex((32, 32, 32, 32), 5, cuda), tuple("abcd"))
    u, s, v = tensor_svd(t, ["a", "c"])
    recon = torch.einsum("acs,s,sbd->abcd", u.data, s.data.to(u.data.dtype),
                         v.data)
    scale = float(t.data.abs().max())
    assert float((recon - t.data).abs().max()) <= 1e-4 * scale
    m = t.data.permute(0, 2, 1, 3).reshape(1024, 1024).to(torch.complex128)
    exact = torch.linalg.svdvals(m, driver="gesvd")
    assert float((s.data.double() - exact).abs().max()) <= \
        1e-4 * float(exact.max())


# ---- batched passes and the batched/dynamic circuit paths -----------------

@pytest.mark.parametrize("mode", ["real", "complex"])
@pytest.mark.parametrize("n", [15, 20])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_batched_kernel_matches_reference(cuda, b, n, mode):
    """One pass over (b, 2^n) planes, b distinct random states: the
    scheduled launches once for the whole batch (not b times), each
    element within 1e-5 of max|amp| of the batched plain version."""
    pair_bits = {15: (11, 14), 20: (11, 17, 19)}[n]
    rng = np.random.default_rng(b * 100 + n + len(mode))
    specs, mats, flags = _random_pass(rng, n, pair_bits, mode == "real",
                                      count=48)
    gm = _pack_f32(mats)
    v = rng.normal(size=(2, b, 1 << n))
    v /= np.linalg.norm(v, axis=(0, 2), keepdims=True)
    re = torch.from_numpy(v[0].astype(np.float32)).to(cuda)
    im = None if mode == "real" else \
        torch.from_numpy(v[1].astype(np.float32)).to(cuda)
    want = fused_sv.apply_fused_layer_reference(re, im, specs, gm,
                                                real_flags=flags)
    launches = len(fused_sv.pass_schedule(
        n, fused_sv._normalize_specs(specs), im is not None))
    before = (fused_sv.LAUNCHES, fused_sv.BATCHED_LAUNCHES)
    got = fused_sv.apply_fused_layer(
        re.clone(), None if im is None else im.clone(), specs, gm,
        pair_bits=pair_bits, real_flags=flags)
    torch.cuda.synchronize()
    assert fused_sv.LAUNCHES == before[0] + launches
    assert fused_sv.BATCHED_LAUNCHES == before[1] + launches * (b > 1)
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.shape == (b, 1 << n)
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * top


def test_batched_kernel_grid_of_4096_elements(cuda):
    """b = 4096 at n = 15 (a 2^27-amplitude complex pair): the grid is
    4096 * 2^(15 - t) blocks, past gridDim.y's 65535; every element lands
    on its own row."""
    n, b = 15, 4096
    rng = np.random.default_rng(4096)
    specs, mats, flags = _random_pass(rng, n, (11, 14), False, count=24)
    gm = _pack_f32(mats)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4096)
    re = torch.randn((b, 1 << n), generator=gen, device=cuda) * 2 ** (-n / 2)
    im = torch.randn((b, 1 << n), generator=gen, device=cuda) * 2 ** (-n / 2)
    want = fused_sv.apply_fused_layer_reference(re, im, specs, gm,
                                                real_flags=flags)
    got = fused_sv.apply_fused_layer(re.clone(), im.clone(), specs, gm,
                                     pair_bits=(11, 14), real_flags=flags)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        top = float(w.abs().max())
        err = (g - w).abs().amax(dim=1)
        assert float(err.max()) <= 1e-5 * top


def test_batched_wrapper_rejects_mismatched_planes(cuda):
    re = torch.zeros((3, 1 << 15), device=cuda)
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(re, torch.zeros((2, 1 << 15), device=cuda),
                                   [("U", 0)], np.zeros((1, 2, 2, 2),
                                                        np.float32))


def test_batched_circuit_on_the_card_matches_cpu(cuda):
    """Circuit(16, sim, batch_size=3) on the card: a measure (host draws,
    the same outcomes as on the CPU), a ring ansatz through the batched
    kernel, the readouts; against the same circuit on the CPU."""
    n, b = 16, 3
    rng = np.random.default_rng(16)
    theta = rng.normal(size=n)

    def run(device):
        c = rq.Circuit(n, rq.Simulator(seed=9, device=device), batch_size=b)
        c.h(0)
        outcomes, _ = c.measure(0)
        for q in range(n):
            c.ry(float(theta[q]), q)
            c.rz(0.3, q)
        for q in range(n):
            c.cx(q, (q + 1) % n)
        energy = c.expval(rq.PauliOperator({"Z0 Z1": 1.0, "X3": 0.5}))
        return c, outcomes, energy

    before = fused_sv.BATCHED_LAUNCHES
    c, outcomes, energy = run(cuda)
    torch.cuda.synchronize()
    assert fused_sv.BATCHED_LAUNCHES > before
    ref, ref_outcomes, ref_energy = run("cpu")
    np.testing.assert_array_equal(outcomes, ref_outcomes)
    got, want = c.get_statevector(), ref.get_statevector()
    assert got.shape == (b, 1 << n)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(energy, ref_energy, rtol=1e-4, atol=1e-5)
    assert c.sample([0, 1], 100).shape == (b, 100)


def test_run_dynamic_on_the_card():
    """GHZ on 16 qubits with a measured-and-corrected first qubit, and
    teleportation, through the local backend on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from rocquantum_tpu_torch import core
    from rocquantum_tpu_torch.compiler.dynamic import expval_z_dynamic
    from rocquantum_tpu_torch.compiler.qasm_parser import parse_qasm3_program

    n = 16
    text = (f"OPENQASM 3.0;\nqubit[{n}] q;\nbit[1] c;\nh q[0];\n"
            + "".join(f"cx q[{q}], q[{q + 1}];\n" for q in range(n - 1))
            + "c[0] = measure q[0];\nif (c[0] == 1) {\n"
            + "".join(f"x q[{q}];\n" for q in range(1, n)) + "}\n")
    core.set_target("local")
    backend = core.get_active_backend()
    before = fused_sv.BATCHED_LAUNCHES
    hist = backend.get_job_result(backend.submit_job(text, 256))
    assert fused_sv.BATCHED_LAUNCHES > before
    assert set(hist) <= {"0" * n, "0" * (n - 1) + "1"}
    assert sum(hist.values()) == 256
    theta = np.pi / 3
    teleport = f"""
    OPENQASM 3.0;
    qubit[3] q;
    bit[2] c;
    ry({theta}) q[0];
    h q[1];
    cx q[1], q[2];
    cx q[0], q[1];
    h q[0];
    c[0] = measure q[0];
    c[1] = measure q[1];
    if (c[1] == 1) {{ x q[2]; }}
    if (c[0] == 1) {{ z q[2]; }}
    """
    ez = expval_z_dynamic(parse_qasm3_program(teleport), 2, 4096, seed=1)
    assert abs(ez - np.cos(theta)) < 0.05


def _sharded_ring(cuda, n, mesh_arg):
    """The ring with a global diagonal, a measure of a global qubit and a
    TFIM-like energy on a (sharded or unsharded) Circuit on the card."""
    theta = np.random.default_rng(17).normal(size=n)
    c = rq.Circuit(n, rq.Simulator(seed=9, device=cuda), mesh=mesh_arg)
    for q in range(n):
        c.ry(float(theta[q]), q)
    for q in range(n):
        c.cx(q, (q + 1) % n)
    c.rz(0.4, n - 1)
    c.flush()
    outcome = c.measure(n - 1)
    h = rq.PauliOperator({"Z0 Z1": 1.0, f"X{n - 1}": 0.5, "Y3 Y16": 0.25})
    return c, outcome, c.expval(h)


def _same_as_unsharded(cuda, n, got):
    c, outcome, energy = got
    ref, ref_outcome, ref_energy = _sharded_ring(cuda, n, None)
    assert outcome[0] == ref_outcome[0]
    assert abs(outcome[1] - ref_outcome[1]) < 1e-5
    psi, want = c.get_statevector(), ref.get_statevector()
    assert np.abs(psi - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(energy - ref_energy) <= 1e-4 * max(1.0, abs(ref_energy))


def test_sharded_circuit_over_every_card_matches_unsharded(cuda):
    """The same on ``default_mesh()`` (one shard a card) and on 8 shards
    over the cards, where there are two cards or more (a power of two)."""
    from rocquantum_tpu_torch.parallel import default_mesh, make_mesh
    ndev = torch.cuda.device_count()
    if ndev < 2 or ndev & (ndev - 1):
        pytest.skip("needs two CUDA devices or more (a power of two)")
    n = 18
    cards = [torch.device("cuda", i) for i in range(ndev)]
    for mesh in (default_mesh(), make_mesh(8, devices=cards * (8 // ndev))):
        _same_as_unsharded(cuda, n, _sharded_ring(cuda, n, mesh))


def test_sharded_circuit_on_the_card_matches_unsharded(cuda):
    """Circuit(17, sim, mesh=4 virtual shards of the card): n_loc = 15, so
    the flush plans kernel blocks, each pass one batched launch over the
    4 shard rows; exchanges, a measure of a global qubit and the readouts
    against the unsharded Circuit on the card."""
    from rocquantum_tpu_torch.parallel import make_mesh
    n = 17
    mesh = make_mesh(4, devices=[cuda] * 4)
    before = (fused_sv.LAUNCHES, fused_sv.BATCHED_LAUNCHES)
    got = _sharded_ring(cuda, n, mesh)
    torch.cuda.synchronize()
    launches = fused_sv.LAUNCHES - before[0]
    assert launches > 0
    assert fused_sv.BATCHED_LAUNCHES - before[1] == launches
    _same_as_unsharded(cuda, n, got)


# -- the plugins, the flat-rho API and the pair surface ------------------------

@pytest.fixture
def stubs():
    """The in-repo qiskit/cirq/pennylane API stubs, where the frameworks
    are not installed (this file runs with --noconftest on the card)."""
    import importlib.util
    import os
    import sys
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_stubs")
    if any(importlib.util.find_spec(m) is None
           for m in ("qiskit", "cirq", "pennylane")) and path not in sys.path:
        sys.path.append(path)


def _plugin_unitary(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))
    return q


def _same_amplitudes(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


def test_qiskit_backend_on_the_card_launches_the_fused_kernel(cuda, stubs):
    """n = 16 (kernel width): a ring ansatz plus a dense two-qubit
    unitary through the Qiskit backend on the card launches the fused
    kernel and agrees with the backend on the CPU; the card is the
    default device."""
    from qiskit import QuantumCircuit
    from rocquantum_tpu_torch.integrations import qiskit_provider
    n = 16
    qc = QuantumCircuit(n, n)
    for q in range(n):
        qc.ry(0.1 + 0.05 * q, q)
    for q in range(n):
        qc.cx(q, (q + 1) % n)
    qc.unitary(_plugin_unitary(3), [2, 9])
    qc.measure([0, 1], [0, 1])
    backend = qiskit_provider.RocQuantumProvider().get_backend()
    assert backend._device.type == "cuda"
    before = fused_sv.LAUNCHES
    counts = backend.run(qc, shots=256).get_counts()
    torch.cuda.synchronize()
    assert fused_sv.LAUNCHES > before
    assert sum(counts.values()) == 256 and all(len(k) == 2 for k in counts)
    cpu = qiskit_provider.RocQuantumBackend(device="cpu")
    cpu.run(qc, shots=4)
    _same_amplitudes(backend.get_statevector(), cpu.get_statevector())


def test_cirq_and_pennylane_on_the_card_match_cpu(cuda, stubs):
    import cirq
    import pennylane as qml
    from rocquantum_tpu_torch.integrations import (cirq_simulator,
                                                   pennylane_device)
    n = 16
    qs = cirq.LineQubit.range(n)
    circuit = cirq.Circuit([cirq.H(qs[0])] + [
        cirq.CNOT(a, b) for a, b in zip(qs, qs[1:])] + [
        cirq.rx(0.2 + 0.01 * k)(q) for k, q in enumerate(qs)])
    (got,) = cirq_simulator.RocQuantumSimulator().simulate_sweep(circuit)
    (want,) = cirq_simulator.RocQuantumSimulator(
        device="cpu").simulate_sweep(circuit)
    _same_amplitudes(got.state_vector(), want.state_vector())
    ops = [qml.RX(0.3 + 0.01 * w, wires=w) for w in range(n)] + [
        qml.CNOT(wires=[w, w + 1]) for w in range(n - 1)] + [
        qml.QubitUnitary(_plugin_unitary(4), wires=[0, n - 1])]
    dev = pennylane_device.RocQDevice(wires=n, shots=512)
    ref = pennylane_device.RocQDevice(wires=n, device="cpu")
    dev.apply(ops)
    ref.apply(ops)
    np.testing.assert_allclose(dev.analytic_probability([0, 1, 2]),
                               ref.analytic_probability([0, 1, 2]),
                               atol=1e-6)
    assert dev.generate_samples().shape == (512, n)


def test_flat_rho_api_on_the_card_matches_cpu(cuda):
    from rocquantum_tpu_torch.ops import density
    n = 6
    rhos = []
    for device in (cuda, "cpu"):
        rho = density.init_density(n, device=device)
        for q in range(n):
            rho = density.apply_gate_dm(rho, "RY", [q], params=(0.3 + q,))
        rho = density.apply_gate_dm(rho, "CNOT", [0, n - 1])
        rho = density.apply_channel(rho, "amplitude_damping", 0.1,
                                    list(range(n)))
        rho = density.apply_kraus(rho, [np.sqrt(0.5) * np.eye(8),
                                        np.sqrt(0.5) * np.kron(
                                            np.eye(4), [[0, 1], [1, 0]])],
                                  [1, 3, 4])
        rhos.append(rho)
    assert rhos[0].device.type == "cuda"
    _same_amplitudes(rhos[0].cpu(), rhos[1])
    for q in range(n):
        assert abs(float(density.expval_z_dm(rhos[0], q))
                   - float(density.expval_z_dm(rhos[1], q))) < 1e-5
    assert abs(float(density.purity(rhos[0]))
               - float(density.purity(rhos[1]))) < 1e-5


def test_compile_pair_ir_on_the_card(cuda):
    """A QFT of a basis state at n = 12 through the float64 pair program
    against its closed form."""
    from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp
    from rocquantum_tpu_torch.ops import pairsim
    n, x = 12, 0x5A3
    ops = [GateOp("X", (q,)) for q in range(n) if (x >> q) & 1]
    ir = CircuitIR(n, ops + list(qft_ir(n).ops))
    re, im = pairsim.compile_pair_ir(ir)(*pairsim.init_pair(
        n, torch.float64, cuda))
    k = np.arange(1 << n)
    want = np.exp(2j * np.pi * ((x * k) % (1 << n)) / (1 << n)) \
        / np.sqrt(1 << n)
    got = re.cpu().numpy() + 1j * im.cpu().numpy()
    assert np.max(np.abs(got - want)) < 1e-12


# -- the Pauli readout kernel ---------------------------------------------------

def _readout_terms(n, seed):
    """The TFIM ring and random strings of every Pauli, repeated qubits and
    an empty term among them."""
    rng = np.random.default_rng(seed)
    terms = [(("Z", q), ("Z", (q + 1) % n)) for q in range(n)]
    terms += [(("X", q),) for q in range(n)]
    for _ in range(24):
        size = int(rng.integers(1, 6))
        terms.append(tuple((str(rng.choice(list("IXYZ"))),
                            int(rng.integers(n))) for _ in range(size)))
    terms += [(), (("Y", 0), ("Y", n - 1)), (("X", 3), ("Z", 3), ("Y", 3))]
    return terms, rng.normal(size=len(terms)).tolist()


def _plain_readout(monkeypatch, fn):
    """``fn()`` with the readouts on the plain per-term torch code (on the
    card too)."""
    from rocquantum_tpu_torch.ops import pairsim
    with monkeypatch.context() as m:
        m.setattr(pairsim, "_on_card", lambda x: False)
        return fn()


def _random_planes(cuda, shape, dtype, real, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    re = torch.randn(shape, generator=g, device=cuda, dtype=torch.float64)
    im = None if real else torch.randn(shape, generator=g, device=cuda,
                                       dtype=torch.float64)
    norm = (re * re + (0 if im is None else im * im)).sum(-1, keepdim=True)
    re = (re / norm.sqrt()).to(dtype)
    return re, None if im is None else (im / norm.sqrt()).to(dtype)


READOUT_CASES = [(20, torch.float32, True, None), (22, torch.float32, False, 3),
                 (26, torch.float32, True, None), (24, torch.float32, False, None),
                 (20, torch.float64, True, 2), (22, torch.float64, False, None),
                 (26, torch.float64, True, None), (21, torch.float64, False, 3)]


@pytest.mark.parametrize("n,dtype,real,batch", READOUT_CASES)
def test_pauli_readout_kernel_matches_plain(cuda, monkeypatch, n, dtype,
                                            real, batch):
    """The kernel against the plain per-term readout on the same planes:
    within 1e-7 (float32) / 1e-13 (float64) of sum |c|, and the same bits
    on a second run."""
    from rocquantum_tpu_torch.ops import pairsim, pauli_readout
    shape = (1 << n,) if batch is None else (batch, 1 << n)
    re, im = _random_planes(cuda, shape, dtype, real, n)
    terms, coeffs = _readout_terms(n, n)
    before = pauli_readout.LAUNCHES
    got = pairsim.expval_terms_pair(re, im, terms, coeffs)
    again = pairsim.expval_terms_pair(re, im, terms, coeffs)
    assert pauli_readout.LAUNCHES - before == 2
    want = _plain_readout(monkeypatch, lambda: pairsim.expval_terms_pair(
        re, im, terms, coeffs))
    assert got.shape == want.shape and got.dtype == torch.float64
    tol = (1e-7 if dtype == torch.float32 else 1e-13) * np.abs(coeffs).sum()
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_pauli_readout_kernel_reads_strided_views(cuda, monkeypatch, dtype):
    """The ``.real`` / ``.imag`` views of a complex batch (element stride
    2), as ``Circuit.expval`` hands a complex batch, and one string
    through ``expval_pauli_string_pair``."""
    from rocquantum_tpu_torch.ops import pairsim
    n = 21
    real_dtype = torch.float32 if dtype == torch.complex64 else torch.float64
    re, im = _random_planes(cuda, (2, 1 << n), real_dtype, False, 5)
    psi = torch.complex(re, im)
    assert psi.real.stride(-1) == 2
    terms, coeffs = _readout_terms(n, 7)
    got = pairsim.expval_terms_pair(psi.real, psi.imag, terms, coeffs)
    want = _plain_readout(monkeypatch, lambda: pairsim.expval_terms_pair(
        re, im, terms, coeffs))
    tol = (1e-7 if dtype == torch.complex64 else 1e-13) * np.abs(coeffs).sum()
    assert float((got - want).abs().max()) <= tol
    # one strided plane alone: a real state read element by element
    got = pairsim.expval_terms_pair(psi.real, None, terms, coeffs)
    want = _plain_readout(monkeypatch, lambda: pairsim.expval_terms_pair(
        re, None, terms, coeffs))
    assert float((got - want).abs().max()) <= tol
    one = [("Y", 2), ("X", 19), ("Z", 4)]
    got = pairsim.expval_pauli_string_pair(psi.real, psi.imag, one)
    want = _plain_readout(monkeypatch, lambda: pairsim.expval_pauli_string_pair(
        re, im, one))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("real", [True, False])
def test_sharded_readout_on_the_card_uses_the_kernel(cuda, monkeypatch, real):
    """4 virtual shards of the card (n = 22): the terms with X and Y on
    local bits take a launch a shard with the shard's +-1 phase; X on the
    global bits keeps the fetch and dot; the sum is the plain readout's of
    the unsharded state."""
    from rocquantum_tpu_torch.ops import pairsim, pauli_readout
    from rocquantum_tpu_torch.parallel import make_mesh, sharded
    from rocquantum_tpu_torch.utils import profiling
    n = 22
    re, im = _random_planes(cuda, (1 << n,), torch.float32, real, 3)
    state = sharded.shard_state((re, im), make_mesh(4, devices=[cuda] * 4))
    terms = [(("Z", q), ("Z", (q + 1) % n)) for q in range(n)]
    terms += [(("X", q),) for q in range(n)] + [(("Y", 5), ("Z", 21))]
    coeffs = np.random.default_rng(2).normal(size=len(terms)).tolist()
    before = pauli_readout.LAUNCHES
    kernel_terms = profiling.COUNTERS["readout_kernel_terms"]
    got = sharded.expval_terms(state, terms, coeffs)
    assert pauli_readout.LAUNCHES - before == 4
    assert profiling.COUNTERS["readout_kernel_terms"] - kernel_terms == \
        len(terms) - 2
    want = _plain_readout(monkeypatch, lambda: pairsim.expval_terms_pair(
        re, im, terms, coeffs))
    assert abs(float(got) - float(want)) <= 1e-7 * np.abs(coeffs).sum()


def test_pauli_readout_refuses_what_it_cannot_take(cuda):
    """A launch the kernel refuses raises (rows beyond the grid), as do
    planes of another dtype or rank; nothing falls back."""
    from rocquantum_tpu_torch.ops import pauli_readout
    terms, coeffs = [(("X", 0),)], [1.0]
    with pytest.raises(RuntimeError, match="cudaError_t"):
        pauli_readout.expval_terms(torch.ones(65536, 2, device=cuda), None,
                                   terms, coeffs)
    with pytest.raises(ValueError):
        pauli_readout.expval_terms(torch.ones(4, dtype=torch.float16,
                                              device=cuda), None, terms,
                                   coeffs)
    with pytest.raises(ValueError):
        pauli_readout.expval_terms(torch.ones(2, 2, 4, device=cuda), None,
                                   terms, coeffs)


@pytest.mark.parametrize("precision,tol", [("single", 1e-6), ("df64", 1e-12)])
def test_circuit_expval_launches_the_pauli_readout_kernel(cuda, precision,
                                                          tol):
    """The main path: ``Circuit.expval`` in single precision and under
    df64 is one launch, against the CPU's plain readout."""
    from rocquantum_tpu_torch.ops import pauli_readout
    n = 16
    ir = hardware_efficient_ansatz_ir(n, 2)
    theta = np.random.default_rng(4).normal(size=ir.num_params)
    op = rq.PauliOperator({"Z0 Z5": -1.0, "X3": 0.5, "Y2 Y7": 0.25,
                           "X1 Z4 Y15": 0.125})
    old = "df64" if rq.df64_enabled() else rq.get_precision()
    rq.set_precision(precision)
    try:
        values = {}
        for dev in (cuda, torch.device("cpu")):
            c = rq.Circuit(n, rq.Simulator(seed=9, device=dev))
            for o in ir.ops:
                c._enqueue(o.name, o.targets, o.controls,
                           [float(theta[p.index]) for p in o.params])
            before = pauli_readout.LAUNCHES
            values[dev.type] = c.expval(op)
            assert pauli_readout.LAUNCHES - before == (dev.type == "cuda")
        assert abs(values["cuda"] - values["cpu"]) < tol
    finally:
        rq.set_precision(old)


def _haar4(rng, count):
    z = rng.normal(size=(count, 4, 4)) + 1j * rng.normal(size=(count, 4, 4))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    return q * (d / np.abs(d))[:, None, :]


def _dense_pass(rng, n, pair_bits, count=24):
    """Random U4 specs on pairs of the local set (both orders, window and
    pair bits mixed) among ``_random_pass``'s complex specs: (specs,
    gate_mats, dense_mats)."""
    specs, mats, _ = _random_pass(rng, n, pair_bits, False, count=count)
    local = list(range(fused_sv.window_bits(n))) + list(pair_bits)
    dense = []
    for u in _haar4(rng, count):
        a, b = (int(q) for q in rng.choice(local, 2, replace=False))
        specs.append(("U4", a, b))
        mats.append(np.eye(2))
        dense.append(u)
    order = rng.permutation(len(specs))
    specs = [specs[i] for i in order]
    gm = _pack_f32([mats[i] for i in order])
    dm = np.zeros((len(specs), 4, 4, 2), np.float32)
    for k, i in enumerate(order):
        if i >= count:
            u = dense[i - count]
            dm[k] = np.stack([u.real, u.imag], -1)
    return specs, gm, dm


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n,pair_bits", [(15, ()), (16, (10, 13, 15)),
                                         (22, (11, 17, 21))])
def test_dense_kernel_matches_reference(cuda, n, pair_bits, batch):
    """Passes with U4 records (the dense two-qubit case, compiled only
    into fused_pass_dense_kernel) against the plain version, batched
    too: one launch a scheduled launch."""
    rng = np.random.default_rng(n * 5 + batch + len(pair_bits))
    specs, gm, dm = _dense_pass(rng, n, pair_bits)
    shape = (batch, 1 << n) if batch > 1 else (1 << n,)
    v = rng.normal(size=(2,) + shape)
    v /= np.linalg.norm(v, axis=(0, -1), keepdims=True)
    re, im = (torch.from_numpy(v[k].astype(np.float32)).to(cuda)
              for k in range(2))
    want = fused_sv.apply_fused_layer_reference(re, im, specs, gm,
                                                dense_mats=dm)
    launches = len(fused_sv.pass_schedule(
        n, fused_sv._normalize_specs(specs), True))
    before = fused_sv.LAUNCHES
    got = fused_sv.apply_fused_layer(re.clone(), im.clone(), specs, gm,
                                     pair_bits=pair_bits, dense_mats=dm)
    torch.cuda.synchronize()
    assert fused_sv.LAUNCHES == before + launches
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def _qv_plan(rng, n, layers):
    """The kernel passes of a QV circuit's dense gates on the complex
    carry: (kinds, passes, gate_mats, dense_mats)."""
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.compiler.ir import GateOp
    ops = []
    for _ in range(layers):
        perm = rng.permutation(n)
        for w, u in enumerate(_haar4(rng, n // 2)):
            ops.append(GateOp("UNITARY", (int(perm[2 * w]),
                                          int(perm[2 * w + 1])), (), (), u))
    (block,) = interpreter.plan_items(ops, n)
    kinds, supports, gm, _, dm = interpreter.pallas_block_specs_dense(
        block, None)
    return kinds, interpreter.kernel_plan(n, kinds, supports,
                                   complex_carry=True), gm, dm


def test_dense_qv_passes_at_n30_match_plain(cuda):
    """The first passes of a QV circuit's plan at n = 30 (every one with
    U4 records, exchanges and pair bits) on 2^30 complex amplitudes, each
    against the plain version on the card."""
    n = 30
    rng = np.random.default_rng(30)
    kinds, plan, gm, dm = _qv_plan(rng, n, 2)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(30)
    re = torch.randn(1 << n, generator=gen, device=cuda)
    im = torch.randn(1 << n, generator=gen, device=cuda)
    scale = float((re.double().square().sum() + im.double().square().sum())
                  ** -0.5)
    re.mul_(scale)
    im.mul_(scale)
    for item in plan[:2]:
        idx = list(item.gate_idx)
        specs = tuple((kinds[i],) + tuple(p)
                      for i, p in zip(idx, item.positions))
        assert any(s[0] == "U4" for s in specs)
        want = fused_sv.apply_fused_layer_reference(re, im, specs, gm[idx],
                                                    dense_mats=dm[idx])
        got = fused_sv.apply_fused_layer(re, im, specs, gm[idx],
                                         pair_bits=item.pair_bits,
                                         dense_mats=dm[idx])
        torch.cuda.synchronize()
        top = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-5 * top
        re, im = got
        del want
        torch.cuda.empty_cache()


def test_quantum_volume_through_the_plugin_on_the_card(cuda, stubs):
    """A QV circuit at n = 20 through the Qiskit plugin on the card:
    every dense gate on the fused kernel, the state against the CPU's
    float64 dense reference, the counts summing to the shots."""
    import sys
    from rocquantum_tpu_torch.integrations.qiskit_provider import \
        RocQuantumBackend
    from rocquantum_tpu_torch.utils import profiling
    from qiskit import QuantumCircuit
    sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
    from portbench.circuits import quantum_volume
    from portbench.reference import dense
    n = 20
    gates = quantum_volume.gates({"num_qubits": n, "depth": 8,
                                  "structure_seed": 3})
    theta = np.random.default_rng(20).uniform(0, 2 * np.pi, len(gates))
    qc = QuantumCircuit(n, n)
    for _, pair, k in gates:
        qc.unitary(dense.matrix(theta[k]), list(pair))
    qc.measure(list(range(n)), list(range(n)))
    backend = RocQuantumBackend(device=cuda)
    before = (fused_sv.LAUNCHES, profiling.COUNTERS["dense2q_kernel_gates"])
    counts = backend.run(qc, shots=512).get_counts()
    assert sum(counts.values()) == 512
    assert fused_sv.LAUNCHES > before[0]
    assert profiling.COUNTERS["dense2q_kernel_gates"] - before[1] == \
        len(gates)
    want = dense.simulate(n, gates, theta, torch.float64,
                          [torch.device("cpu")])
    re, im = want.blocks[0]
    want = torch.complex(re, im).numpy()
    got = backend.get_statevector()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# (name, targets, controls, angles, complex planes): the gates of the
# gradient's users, real and complex planes, controls above and below the
# targets, both target orders, targets on and above index bits 0-1
ADJOINT_CASES = [
    ("RY", (0,), (), (0.7,), False), ("RY", (1,), (), (0.7,), False),
    ("RY", (13,), (), (0.7,), False), ("RY", (19,), (), (0.7,), True),
    ("RX", (5,), (), (1.3,), False), ("RX", (0,), (), (1.3,), True),
    ("RZ", (0,), (), (-0.4,), True), ("RZ", (11,), (3,), (-0.4,), False),
    ("CRY", (0,), (17,), (2.1,), False), ("CRY", (9,), (1,), (2.1,), True),
    ("CRY", (1,), (0,), (2.1,), True),
    ("RZZ", (0, 1), (), (0.9,), True), ("RZZ", (1, 0), (), (0.9,), False),
    ("RZZ", (18, 3), (), (0.9,), False), ("RZZ", (0, 12), (7,), (0.9,), True),
    ("RZZ", (6, 1), (0,), (0.9,), True),
    ("U3", (2,), (0, 15), (0.3, -1.1, 2.5), True),
    ("U3", (1,), (), (0.3, -1.1, 2.5), False),
]


def _adjoint_inputs(cuda, n, name, targets, controls, angles, complex_,
                    seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)

    def planes():
        re = torch.randn(1 << n, generator=gen, device=cuda)
        im = torch.randn(1 << n, generator=gen, device=cuda) \
            if complex_ else None
        scale = float(re.double().square().sum() + (
            0 if im is None else im.double().square().sum())) ** -0.5
        return re.mul_(scale), None if im is None else im.mul_(scale)

    u = gates.gate_matrix({"CRY": "RY"}.get(name, name), angles)
    d = u.shape[0]
    v = np.zeros((1, 4, 4), np.complex128)
    v[0, :d, :d] = u.conj().T
    step = adjoint_step.plan(n, controls, targets)
    return planes(), planes(), adjoint_step.pack(v, [step.swap])[0], step


def _copy(pair):
    return tuple(None if p is None else p.clone() for p in pair)


@pytest.mark.parametrize("n", [20, 22])
@pytest.mark.parametrize("case", ADJOINT_CASES, ids=lambda c: "-".join(
    [c[0], "t" + "_".join(map(str, c[1])), "c" + "_".join(map(str, c[2])),
     "complex" if c[4] else "real"]))
def test_adjoint_step_kernel_matches_plain(cuda, n, case):
    """Planes within 1e-6 of max|amp|, M within 1e-9 of sum|M| (the
    kernel's float64 sums against the plain version's, in another
    order), and a second launch gives the same bits."""
    ket, bra, v, step = _adjoint_inputs(cuda, n, *case, seed=n)
    want_m = torch.zeros(2, 4, 4, dtype=torch.float64, device=cuda)
    want = adjoint_step.apply_reference(_copy(ket), _copy(bra), v, step,
                                        want_m)
    before = adjoint_step.LAUNCHES
    got_m, again_m = torch.zeros_like(want_m), torch.zeros_like(want_m)
    got = adjoint_step.apply(_copy(ket), _copy(bra), v, step, got_m)
    again = adjoint_step.apply(_copy(ket), _copy(bra), v, step, again_m)
    torch.cuda.synchronize()
    assert adjoint_step.LAUNCHES - before == 2
    top = max(float(p.abs().max()) for pair in want for p in pair
              if p is not None)
    for gp, wp, ap in zip(got, want, again):
        for g, w, a in zip(gp, wp, ap):
            assert (g is None) == (w is None) == (a is None)
            if w is not None:
                assert float((g - w).abs().max()) <= 1e-6 * top
                assert torch.equal(g, a)
    assert float((got_m - want_m).abs().max()) <= \
        1e-9 * float(want_m.abs().sum())
    assert torch.equal(got_m, again_m)


def test_adjoint_step_refuses_what_it_cannot_take(cuda):
    n = 12
    ket, bra, v, step = _adjoint_inputs(cuda, n, "RY", (3,), (), (0.7,),
                                        False, seed=1)
    out = torch.zeros(2, 4, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        adjoint_step.apply((ket[0][::2].repeat(2)[::2], None), bra, v, step,
                           out)
    with pytest.raises(ValueError):
        adjoint_step.apply((ket[0].double(), None), (bra[0].double(), None),
                           v, step, out)
    with pytest.raises(ValueError):
        adjoint_step.apply(ket, bra, v, adjoint_step.plan(n + 1, (), (3,)),
                           out)
    with pytest.raises(ValueError):
        adjoint_step.apply(ket, bra, v, step, out.float())
    with pytest.raises(ValueError):
        adjoint_step.plan(n, (), (0, 1, 2))


def test_ring26_gradient_holds_to_the_float64_adjoint(cuda):
    """The gradient cell's request, through ``adjoint_grad``, within the
    cell's limits of the benchmark's float64 adjoint reference, every one
    of its 208 angles' steps served by the adjoint step kernel."""
    import os
    import sys

    from rocquantum_tpu_torch.utils import profiling
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.circuits import basic_entangler
    from portbench.observables import tfim
    from portbench.reference import adjoint

    n, layers = 26, 8
    theta = np.random.default_rng(2026).uniform(0, 2 * np.pi, n * layers)
    gates_ = basic_entangler.gates({"num_qubits": n, "layers": layers,
                                    "rotation": "RY"})
    terms = tfim.terms(n, 1.0, 0.5)
    before = dict(profiling.COUNTERS)
    value, grads = rq.adjoint_grad(rq.kernel(_ring_kernel), n,
                                   rq.Simulator(device=cuda), theta,
                                   _tfim(n), return_value=True)
    steps = {k: profiling.COUNTERS[k] - before[k]
             for k in ("adjoint_steps", "adjoint_kernel_steps")}
    assert steps == {"adjoint_steps": n * layers,
                     "adjoint_kernel_steps": n * layers}
    want_e, want_g = adjoint.gradient(n, gates_, theta, terms,
                                      torch.float64, [cuda])
    scale = sum(abs(c) for c, _ in terms)
    assert abs(value - want_e) / scale <= 2e-6
    assert float(np.abs(np.asarray(grads, np.float64) - want_g).max()) \
        / scale <= 3e-6
