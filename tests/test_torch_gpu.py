"""The CUDA kernels on the card against their plain-torch versions: the
fused-layer kernels (f32 and df64), the index-bit rotation copy and the
two tensor-core region dots; and the paths that launch them: Circuit,
compile_program and the adjoint gradient. Also the tensor-network
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
from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir, qft_ir
from rocquantum_tpu_torch.ops import (df64, fused_df64, fused_sv, region_dot,
                                      relabel, rotate)
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
    """The sweep's forward and every U^dagger step launch the fused kernel;
    the same sweep with the plain layer function agrees."""
    n = 20
    theta = np.random.default_rng(20).normal(size=3 * n)
    before = fused_sv.LAUNCHES
    value, grads = _value_and_grad(n, theta, cuda)
    launches = fused_sv.LAUNCHES - before
    # the forward's passes, then two one-gate passes per angle at least
    assert launches >= 2 * len(theta)
    with _plain_layers():
        want_v, want_g = _value_and_grad(n, theta, cuda)
    assert fused_sv.LAUNCHES - before == launches
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
    before = (fused_sv.LAUNCHES, fused_df64.LAUNCHES)
    value, grads = rq.adjoint_grad(rq.kernel(_ring_kernel), n,
                                   rq.Simulator(device=cuda), theta,
                                   _tfim(n), return_value=True)
    assert fused_sv.LAUNCHES - before[0] >= 2 * n
    assert fused_df64.LAUNCHES == before[1]
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
