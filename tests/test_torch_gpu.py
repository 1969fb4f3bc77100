"""The CUDA fused-layer kernel on the card, against its plain-torch version.

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
from rocquantum_tpu_torch.ops import fused_sv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _random_pass(rng, n, pair_bits, real, count=40):
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
        m = np.asarray(m, np.complex128)
        mats.append(np.stack([m.real, m.imag], -1).astype(np.float32))
    return specs, np.stack(mats), [real] * count


@pytest.mark.parametrize("mode", ["real", "complex", "zero"])
@pytest.mark.parametrize("pair_bits", [(), (12,), (10, 14, 17)])
def test_kernel_matches_reference(cuda, mode, pair_bits):
    n = 18
    rng = np.random.default_rng(len(pair_bits) * 3 + len(mode))
    specs, gm, flags = _random_pass(rng, n, pair_bits, mode != "complex")
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


def test_wrapper_rejects_noncontiguous_plane(cuda):
    re = torch.zeros(1 << 16, device=cuda)[::2]
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(re, None, [("U", 0)],
                                   np.zeros((1, 2, 2, 2), np.float32),
                                   real_flags=[True])


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
