"""The port's relabel layer against the JAX package's: index-bit rotations
(``rotate_bits_down``, ``rotate_region``), ``execute_plan`` with
``Rotation`` items, ``statevec.permute_index_bits`` and the PERMUTE_BITS
pseudo-op of the per-op engines.

The JAX rotation kernel (``relabel._rotate_bits_down_pallas``) runs in
Pallas interpret mode on the CPU; the port's wrappers run their plain-torch
versions on CPU tensors. Inputs come from a numpy seed and go to both.
Rotations and permutations move data and must agree exactly; plans that
also apply gates agree within 1e-5 (the f32 kernel tolerance of the other
port tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rotation_plan
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.compiler.ir import CircuitIR as JaxIR
from rocquantum_tpu.compiler.ir import GateOp as JaxOp
from rocquantum_tpu.ops import df64 as jax_df64
from rocquantum_tpu.ops import pairsim as jax_pairsim
from rocquantum_tpu.ops import relabel as jax_relabel
from rocquantum_tpu.ops import statevec as jax_sv
from rocquantum_tpu.ops.pallas_sv import pack_gate_mats
from rocquantum_tpu_torch.compiler import interpreter as port_interp
from rocquantum_tpu_torch.compiler.ir import GateOp
from rocquantum_tpu_torch.ops import df64, fused_sv, relabel, rotate
from rocquantum_tpu_torch.ops import statevec as port_sv

ATOL = 1e-5


def _plane(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n,shift", [(18, 1), (19, 1), (19, 2)])
def test_rotation_matches_pallas_kernel(n, shift):
    """Every shift the TPU kernel takes (n >= 17, shift <= n - 17)."""
    x = _plane(np.random.default_rng(n * 10 + shift), 1 << n)
    want = np.asarray(jax_relabel._rotate_bits_down_pallas(
        jnp.asarray(x), n, shift, interpret=True))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(rotate.rotate_bits_down(t, n, shift), want)
    np.testing.assert_array_equal(relabel.rotate_region(t, n, shift), want)


@pytest.mark.parametrize("n", [10, 11, 12])
def test_rotation_matches_xla_twin_with_batch(n):
    """Every shift, wraps included, with two leading batch dims."""
    x = _plane(np.random.default_rng(n), (2, 3, 1 << n))
    t = torch.from_numpy(x)
    for shift in range(n - relabel.ROT_LO + 2):
        want = np.asarray(jax_relabel.rotate_bits_down(jnp.asarray(x), n,
                                                        shift))
        np.testing.assert_array_equal(relabel.rotate_bits_down(t, n, shift),
                                      want)
        np.testing.assert_array_equal(relabel.rotate_region(t, n, shift),
                                      want)


@pytest.mark.parametrize("seed", range(4))
def test_permute_index_bits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 11
    state = (rng.normal(size=1 << n)
             + 1j * rng.normal(size=1 << n)).astype(np.complex64)
    for _ in range(6):
        srcs = rng.choice(n, int(rng.integers(1, n + 1)), replace=False)
        dsts = rng.permutation(srcs)
        want = np.asarray(jax_sv.permute_index_bits(
            jnp.asarray(state), dsts.tolist(), srcs.tolist()))
        got = port_sv.permute_index_bits(torch.from_numpy(state),
                                         dsts.tolist(), srcs.tolist())
        np.testing.assert_array_equal(got.numpy(), want)


def test_permute_index_bits_rejects_a_mismatched_set():
    with pytest.raises(ValueError):
        port_sv.permute_index_bits(torch.zeros(1 << 5), [1, 2], [2, 3])


@pytest.mark.parametrize("n,shift", [(12, 3), (14, 1), (14, 6), (15, 7)])
def test_rotate_region_is_the_rotation_permutation(n, shift):
    size = n - relabel.ROT_LO
    srcs = [relabel.ROT_LO + j for j in range(size)]
    dsts = [relabel.ROT_LO + (j - shift) % size for j in range(size)]
    t = torch.from_numpy(_plane(np.random.default_rng(n + shift), 1 << n))
    assert torch.equal(relabel.rotate_region(t, n, shift),
                       port_sv.permute_index_bits(t, dsts, srcs))


def test_rotation_on_cpu_launches_nothing_and_checks_the_plane():
    before = rotate.LAUNCHES
    t = torch.zeros(1 << 12)
    relabel.rotate_region(t, 12, 2)
    assert rotate.LAUNCHES == before
    with pytest.raises(ValueError):
        relabel.rotate_region(t, 13, 1)


# --- execute_plan with Rotation items ---------------------------------------

N = 18


def _hand_plan(pkg, rotation_first=False):
    """A plan valid in both packages at n = 18 (JAX window 17 bits, port
    window 10): gates on bits 0-9, a pair bit 17, a free CNOT control and a
    D2 on window bits; Rotation(1), a second pass, Rotation(10) (back to the
    identity: the region [7, 18) has 11 bits). Returns (plan, kinds)."""
    kinds, supports = [], []
    for q in range(10):
        kinds.append("U")
        supports.append((q,))
    kinds += ["U", "CNOT", "CU", "D2"]
    supports += [(17,), (17, 2), (12, 5), (4, 9)]
    first = pkg.KernelPass(gate_idx=tuple(range(14)),
                           positions=tuple(supports), pair_bits=(17,))
    second_idx = tuple(range(14, 22))
    kinds += ["U"] * 6 + ["CNOT", "U"]
    second_sup = [(q,) for q in (0, 3, 7, 8, 9, 17)] + [(8, 1), (6,)]
    supports += second_sup
    second = pkg.KernelPass(gate_idx=second_idx, positions=tuple(second_sup),
                            pair_bits=(17,))
    plan = [first, pkg.Rotation(1), second, pkg.Rotation(10)]
    if rotation_first:
        plan = [pkg.Rotation(3)] + plan + [pkg.Rotation(8)]
    return plan, kinds


def _gate_mats(rng, kinds, real):
    mats = []
    for kind in kinds:
        if kind == "D2":
            m = rng.choice([-1.0, 1.0], (2, 2)) if real else \
                np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
        elif real:
            th = rng.normal()
            m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        else:
            m, _ = np.linalg.qr(rng.normal(size=(2, 2))
                                + 1j * rng.normal(size=(2, 2)))
        mats.append(np.asarray(m, np.complex128))
    return pack_gate_mats(mats)


@pytest.mark.parametrize("mode", ["real", "complex", "zero", "zero_rotated"])
def test_execute_plan_with_rotations_matches_jax(mode):
    rng = np.random.default_rng(["real", "complex", "zero",
                                 "zero_rotated"].index(mode))
    real = mode != "complex"
    first = mode == "zero_rotated"
    jax_plan, kinds = _hand_plan(jax_relabel, rotation_first=first)
    port_plan, _ = _hand_plan(relabel, rotation_first=first)
    gm = _gate_mats(rng, kinds, real)
    flags = [real] * len(kinds)
    re = im = None
    if mode in ("real", "complex"):
        v = rng.normal(size=1 << N) + (0 if real else 1j) * rng.normal(
            size=1 << N)
        v /= np.linalg.norm(v)
        re = v.real.astype(np.float32)
        im = None if real else v.imag.astype(np.float32)
    want = jax_relabel.execute_plan(
        None if re is None else jnp.asarray(re),
        None if im is None else jnp.asarray(im), jax_plan, jnp.asarray(gm),
        N, kinds=kinds, real_flags=flags, interpret=True)
    got = relabel.execute_plan(
        None if re is None else torch.from_numpy(re),
        None if im is None else torch.from_numpy(im), port_plan, gm, N,
        kinds, real_flags=flags, device="cpu")
    assert (got[1] is None) == (want[1] is None) == real
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=0)
    if not real:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=ATOL, rtol=0)


def test_rotation_plan_matches_pair_plan():
    """An RY layer on every qubit, planned with pair bits and with
    rotations (chip_smoke.rotation_plan, the planner of its relabel-path
    phase), lands on the same state from |0...0>."""
    n = 16
    reach = fused_sv.window_bits(n)
    thetas = np.random.default_rng(3).normal(size=n)
    gm = pack_gate_mats([np.array([[np.cos(t / 2), -np.sin(t / 2)],
                                   [np.sin(t / 2), np.cos(t / 2)]])
                         for t in thetas])
    kinds, flags = ["U"] * n, [True] * n
    pair = relabel.plan_full_layer(n, [(q,) for q in range(n)], reach)
    rot = rotation_plan(relabel, n, list(range(n)), reach)
    assert not any(isinstance(p, relabel.Rotation) for p in pair)
    assert sum(isinstance(p, relabel.Rotation) for p in rot) >= 2
    assert sorted(i for p in rot if isinstance(p, relabel.KernelPass)
                  for i in p.gate_idx) == list(range(n))
    a, _ = relabel.execute_plan(None, None, pair, gm, n, kinds, flags,
                                device="cpu")
    b, _ = relabel.execute_plan(None, None, rot, gm, n, kinds, flags,
                                device="cpu")
    want = np.ones(1)
    for t in thetas:  # the product state, qubit 0 least significant
        want = np.kron([np.cos(t / 2), np.sin(t / 2)], want)
    np.testing.assert_allclose(a.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(b.numpy(), want, atol=ATOL)


# --- the PERMUTE_BITS pseudo-op in the per-op engines -----------------------

PERM_N = 9
PERM_OPS = [((1, 5, 8), (8, 1, 5), False), ((2, 3, 6, 7), (6, 7, 2, 3), True)]


@pytest.fixture
def x64():
    old = (jax_config.get_precision(), jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", True)
    yield
    jax_config.set_precision(old[0])
    jax.config.update("jax_enable_x64", old[1])


def _state(dtype):
    rng = np.random.default_rng(17)
    v = rng.normal(size=1 << PERM_N) + 1j * rng.normal(size=1 << PERM_N)
    return (v / np.linalg.norm(v)).astype(dtype)


@pytest.mark.parametrize("dsts,srcs,adjoint", PERM_OPS)
def test_permute_bits_op_single_precision(dsts, srcs, adjoint):
    psi = _state(np.complex64)
    want = np.asarray(jax_interp.apply_op(
        jnp.asarray(psi), JaxOp("PERMUTE_BITS", dsts, srcs,
                                is_adjoint=adjoint)))
    got = port_interp.apply_op(torch.from_numpy(psi),
                               GateOp("PERMUTE_BITS", dsts, srcs,
                                      is_adjoint=adjoint))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dsts,srcs,adjoint", PERM_OPS)
def test_permute_bits_op_double_precision(x64, dsts, srcs, adjoint):
    """The exact double engines (JAX pairsim.compile_pair_ir, port
    run_ops_f64) and the df64 per-op engines (JAX compile_df64_ir, port
    apply_op_df64), with an H before and after the relabel."""
    psi = _state(np.complex128)
    ir = JaxIR(PERM_N)
    ir.add("H", [2])
    ir.ops.append(JaxOp("PERMUTE_BITS", dsts, srcs, is_adjoint=adjoint))
    ir.add("H", [5])
    port_ops = [GateOp("H", (2,)),
                GateOp("PERMUTE_BITS", dsts, srcs, is_adjoint=adjoint),
                GateOp("H", (5,))]
    re, im = jax_pairsim.compile_pair_ir(ir)(
        jnp.asarray(psi.real), jnp.asarray(psi.imag), jnp.zeros((0,)))
    want = np.asarray(re) + 1j * np.asarray(im)
    got = port_interp.run_ops_f64(torch.from_numpy(psi.real.copy()),
                                  torch.from_numpy(psi.imag.copy()), port_ops)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), want,
                               atol=1e-15, rtol=0)

    jax_planes = jax_df64.state_from_pair_f64(jnp.asarray(psi.real),
                                              jnp.asarray(psi.imag))
    want = jax_df64.state_to_pair_f64(jax_df64.compile_df64_ir(ir)(
        *jax_planes, jnp.zeros((0,))))
    planes = df64.state_from_pair_f64(torch.from_numpy(psi.real.copy()),
                                      torch.from_numpy(psi.imag.copy()))
    for op in port_ops:
        planes = df64.apply_op_df64(planes, op)
    got = df64.state_to_pair_f64(planes)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-15,
                                   rtol=0)
