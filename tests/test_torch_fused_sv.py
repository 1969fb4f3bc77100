"""The port's fused-layer pass (rocquantum_tpu_torch.ops.fused_sv) against
the JAX package's Pallas kernels in interpret mode.

``apply_fused_layer_reference`` (the plain-torch version the CUDA kernel is
held to on the card) must compute what every TPU route of
``rocquantum_tpu.ops.pallas_sv.apply_fused_layer`` computes: the window
kernel (no pair bits), the merged-run kernel (one contiguous run), the
tiles-list kernel (two runs) and the deferred |0..0> init, each on a real
plane and on complex planes, with every spec kind, free CNOT/CU controls
and D2 on free bits. Inputs come from a numpy seed and go to both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rocquantum_tpu.compiler import interpreter as jax_interp
from rocquantum_tpu.compiler.passes import PallasBlock as JaxBlock
from rocquantum_tpu.ops import pallas_sv
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch.compiler import interpreter as port_interp
from rocquantum_tpu_torch.compiler.passes import PallasBlock
from rocquantum_tpu_torch.ops import fused_sv

N = 18
ATOL = 1e-5

# route -> (geometry, pair_bits): the JAX window is 17 bits at the default
# geometry (12, 5) and 15 at the tall one (10, 5)
ROUTES = {
    "window": (None, ()),                       # _kernel
    "merged": (None, (17,)),                    # _kernel_merged
    "multi": (pallas_sv.TALL_GEOMETRY, (15, 17)),  # _kernel_multi
}


def _limit(geometry):
    col, tile = geometry or (pallas_sv.COL_QUBITS, pallas_sv.TILE_ROWS_LOG2)
    return col + tile


def _matrix(rng, kind, real):
    if kind == "D2":
        if real:
            return rng.choice([-1.0, 1.0], (2, 2)).astype(np.complex128)
        return np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
    if real:
        th = rng.normal()
        return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                        np.complex128)
    q, _ = np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
    return q


def random_specs(rng, n, limit, pair_bits, real, count=32):
    """Specs legal for the JAX geometry: targets in the window or the pair
    set, controls anywhere (free above the window), D2 on any bits; every
    pair bit is touched (the JAX driver prunes untouched ones)."""
    local = list(range(limit)) + list(pair_bits)
    free = [q for q in range(limit, n) if q not in pair_bits]
    specs = [("U", p) for p in pair_bits]
    for i in range(count):
        kind = ("U", "CNOT", "CU", "D2")[i % 4]
        t = int(rng.choice(local))
        if kind == "U":
            specs.append(("U", t))
        elif kind in ("CNOT", "CU"):
            pool = free if (free and i % 8 < 4) else \
                [q for q in local if q != t]
            specs.append((kind, int(rng.choice(pool)), t))
        elif i % 8 == 3 and free:
            specs.append(("D2", int(rng.choice(free)), int(rng.choice(free))))
        else:
            specs.append(("D2", int(rng.choice(local)), int(rng.integers(n))))
    mats = [_matrix(rng, s[0], real) for s in specs]
    gm = pallas_sv.pack_gate_mats(mats)
    return specs, gm, [real] * len(specs)


def random_pair(rng, n, real):
    v = rng.normal(size=1 << n) + (0 if real else 1j) * rng.normal(size=1 << n)
    v = v / np.linalg.norm(v)
    return (v.real.astype(np.float32),
            None if real else v.imag.astype(np.float32))


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("mode", ["real", "complex"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_reference_matches_pallas_routes(route, mode):
    geometry, pair_bits = ROUTES[route]
    rng = np.random.default_rng(sorted(ROUTES).index(route) * 2
                                + (mode == "real"))
    real = mode == "real"
    specs, gm, flags = random_specs(rng, N, _limit(geometry), pair_bits, real)
    re, im = random_pair(rng, N, real)
    want = pallas_sv.apply_fused_layer(
        jnp.asarray(re), None if im is None else jnp.asarray(im), specs,
        jnp.asarray(gm), pair_bits=pair_bits, real_flags=flags,
        geometry=geometry, interpret=True)
    t_re, t_im = convert.state_from_numpy(re, im)
    got = fused_sv.apply_fused_layer_reference(t_re, t_im, specs, gm,
                                               real_flags=flags)
    assert (got[1] is None) == real
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=ATOL)
    if not real:
        np.testing.assert_allclose(got[1].numpy(), _np(want[1]), atol=ATOL)
    # the inputs are untouched (the reference is functional)
    np.testing.assert_array_equal(t_re.numpy(), re)


@pytest.mark.parametrize("route", ["window", "merged"])
def test_start_from_zero_real_plane(route):
    """re=None: the deferred |0..0> writer (_gen_zero_input) under a real
    gate list, against the reference's start-from-|0..0> mode."""
    geometry, pair_bits = ROUTES[route]
    rng = np.random.default_rng(11 + len(pair_bits))
    specs, gm, flags = random_specs(rng, N, _limit(geometry), pair_bits,
                                    real=True)
    want, want_im = pallas_sv.apply_fused_layer(
        None, None, specs, jnp.asarray(gm), pair_bits=pair_bits,
        real_flags=flags, geometry=geometry, num_qubits=N, interpret=True)
    got, got_im = fused_sv.apply_fused_layer_reference(
        None, None, specs, gm, real_flags=flags, num_qubits=N)
    assert want_im is None and got_im is None
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def _mixed_block_ops(n):
    """A kernel block with complex gates on every kind: H/RY/T columns,
    CNOT and CRY on high controls, controlled phases, RZZ and a D2M."""
    from rocquantum_tpu.compiler.ir import CircuitIR
    ir = CircuitIR(n)
    for q in range(0, n, 3):
        ir.add("H", [q])
    ir.add("CNOT", [2], controls=[n - 1])
    ir.add("CRY", [13], controls=[n - 2], params=[0.37])
    ir.add("P", [5], controls=[n - 1], params=[0.81])
    ir.add("RZZ", [1, n - 3], params=[0.29])
    ir.add("D2M", [4, n - 1], matrix=np.exp(1j * np.array([[0.1, 0.2],
                                                             [0.3, 0.4]])))
    for q in range(1, n, 4):
        ir.add("T", [q])
        ir.add("RY", [q], params=[0.2 + 0.1 * q])
    return ir


def test_start_from_zero_complex_block():
    """A complex block started from re=None: both packages materialize
    |0..0> and run the pair path (JAX: deferred init then _run_pallas_specs;
    port: the same through its own pass plan)."""
    jax_ir = _mixed_block_ops(N)
    port_ir = convert.ir_from_reference(jax_ir)
    want = jax_interp._apply_pallas_block_pair(
        None, None, JaxBlock(ops=list(jax_ir.ops)), None, interpret=True,
        num_qubits=N)
    block = port_interp._plan_block(PallasBlock(ops=list(port_ir.ops)), N,
                                    fused_sv)
    got = port_interp._run_block((None, None), block, None, N, device="cpu")
    assert got[1] is not None
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), atol=ATOL)


def test_block_specs_match_reference_packing():
    """pallas_block_specs packs kinds, supports, matrices and real flags
    exactly as the JAX package does."""
    jax_ir = _mixed_block_ops(N)
    port_ir = convert.ir_from_reference(jax_ir)
    jk, js, jgm, jflags = jax_interp.pallas_block_specs(
        JaxBlock(ops=list(jax_ir.ops)), None)
    pk, ps, pgm, pflags = port_interp.pallas_block_specs(
        PallasBlock(ops=list(port_ir.ops)), None)
    assert list(pk) == list(jk)
    assert [tuple(s) for s in ps] == [tuple(s) for s in js]
    assert list(pflags) == list(jflags)
    np.testing.assert_allclose(pgm, np.asarray(jgm), atol=1e-6)


def test_wrapper_on_cpu_uses_reference_and_launches_nothing():
    rng = np.random.default_rng(5)
    n = 14
    w = fused_sv.window_bits(n)
    specs, gm, flags = random_specs(rng, n, w, (11, 13), real=False)
    re, im = random_pair(rng, n, real=False)
    t_re, t_im = convert.state_from_numpy(re, im)
    before = fused_sv.LAUNCHES
    got = fused_sv.apply_fused_layer(t_re, t_im, specs, gm,
                                     pair_bits=(11, 13), real_flags=flags)
    want = fused_sv.apply_fused_layer_reference(t_re, t_im, specs, gm,
                                                real_flags=flags)
    assert fused_sv.LAUNCHES == before
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("bad", [
    dict(specs=[("U", 12)]),                       # outside the local set
    dict(specs=[("CNOT", 3, 12)]),                 # target outside
    dict(specs=[("U", 0)], pair_bits=(10, 11, 12, 13)),  # too many pairs
    dict(specs=[("U", 0)], pair_bits=(4,)),        # pair bit in the window
    dict(specs=[("U", 0)], real=False, im=False),  # complex gate, real plane
    dict(specs=[("CU", 2, 2)]),                    # control == target
    dict(specs=[("SWAP", 0, 1)]),                  # unknown kind
])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    n = 14
    re = torch.zeros(1 << n)
    im = None if bad.get("im") is False else torch.zeros(1 << n)
    specs = bad["specs"]
    gm = np.zeros((len(specs), 2, 2, 2), np.float32)
    flags = [bad.get("real", True)] * len(specs)
    with pytest.raises(ValueError):
        fused_sv.apply_fused_layer(re, im, specs, gm,
                                   pair_bits=bad.get("pair_bits", ()),
                                   real_flags=flags)


def test_free_control_and_free_diagonal_in_port_geometry():
    """Port geometry (10 window bits): a CNOT whose control lies above the
    window and outside the pair set, and a D2 on two such bits, match a
    dense complex reference built from the gate matrices."""
    n = 15
    rng = np.random.default_rng(3)
    re, im = random_pair(rng, n, real=False)
    psi = re.astype(np.complex128) + 1j * im
    d = np.exp(1j * np.array([[0.3, -0.2], [0.9, 1.4]]))
    specs = [("CNOT", 14, 2), ("D2", 12, 13), ("CU", 11, 10)]
    u = np.array([[0, 1j], [1j, 0]])
    gm = pallas_sv.pack_gate_mats([np.eye(2), d, u])
    t_re, t_im = convert.state_from_numpy(re, im)
    got = fused_sv.apply_fused_layer(t_re, t_im, specs, gm, pair_bits=(10,),
                                     real_flags=[True, False, False])
    idx = np.arange(1 << n)
    bit = lambda q: (idx >> q) & 1  # noqa: E731
    want = psi.copy()
    want = np.where(bit(14) == 1, want[idx ^ (1 << 2)], want)
    want = want * d[bit(12), bit(13)]
    flip = want[idx ^ (1 << 10)]
    want = np.where(bit(11) == 1,
                    u[bit(10), bit(10)] * want + u[bit(10), 1 - bit(10)] * flip,
                    want)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), want,
                               atol=ATOL)
