"""The port's tensor-network engine against the JAX package's.

``rocquantum_tpu_torch.tensornet`` against ``rocquantum_tpu.tensornet`` on
the CPU: the same numpy tensors, made from seeds, go to both packages.
Plans must be identical step for step (the greedy scan in the port's
Python and native forms, opt_einsum's OPTIMAL and AUTO), a sliced
contraction must choose as many slices as the JAX package's and equal the
unsliced one, and contractions and SVDs must agree.

Tolerances: rtol 2e-3 in complex64, as tests/test_tensornet.py uses;
1e-10 in complex128.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import rocquantum_tpu.tensornet as jtn
from rocquantum_tpu import config as jax_config
from rocquantum_tpu.tensornet import pathfinder as jax_pathfinder
from rocquantum_tpu.tensornet.workspace import WorkspaceEstimator as JaxWS
import rocquantum_tpu_torch as rq
from rocquantum_tpu_torch import config as port_config
from rocquantum_tpu_torch import convert
from rocquantum_tpu_torch import tensornet as ptn
from rocquantum_tpu_torch.tensornet import _native_pathfinder
from rocquantum_tpu_torch.tensornet import pathfinder as port_pathfinder
from rocquantum_tpu_torch.tensornet.workspace import WorkspaceEstimator
from rocquantum_tpu_torch.parallel import make_mesh

RTOL = 2e-3
RTOL_DOUBLE = 1e-10
CPU = "cpu"


def _mode(config) -> str:
    return "df64" if config.df64_enabled() else config.get_precision()


@pytest.fixture(autouse=True)
def restore_precision():
    """Both packages' precision and JAX's x64 flag (which
    set_precision("double") turns on) are as they were afterwards."""
    old = (_mode(jax_config), _mode(port_config), jax.config.jax_enable_x64)
    yield
    jax_config.set_precision(old[0])
    rq.set_precision(old[1])
    jax.config.update("jax_enable_x64", old[2])


def rand(shape, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)


def _networks(specs, memory_limit_bytes=None):
    """(JAX network, port network) over the same (array, labels) list."""
    jax_net = jtn.TensorNetwork(memory_limit_bytes=memory_limit_bytes)
    for array, labels in specs:
        jax_net.add_tensor(array, list(labels))
    return jax_net, convert.network_from_reference(jax_net, CPU)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


# ---------------------------------------------------------------------------
# Tensors, pair and einsum contractions
# ---------------------------------------------------------------------------

def test_tensor_validation_permute_and_spec():
    x = rand((2, 3, 4), 1)
    t = ptn.Tensor.from_numpy(x, ["a", "b", "c"], device=CPU)
    assert t.labels == ("a", "b", "c") and t.dim_of("b") == 3
    assert t.shape == (2, 3, 4) and t.size_bytes == 24 * 8
    assert t.data.dtype == torch.complex64
    assert t.to_numpy().dtype == np.complex128
    np.testing.assert_array_equal(ptn.permute(t, "cab").to_numpy(),
                                  np.transpose(x, (2, 0, 1)))
    for bad in (["a", "b"], ["a", "a", "b"]):
        with pytest.raises(ValueError):
            ptn.Tensor.from_numpy(x, bad, device=CPU)
    with pytest.raises(ValueError):
        ptn.permute(t, ["a", "b", "x"])
    assert ptn.parse_einsum_spec("ab, bc->ac") == \
        jtn.parse_einsum_spec("ab, bc->ac")
    for bad in ("ab,bc", "ab,->c"):
        with pytest.raises(ValueError):
            ptn.parse_einsum_spec(bad)


@pytest.mark.parametrize("keep", [(), ("b",)])
def test_contract_pair_matches_reference(keep):
    a, b = rand((4, 5), 1), rand((5, 6), 2)
    want = jtn.contract_pair(jtn.Tensor.from_numpy(a, "ab"),
                             jtn.Tensor.from_numpy(b, "bc"), keep=keep)
    got = ptn.contract_pair(ptn.Tensor.from_numpy(a, "ab", device=CPU),
                            ptn.Tensor.from_numpy(b, "bc", device=CPU),
                            keep=keep)
    assert got.labels == want.labels
    _close(got.to_numpy(), want.to_numpy())


def test_contract_einsum_matches_reference():
    a, b = rand((3, 4), 3), rand((4, 3), 4)
    want = jtn.contract_einsum("ij,jk->ik", jtn.Tensor.from_numpy(a, "xy"),
                               jtn.Tensor.from_numpy(b, "yz"))
    got = ptn.contract_einsum(
        "ij,jk->ik", ptn.Tensor.from_numpy(a, "xy", device=CPU),
        torch.as_tensor(b))
    assert got.labels == want.labels == ("i", "k")
    _close(got.to_numpy(), want.to_numpy())
    with pytest.raises(ValueError):
        ptn.contract_einsum("ij,jk->ik", torch.as_tensor(a))


NETWORKS = {
    "two": [(rand((2, 2), 5), "ab"), (rand((2, 2), 6), "bc")],
    "chain": [(rand((6, 6), i), "abcde"[i:i + 2]) for i in range(4)],
    "scalar": [(rand((3, 4), 7), "ij"), (rand((4, 3), 8), "ji")],
    # a label on three tensors is summed only at its last use
    "hyperedge": [(rand((4,), 8), "k"), (rand((4,), 9), "k"),
                  (np.ones(4, np.complex64), "k")],
    "star": [(rand((3, 4, 5), 10), "abc"), (rand((4, 2), 11), "bd"),
             (rand((5, 2, 3), 12), "cea"), (rand((2, 2), 13), "de")],
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_contraction_matches_reference(name):
    jax_net, port_net = _networks(NETWORKS[name])
    want = jax_net.contract()
    got = port_net.contract()
    assert got.labels == want.labels
    assert got.data.dtype == torch.complex64
    _close(got.to_numpy(), want.to_numpy())
    assert [(s.i, s.j, s.out_labels) for s in port_net.last_plan.steps] == \
        [(s.i, s.j, s.out_labels) for s in jax_net.last_plan.steps]


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def random_network(seed, n_tensors=10, n_labels=16):
    rng = np.random.default_rng(seed)
    pool = [f"l{i}" for i in range(n_labels)]
    dims = {l: int(rng.choice([2, 3, 4, 8])) for l in pool}
    labels, shapes = [], []
    for _ in range(n_tensors):
        k = int(rng.integers(1, 5))
        ls = tuple(str(l) for l in rng.choice(pool, size=k, replace=False))
        labels.append(ls)
        shapes.append(tuple(dims[l] for l in ls))
    return labels, shapes


def _plan_key(plan):
    return ([(s.i, s.j, tuple(s.out_labels), s.flops, s.out_size)
             for s in plan.steps], plan.total_flops,
            plan.largest_intermediate)


PLAN_CASES = {f"random{seed}": random_network(seed) for seed in range(5)}
PLAN_CASES["chain"] = ([("a", "b"), ("b", "c"), ("c", "d")],
                       [(8, 4), (4, 16), (16, 2)])
PLAN_CASES["ties"] = ([("a", "b"), ("b", "c"), ("c", "a")],
                      [(8, 8), (8, 8), (8, 8)])


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_greedy_plans_match_reference(name):
    labels, shapes = PLAN_CASES[name]
    want = _plan_key(jax_pathfinder.find_greedy_path(labels, shapes))
    native = _native_pathfinder.find_greedy_path(labels, shapes)
    assert native is not None, "the native pathfinder did not build"
    assert _plan_key(native) == want
    assert _plan_key(port_pathfinder.find_greedy_path(labels, shapes)) == want
    cfg = ptn.OptimizerConfig.from_dict({"algorithm": "greedy"})
    assert _plan_key(ptn.Pathfinder(cfg).find_optimal_path(labels, shapes)) \
        == want


@pytest.mark.parametrize("algorithm", ["optimal", "auto", "kahypar", "metis"])
def test_opt_einsum_plans_match_reference(algorithm):
    pytest.importorskip("opt_einsum")
    labels, shapes = random_network(3, n_tensors=6)
    want = jtn.Pathfinder(jtn.OptimizerConfig.from_dict(
        {"algorithm": algorithm})).find_optimal_path(labels, shapes)
    got = ptn.Pathfinder(ptn.OptimizerConfig.from_dict(
        {"algorithm": algorithm})).find_optimal_path(labels, shapes)
    assert _plan_key(got) == _plan_key(want)


@pytest.mark.parametrize("algorithm", ["optimal", "auto"])
def test_opt_einsum_planners_raise_without_it(monkeypatch, algorithm):
    monkeypatch.setitem(sys.modules, "opt_einsum", None)
    pf = ptn.Pathfinder(ptn.OptimizerConfig.from_dict(
        {"algorithm": algorithm}))
    with pytest.raises(ImportError, match="opt_einsum"):
        pf.find_optimal_path([("a", "b"), ("b", "c")], [(2, 2), (2, 2)])


def test_config_and_workspace_match_reference():
    d = {"algorithm": "AUTO", "memory_limit": 4096, "num_slices": 3,
         "repetitions": 2}
    got, want = ptn.OptimizerConfig.from_dict(d), \
        jtn.OptimizerConfig.from_dict(d)
    assert (got.algorithm.value, got.memory_limit_bytes, got.num_slices,
            got.repetitions) == (want.algorithm.value, want.memory_limit_bytes,
                                 want.num_slices, want.repetitions)
    labels, shapes = random_network(1)
    plan = port_pathfinder.find_greedy_path(labels, shapes)
    sizes = [int(np.prod(s)) for s in shapes]
    for ws, ref in ((WorkspaceEstimator(8), JaxWS(8)),
                    (WorkspaceEstimator(16), JaxWS(16))):
        assert ws.step_footprints(plan, sizes) == \
            ref.step_footprints(plan, sizes)
        assert ws.peak_bytes(plan, sizes) == ref.peak_bytes(plan, sizes)
        assert ws.violating_steps(plan, sizes, 2048) == \
            ref.violating_steps(plan, sizes, 2048)


def test_native_pathfinder_builds_outside_the_package():
    assert _native_pathfinder.pathfinder_name() == "native"
    pkg = os.path.dirname(_native_pathfinder.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


# ---------------------------------------------------------------------------
# Slicing
# ---------------------------------------------------------------------------

def _pair32(seed=7):
    return [(rand((32, 32), seed), "ak"), (rand((32, 32), seed + 1), "kb")]


SLICE_CASES = {
    # name: (tensors, optimizer config)
    "free": ([(rand((2, 2, 2, 16), 1), "abcd"),
              (rand((16, 2, 2, 16), 2), "defg"),
              (rand((16, 2, 2, 2), 3), "ghij")], {"memory_limit": 2048}),
    "chunked": (_pair32(), {"memory_limit": 32 * 32 * 8 // 4}),
    "num_slices": (_pair32(), {"num_slices": 4}),
    "num_slices_and_limit": (_pair32(), {"memory_limit": 32 * 32 * 8,
                                         "num_slices": 8}),
    "multi_label": ([(rand((8, 8, 8), 1), "abk"), (rand((8, 8, 8), 2), "kcd")],
                    {"memory_limit": 8 * 8 * 8}),
    "contracted": ([(rand((64, 64), 11), "ij"), (rand((64, 64), 12), "ji")],
                   {"num_slices": 8}),
    "beyond_free": ([(rand((2, 64), 12), "fk"),
                     (rand((64,), 13).real.astype(np.complex64), "k")],
                    {"num_slices": 16}),
    "big_input_scalar": ([(rand((64, 64), 5), "ij"), (rand((64, 64), 6), "ji")],
                         {"memory_limit": 1024 * 8}),
    "input_slabs": ([(rand((32, 32, 8), 6), "ijk"),
                     (rand((32, 32, 8), 7), "jim")], {"memory_limit": 512 * 8}),
}


@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_sliced_matches_unsliced_and_reference(name):
    specs, cfg = SLICE_CASES[name]
    jax_net, port_net = _networks(specs)
    want = jax_net.contract(dict(cfg))
    got = port_net.contract(dict(cfg))
    assert port_net.last_num_slices == jax_net.last_num_slices > 1
    assert got.labels == want.labels
    _close(got.to_numpy(), want.to_numpy())
    unsliced = port_net.contract()
    assert port_net.last_num_slices == 1
    assert unsliced.labels == got.labels
    _close(got.to_numpy(), unsliced.to_numpy())


@pytest.mark.parametrize("name,shards", [("free", 4), ("contracted", 4),
                                         ("num_slices", 8), ("ring", 4)])
def test_mesh_spread_slices_match_the_reference(name, shards):
    """contract(mesh=, axis_name=): at least one slice per device, each
    device's consecutive slices into its own partial output, one counted
    sum; the JAX package's mesh contraction on its virtual devices."""
    from rocquantum_tpu.parallel import mesh as jax_mesh
    from rocquantum_tpu_torch.parallel import (count_collectives,
                                               reset_collectives)
    if name == "ring":
        specs, cfg = ([(rand((48, 48), 21), "ab"), (rand((48, 48), 22), "bc"),
                       (rand((48, 48), 23), "ca")], {"num_slices": 4})
    else:
        specs, cfg = SLICE_CASES[name]
    jax_net, port_net = _networks(specs)
    want = jax_net.contract(dict(cfg), mesh=jax_mesh.make_mesh(shards),
                            axis_name="sv")
    reset_collectives()
    got = port_net.contract(dict(cfg), axis_name="sv",
                            mesh=make_mesh(shards, devices=[CPU] * shards))
    assert port_net.last_num_slices == jax_net.last_num_slices >= shards
    assert count_collectives()["all-reduce"] >= 1
    assert got.labels == want.labels
    _close(got.to_numpy(), want.to_numpy())
    _close(got.to_numpy(), port_net.contract().to_numpy())


def test_mesh_of_virtual_shards_holds_one_partial_output():
    """Mesh entries that share a device accumulate into one partial output
    there: the step's tally on 4 virtual shards of one device is the
    unsharded sliced step's (one output, one slab)."""
    _, port_net = _networks([(rand((48, 48), 21), "ab"),
                             (rand((48, 48), 22), "bc")])
    cfg = port_net._config({"num_slices": 4})
    got, spread = port_net._run(cfg, [CPU] * 4)
    want, alone = port_net._run(cfg)
    assert spread == alone < 2 * 48 * 48 * 8
    _close(got.to_numpy(), want.to_numpy())


def test_memory_limit_of_the_network_applies():
    jax_net, port_net = _networks(_pair32(), memory_limit_bytes=32 * 32 * 2)
    port_net.contract()
    jax_net.contract()
    assert port_net.last_num_slices == jax_net.last_num_slices > 1


def test_impossible_memory_limit_raises():
    _, port_net = _networks([(rand((8, 8), 1), "ab"), (rand((8, 8), 2), "bc")])
    with pytest.raises(MemoryError):
        port_net.contract({"memory_limit": 4})  # below one element


def test_sliced_tally_is_bounded():
    """The counterpart of test_sliced_peak_temp_memory_is_bounded: a 2^22
    element output (32 MiB complex64) sliced into 64 slabs holds the
    output plus at most a few slabs beyond its inputs."""
    dim = 1 << 11
    rng = np.random.default_rng(1)
    a = rng.normal(size=(dim, 16)).astype(np.float32).astype(np.complex64)
    b = rng.normal(size=(16, dim)).astype(np.float32).astype(np.complex64)

    def build():
        tn = ptn.TensorNetwork(device=CPU)
        tn.add_tensor(a, ["a", "k"])
        tn.add_tensor(b, ["k", "b"])
        return tn

    out_bytes = dim * dim * 8
    slab = out_bytes // 64
    unsliced = build().compiled_memory_stats()
    assert unsliced.temp_size_in_bytes == out_bytes
    tn = build()
    sliced = tn.compiled_memory_stats({"memory_limit": slab})
    assert tn.last_num_slices >= 64
    assert out_bytes + slab <= sliced.temp_size_in_bytes \
        <= out_bytes + 4 * slab
    assert sliced.temp_size_in_bytes <= unsliced.temp_size_in_bytes + 4 * slab


def test_mesh_raises():
    _, port_net = _networks(_pair32())
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="together"):
        port_net.contract({"num_slices": 8}, mesh=mesh)
    with pytest.raises(ValueError, match="together"):
        port_net.contract({"num_slices": 8}, axis_name="sv")


def test_double_precision_contraction_matches_reference():
    jax_config.set_precision("double")
    rq.set_precision("double")
    specs = [(rand((6, 6), i, np.complex128), "abcde"[i:i + 2])
             for i in range(4)]
    jax_net, port_net = _networks(specs)
    want = jax_net.contract({"num_slices": 3})
    got = port_net.contract({"num_slices": 3})
    assert got.data.dtype == torch.complex128
    assert port_net.last_num_slices == jax_net.last_num_slices == 3
    _close(got.to_numpy(), want.to_numpy(), RTOL_DOUBLE)
    m = [a for a, _ in specs]
    _close(got.to_numpy(), m[0] @ m[1] @ m[2] @ m[3], RTOL_DOUBLE)
    t = ptn.Tensor.from_numpy(m[0], "ab", device=CPU)
    assert t.data.dtype == torch.complex128


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptn.TensorNetwork()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptn.Tensor.from_numpy(rand((2, 2)), "ab")
    net = ptn.TensorNetwork(rq.Simulator(device=CPU))
    assert net.device == torch.device(CPU)


# ---------------------------------------------------------------------------
# SVD
# ---------------------------------------------------------------------------

SVD_CASES = {"matrix": ((6, 8), "mn", "m", "n"),
             "higher_rank": ((2, 3, 4, 5), "abcd", "ac", "bd"),
             "default_cols": ((4, 3, 5), "xyz", "zx", None)}


@pytest.mark.parametrize("name", sorted(SVD_CASES))
def test_svd_matches_reference(name):
    shape, labels, rows, cols = SVD_CASES[name]
    x = rand(shape, 11)
    ju, js, jv = jtn.tensor_svd(jtn.Tensor.from_numpy(x, labels), rows, cols)
    t = ptn.Tensor.from_numpy(x, labels, device=CPU)
    u, s, v = ptn.tensor_svd(t, rows, cols)
    assert (u.labels, s.labels, v.labels) == (ju.labels, js.labels, jv.labels)
    assert (u.shape, s.shape, v.shape) == (
        tuple(ju.shape), tuple(js.shape), tuple(jv.shape))
    # U and V columns each carry a free phase: compare the singular values
    # and the reconstruction
    _close(s.data.numpy(), np.asarray(js.data))
    recon = ptn.contract_pair(ptn.contract_pair(u, s, keep=["_s"]), v)
    back = ptn.permute(recon, labels).to_numpy()
    assert float(np.abs(back - x).max()) <= 1e-4 * float(np.abs(x).max())


def test_svd_validation():
    t = ptn.Tensor.from_numpy(rand((2, 2)), ["a", "b"], device=CPU)
    for rows, cols in ((["a"], ["a"]), (["a"], ["c"]), (["a"], [])):
        with pytest.raises(ValueError):
            ptn.tensor_svd(t, rows, cols)
