"""The benchmark finds configurations, mixes, limits and per-layer
readers by name, and a cell added as new files runs without an edit to
any file already there."""

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import harness, trace  # noqa: E402


def bench():
    with open(os.path.join(smallcopy.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_its_files(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.kind.NUMBERS == {"energy": ("energy_err",),
                              "shots": ("xeb_dev", "dup_z"),
                              "grad": ("energy_err", "grad_err")}[
                                  c.traffic["request"]]
    # a kind that owns its request holds no state: no state_err
    assert c.owns_request == (c.traffic["request"] == "grad")
    held = set() if c.owns_request else {"state_err"}
    assert set(c.limits) == held | set(c.kind.NUMBERS)
    assert c.chips == c.config["chips"]
    assert c.n == c.config["num_qubits"] and c.gates and c.terms
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} == {
        "request_ms", "request_p95_ms", "peak_mem_gib", "setup_s"}


def test_config_entries_name_their_files():
    b = bench()
    for cfg in b["configs"]:
        with open(os.path.join(smallcopy.ROOT, cfg["file"])) as f:
            data = json.load(f)
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"]
    used = {w["config"] for w in b["workloads"]}
    assert used == {cfg["name"] for cfg in b["configs"]}


def _digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


GENERATOR = """
def gates(config):
    n, out, k = config["num_qubits"], [], 0
    for _ in range(config["layers"]):
        for q in range(n):
            out += [("RX", (q,), k), ("RY", (q,), k + 1)]
            k += 2
        out += [("CZ", (q, q + 1), None) for q in range(n - 1)]
    return out
"""

OBSERVABLE = """
def terms(n, g):
    return ([(g, (("X", q), ("Y", (q + 1) % n))) for q in range(n)]
            + [(1.0, (("Y", q),)) for q in range(n)])
"""

# a request kind: the marginal distribution of two qubits
KIND = """
import numpy as np
from portbench.reference import statevector as ref

NUMBERS = ("marginal_err",)


def answer(system, handle, cell, traffic):
    return handle.get_probabilities(traffic["qubits"])


def compare(cell, traffic, checked):
    worst = 0.0
    for a, state in checked:
        p = ref.probabilities_at(state, np.arange(1 << cell.n))
        x = np.arange(1 << cell.n)
        idx = sum(((x >> q) & 1) << k for k, q in enumerate(traffic["qubits"]))
        want = np.bincount(idx, weights=p, minlength=len(a))
        worst = max(worst, float(np.abs(np.asarray(a) - want).max()))
    return {"marginal_err": worst}
"""


def _write(bench_dir, kind, name, text):
    with open(os.path.join(bench_dir, kind, name + ".py"), "w") as f:
        f.write(text)


def test_new_config_mix_kind_and_metric_are_picked_up(tmp_path):
    """A cell of a new circuit generator, observable (with Y terms),
    configuration, request kind, traffic mix and per-layer metric, each
    added as a file: nothing that was there changes."""
    bench_dir = smallcopy.make(tmp_path)
    before = _digests(bench_dir)
    _write(bench_dir, "circuits", "rx_ry_cz", GENERATOR)
    _write(bench_dir, "observables", "xy_ring", OBSERVABLE)
    _write(bench_dir, "requests", "marginal", KIND)
    _write(bench_dir, "metrics", "requests_read",
           "def read(rec):\n    return rec.requests\n")
    cfg = dict(harness.Cell("ring29_f32.energy", bench_dir).config,
               name="cz13_f32", generator="rx_ry_cz", num_qubits=13,
               layers=2, observable={"name": "xy_ring", "g": 0.7})
    smallcopy.write_json(bench_dir, "configs", "cz13_f32", cfg)
    smallcopy.write_json(bench_dir, "traffic", "energy_narrow", {
        "request": "energy", "angles": {"low": 0.0, "high": 0.5},
        "loop": "closed", "clients": 1, "warmup": 1})
    smallcopy.write_json(bench_dir, "traffic", "marginal01", {
        "request": "marginal", "qubits": [0, 1],
        "angles": {"low": 0.0, "high": 6.0},
        "loop": "closed", "clients": 1, "warmup": 1})
    smallcopy.write_json(bench_dir, "limits", "cz13_f32.energy_narrow",
                         {"energy_err": 1e-5, "state_err": 1e-4})
    smallcopy.write_json(bench_dir, "limits", "cz13_f32.marginal01",
                         {"marginal_err": 1e-5, "state_err": 1e-4})
    for mix in ("energy_narrow", "marginal01"):
        name = "cz13_f32." + mix
        smallcopy.add_cell(bench_dir, name, "cz13_f32", mix,
                           metrics=["requests_read"])
        cell = harness.Cell(name, bench_dir)
        assert cell.n == 13 and ("CZ", (0, 1), None) in cell.gates
        assert ("Y", 3) in cell.terms[-10][1]
        r = harness.run(cell, harness.Devices([torch.device("cpu")]), 77,
                        0.5, True, time.perf_counter())
        assert r["correct"], r["checks"]
        assert set(r["checks"]) == {"state_err", *cell.kind.NUMBERS}
        assert r["metrics"]["requests_read"]["value"] == r["attempted"]
        assert set(r["metrics"]) == {"requests_read"}
    after = _digests(bench_dir)
    assert {p: after[p] for p in before} == before


@pytest.mark.parametrize("loop, clients", [("open", 1), ("closed", 4)])
def test_a_loop_the_harness_does_not_drive_is_refused(tmp_path, loop,
                                                      clients):
    bench_dir = smallcopy.make(tmp_path)
    smallcopy.write_json(bench_dir, "traffic", "other", {
        "request": "energy", "angles": {"low": 0.0, "high": 1.0},
        "loop": loop, "clients": clients, "warmup": 1})
    smallcopy.write_json(bench_dir, "limits", "ring29_f32.other",
                         {"energy_err": 1e-5, "state_err": 1e-4})
    smallcopy.add_cell(bench_dir, "ring29_f32.other", "ring29_f32", "other")
    with pytest.raises(ValueError, match="closed loop of one client"):
        harness.Cell("ring29_f32.other", bench_dir)


@pytest.mark.parametrize("cell, limits", [
    ("ring29_f32.energy", {"state_err": 1e-4}),
    ("ring29_f32.energy", {"energy_err": 1e-6}),
    ("ring26_f32.grad", {"energy_err": 1e-6, "grad_err": 1e-6,
                         "state_err": 1e-4}),
    ("ring26_f32.grad", {"grad_err": 1e-6})])
def test_limits_must_name_the_numbers_compared(tmp_path, cell, limits):
    bench_dir = smallcopy.make(tmp_path)
    smallcopy.write_json(bench_dir, "limits", cell, limits)
    with pytest.raises(ValueError, match="the comparison reads"):
        harness.Cell(cell, bench_dir)


def _is_plain_torch(name):
    reader = harness.Cell("ring29_f32.energy").reader(
        "plain_torch_device_ms")
    return reader.__globals__["is_plain_torch"](name)


@pytest.mark.parametrize("name, plain", [
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<double>"
     " >(at::native::ReduceOp<double>)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)", True),
    ("void at::native::(anonymous namespace)::searchsorted_cuda_kernel<"
     "double, int>(int*, double const*)", True),
    ("void at_cuda_detail::cub::DeviceScanKernel<at_cuda_detail::cub::"
     "DeviceScanPolicy<double, std::plus<double> > >(double const*)", True),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize64x32x8_stage3_"
     "warpsize2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cublas", True),
    ("Memcpy DtoH (Device -> Pinned)", True),
    ("Memset (Device)", True),
    ("void (anonymous namespace)::fused_pass_kernel<false, 7, 256, 1>("
     "float*, float*, (anonymous namespace)::PassParams)", False),
    ("void (anonymous namespace)::pauli_sweep_kernel<float, 1, 4>("
     "(anonymous namespace)::Args)", False),
    ("(anonymous namespace)::init_zero_kernel(float4*, unsigned long)",
     False),
    # a kernel the program has not written yet, templated on ATen's types
    ("void (anonymous namespace)::m_sums_kernel<at::Half>(at::Half "
     "const*, double*)", False),
    ("void rocq::correlation_kernel(float const*, double*)", False)])
def test_plain_torch_is_told_by_the_library_not_by_the_port(name, plain):
    """An operation is PyTorch's or the runtime's by its namespace or
    name; the program's kernels, those it adds later too, are not."""
    assert _is_plain_torch(name) is plain


def test_no_kernel_of_the_port_reads_as_plain_torch():
    """Whatever ``__global__`` functions ``csrc/*.cu`` holds, under the
    names the profiler gives their launches."""
    csrc = os.path.join(smallcopy.ROOT, "rocquantum_tpu_torch", "csrc")
    found = set()
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                found |= set(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                    r"\s*)?(\w+)\s*\(", f.read()))
    assert found
    for k in found:
        for shown in (f"void (anonymous namespace)::{k}<float, 1>(float*)",
                      f"(anonymous namespace)::{k}(float4*, unsigned long)",
                      f"void {k}(double const*, long long, double*)"):
            assert not _is_plain_torch(shown), shown


def test_plain_torch_reader_leaves_out_the_port_kernels():
    tl = trace.Timeline.__new__(trace.Timeline)
    tl.start, tl.end = 1.0, 3.0
    tl.device_ops = {0: [
        ("void (anonymous namespace)::fused_pass_kernel<false, 7>", 1.0, 1.5),
        ("void (anonymous namespace)::pauli_sweep_kernel<float, 1>", 1.5,
         1.6),
        ("void at::native::reduce_kernel<512, 1>", 1.6, 1.85),
        ("Memcpy DtoH (Device -> Pageable)", 1.9, 2.0),
        ("void at::native::vectorized_elementwise_kernel<4>", 2.9, 3.4)]}
    rec = trace.Records({}, {}, [], 5, {}, {}, tl, 1)
    read = harness.Cell("ring29_f32.energy").reader("plain_torch_device_ms")
    assert read(rec) == pytest.approx(1e3 * (0.25 + 0.1 + 0.1) / 5)
    assert read(trace.Records({}, {}, [], 5, {}, {}, None, 1)) is None


# a CPU run of a cell whose per-layer reader loads a module named jax,
# then the result's printing as run.py does it
LATE_IMPORT = """
import io, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {stubs!r})
import torch
from portbench import harness, run
assert not harness.forbidden_modules()
cell = harness.Cell("ring29_f32.energy", {bench!r})
r = harness.run(cell, harness.Devices([torch.device("cpu")]), 5, 0.3, True,
                time.perf_counter())
assert r["correct"] and "jax" in sys.modules
out = io.StringIO()
code = run.finish(r, "cpu", 1, out=out)
sys.stdout.write(out.getvalue())
sys.exit(code)
"""


def test_a_module_of_jax_loaded_after_the_window_prints_no_result(tmp_path):
    bench_dir = smallcopy.make(tmp_path)
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    _write(bench_dir, "metrics", "late_import",
           "def read(rec):\n    import jax  # noqa: F401\n    return 1.0\n")
    smallcopy.add_cell(bench_dir, "ring29_f32.energy", "ring29_f32",
                       "energy")
    path = os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["per_layer"].append({"name": "late_import", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "request_ms",
                           "workloads": ["ring29_f32.energy"]})
    with open(path, "w") as f:
        json.dump(b, f)
    code = LATE_IMPORT.format(root=smallcopy.ROOT, bench=bench_dir,
                              stubs=str(tmp_path / "stubs"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 1, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "['jax']" in out.stderr


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(smallcopy.BENCH, "run.py"),
         "--workload", "ring29_f32.energy", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rocquantum_tpu_torch_like", sys)
    assert "rocquantum_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()
