"""The Qiskit cells, ``qv30_c64.qiskit`` and ``ring29_f32.qiskit``: their
files resolve by name, the ``qiskit`` request kind runs the port's
Qiskit plugin and is correct at sizes a CPU test holds, the control and
every planted fault come out not correct, the dense reference agrees
with an independent numpy one, and the new per-layer readers get their
numbers from a traced window (and none from a program without the
counters and spans they read)."""

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import harness, roofline, roofline_c64, trace  # noqa: E402
from portbench import workload  # noqa: E402
from portbench.reference import dense  # noqa: E402
from portbench.reference import statevector as ref  # noqa: E402

CPU = torch.device("cpu")
CELLS = ["qv30_c64.qiskit", "ring29_f32.qiskit"]
NEW_METRICS = {"dense2q_kernel_share", "fused_c64_roofline", "plan_ms",
               "qiskit_frontend_ms"}
N = 15


def bench():
    with open(os.path.join(smallcopy.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return smallcopy.make(tmp_path_factory.mktemp("qiskit"), num_qubits=N)


def run(bench_dir, cell, seed, traced=False, **kw):
    return harness.run(harness.Cell(cell, bench_dir), harness.Devices([CPU]),
                       seed, 0.5, traced, time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    c = harness.Cell(cell)
    assert c.owns_request and c.traffic["request"] == "qiskit"
    assert c.kind.NUMBERS == ("xeb_dev", "dup_z", "state_err")
    assert set(c.limits) == set(c.kind.NUMBERS)
    assert c.chips == c.config["chips"] == 1
    assert {m["name"] for m in c.end_to_end} == {
        "request_ms", "request_p95_ms", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in c.per_layer}
    assert names == (NEW_METRICS if cell.startswith("qv")
                     else NEW_METRICS - {"dense2q_kernel_share"})
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))


def test_quantum_volume_configuration_is_the_published_square():
    b = bench()
    (entry,) = [cfg for cfg in b["configs"] if cfg["name"] == "qv30_c64"]
    with open(os.path.join(smallcopy.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert entry["reduced"] == cfg["reduced"] == []
    assert cfg["num_qubits"] == cfg["depth"] == 30
    assert entry["source"] in cfg["source"]
    gates = workload.circuit(cfg)
    assert len(gates) == 450 and workload.num_params(gates) == 450
    assert {name for name, *_ in gates} == {"SU4"}
    # the new entries come last in their lists, the old ones untouched
    assert [w["name"] for w in b["workloads"]][-2:] == CELLS
    assert [m["name"] for m in b["per_layer"]][-4:] == [
        "dense2q_kernel_share", "fused_c64_roofline", "plan_ms",
        "qiskit_frontend_ms"]


def test_su4_draws_are_special_unitary_and_fresh():
    a, b = dense.matrix(1.25), dense.matrix(1.25 + 1e-12)
    for u in (a, b):
        assert np.allclose(u @ u.conj().T, np.eye(4), atol=1e-12)
        assert abs(np.linalg.det(u) - 1) < 1e-12
    assert np.array_equal(a, dense.matrix(1.25))
    assert np.abs(a - b).max() > 0.1


def _numpy_dense(psi, u, a, b, n):
    """u on qubits (a, b) of a numpy state, a the low bit: einsum over
    the tensor's axes (axis n - 1 - q is qubit q)."""
    t = psi.reshape([2] * n)
    ut = u.reshape(2, 2, 2, 2)  # [out_b, out_a, in_b, in_a]
    ax_a, ax_b = n - 1 - a, n - 1 - b
    t = np.moveaxis(t, (ax_b, ax_a), (0, 1))
    t = np.einsum("ijkl,kl...->ij...", ut, t)
    return np.moveaxis(t, (0, 1), (ax_b, ax_a)).reshape(-1)


@pytest.mark.parametrize("chunk", [4, dense.CHUNK])
@pytest.mark.parametrize("pair", [(0, 1), (1, 0), (7, 2), (3, 9), (9, 0)])
def test_dense_reference_matches_numpy(pair, chunk, monkeypatch):
    monkeypatch.setattr(dense, "CHUNK", chunk)
    n = 10
    rng = np.random.default_rng(sum(pair) + chunk)
    gates = [("RY", (q,), q) for q in range(n)] + [("SU4", pair, n)]
    theta = rng.uniform(0, 2 * np.pi, n + 1)
    state = dense.simulate(n, gates, theta, torch.float64, [CPU])
    psi = np.zeros(1 << n, complex)
    psi[0] = 1
    for q in range(n):
        c, s = np.cos(theta[q] / 2), np.sin(theta[q] / 2)
        psi = _numpy_dense(psi, np.kron(np.eye(2), [[c, -s], [s, c]]),
                           q, (q + 1) % n, n)
    psi = _numpy_dense(psi, dense.matrix(theta[n]), *pair, n)
    re, im = state.blocks[0]
    assert np.abs(re.numpy() + 1j * im.numpy() - psi).max() < 1e-13


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(small, cell):
    r = run(small, cell, 2**31 + 21)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    ctrl = run(small, cell, 2**31 + 22, system=harness.Control)
    assert not ctrl["correct"]
    assert ctrl["checks"]["state_err"]["value"] > \
        3 * ctrl["checks"]["state_err"]["limit"]


def _faulty(make_circuit):
    """The kind's ``circuit`` replaced by ``make_circuit(kind, cell,
    theta) -> QuantumCircuit``."""
    def plant(kind):
        kind.circuit = lambda cell, theta: make_circuit(kind, cell, theta)
    return plant


def _qv_circuit(kind, cell, theta, gates=None, matrix=None, order=None):
    qc = kind._qiskit().QuantumCircuit(cell.n, cell.n)
    for _, pair, k in gates or cell.gates:
        u = dense.matrix(theta[k])
        qc.unitary(matrix(u) if matrix else u,
                   list(order(pair) if order else pair))
    qc.measure(list(range(cell.n)), list(range(cell.n)))
    return qc


def _from_zero(kind):
    kind.request = lambda system, theta, cell, traffic: {
        "0" * cell.n: traffic["shots"]}


def _previous(kind):
    answer = kind.request
    held = []

    def request(system, theta, cell, traffic):
        held.append(answer(system, theta, cell, traffic))
        return held[-2] if len(held) > 1 else held[-1]
    kind.request = request


FAULTS = {
    "draws_from_zero": _from_zero,
    "transposed": _faulty(lambda k, c, t: _qv_circuit(
        k, c, t, matrix=lambda u: u.T)),
    "pair_swapped": _faulty(lambda k, c, t: _qv_circuit(
        k, c, t, order=lambda p: p[::-1])),
    "half_the_layers": _faulty(lambda k, c, t: _qv_circuit(
        k, c, t, gates=c.gates[:len(c.gates) // 2])),
    "previous_counts": _previous,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_are_not_correct(small, fault):
    c = harness.Cell("qv30_c64.qiskit", small)
    FAULTS[fault](c.kind)
    r = harness.run(c, harness.Devices([CPU]), 2**31 + 31, 0.5, False,
                    time.perf_counter())
    assert not r["correct"], (fault, r["checks"])


def test_traced_window_reads_the_new_spans_and_counters(small):
    from rocquantum_tpu_torch.utils import profiling
    profiling.clear()
    r = run(small, "qv30_c64.qiskit", 2**31 + 41, traced=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    assert got["dense2q_kernel_share"]["value"] == 100.0
    assert got["plan_ms"]["value"] > 0
    assert got["qiskit_frontend_ms"]["value"] > 0
    assert "fused_c64_roofline" not in got  # no device timeline on the CPU
    profiling.clear()
    r = run(small, "ring29_f32.qiskit", 2**31 + 42, traced=True)
    assert r["correct"], r["checks"]
    # the ring's angles never change its plan: no miss, 0 ms
    assert r["metrics"]["plan_ms"]["value"] == 0.0
    assert r["metrics"]["qiskit_frontend_ms"]["value"] > 0
    profiling.clear()


def test_readers_give_nothing_without_the_programs_records(small,
                                                          monkeypatch):
    """A program that keeps none of these counters or spans (the parent
    of this change) gives no number and raises nothing."""
    from rocquantum_tpu_torch.utils import profiling
    c = harness.Cell("qv30_c64.qiskit", small)
    rec = trace.Records(c.config, c.traffic, c.gates, 3, {}, {}, None, 1)
    profiling.clear()
    for name in NEW_METRICS:
        assert c.reader(name)(rec) is None
    run(small, "qv30_c64.qiskit", 2**31 + 51, traced=True)
    monkeypatch.setattr(profiling, "COUNTERS", {"readout_passes": 0})
    assert c.reader("plan_ms")(rec) is None
    monkeypatch.delattr(profiling, "records")
    for name in NEW_METRICS:
        assert c.reader(name)(rec) is None
    monkeypatch.undo()
    profiling.clear()


class _Timeline:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, match):
        return sum(s for name, s in self.seconds.items() if match(name))


def test_c64_roofline_counts_both_planes_and_the_dense_gate():
    n = 30
    qv = [("SU4", (0, 1), 0), ("SU4", (2, 3), 1)]
    assert roofline_c64.circuit_instructions(n, qv) == 32 * (1 << n)
    ring = [("RY", (0,), 0), ("CX", (0, 1), None)]
    assert roofline_c64.circuit_instructions(n, ring) == \
        roofline.gate_ops("U", True, True, False) * (1 << n)
    config = {"num_qubits": n}
    # 10 launches of 2^30 complex amplitudes: 16 GiB each, read and written
    tl = _Timeline({"void fused_pass_dense_kernel<256, 2>(...)": 0.04,
                    "void fused_pass_kernel<true, 5, 256, 2>(...)": 0.01,
                    "void fused_pass_df64_kernel<...>": 5.0,
                    "at::native::copy": 1.0})
    rec = types.SimpleNamespace(config=config, gates=qv, requests=1,
                                counters={"fused_sv": 10}, timeline=tl,
                                chips=1)
    least = 10 * (1 << n) * 4 * 2 * 2 / roofline.HBM_BYTES_PER_S
    assert roofline_c64.share(rec) == pytest.approx(100 * least / 0.05)
    rec.counters = {}
    assert roofline_c64.share(rec) is None
