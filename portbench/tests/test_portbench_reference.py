"""The plain reference agrees with the port's CPU path, and imports
nothing of the program or of JAX."""

import ast
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

import smallcopy

sys.path.insert(0, smallcopy.ROOT)

from portbench import harness, workload  # noqa: E402
from portbench.reference import statevector as ref  # noqa: E402

CPU = torch.device("cpu")


def port_state(n, gates, theta, precision, shards=None):
    """The port's CPU state vector of ``gates`` (through ``Circuit``'s gate
    methods, named as the benchmark names them)."""
    import rocquantum_tpu_torch as rq
    from rocquantum_tpu_torch.parallel import make_mesh
    rq.set_precision(precision)
    try:
        c = rq.Circuit(n, rq.Simulator(seed=1, device="cpu"), device="cpu",
                       mesh=None if shards is None else
                       make_mesh(shards, devices=[CPU] * shards))
        for name, qubits, p in gates:
            angle = () if p is None else (float(theta[p]),)
            getattr(c, name.lower())(*angle, *qubits)
        return c.get_statevector()
    finally:
        rq.set_precision("single")


RING = {"generator": "basic_entangler", "layers": 3, "rotation": "RY"}
SU2 = {"generator": "efficient_su2", "reps": 2, "su2_gates": ["ry", "rz"],
       "entanglement": "circular"}
# every gate the reference knows, on local and on global qubits of 4
# blocks at n = 10 (qubits 8 and 9 are global there)
MIXED = [("H", (9,), None), ("H", (0,), None), ("RX", (8,), 0),
         ("Y", (3,), None), ("S", (9,), None), ("T", (2,), None),
         ("SDG", (5,), None), ("TDG", (8,), None), ("X", (1,), None),
         ("Z", (4,), None), ("RY", (9,), 1), ("RZ", (6,), 2),
         ("CX", (9, 2), None), ("CX", (2, 8), None), ("CX", (8, 9), None),
         ("CZ", (0, 9), None), ("CRX", (9, 3), 3), ("CRY", (1, 8), 4),
         ("CRZ", (7, 0), 5), ("SWAP", (2, 9), None), ("RZZ", (4, 8), 6),
         ("CX", (3, 5), None), ("RX", (0,), 7), ("H", (7,), None)]


def dense_expval(want, n, term):
    phi = want.reshape([2] * n).copy()
    for pauli, q in term:
        ax = n - 1 - q
        if pauli in "XY":
            phi = np.flip(phi, ax)
        if pauli in "YZ":
            # applied after the flip: the sign of the bit P reads
            bit = np.array([1, -1]).reshape([1] * ax + [2] + [1] * (n - 1 - ax))
            phi = phi * (bit if pauli == "Z" else -1j * bit)
    return float(np.vdot(want, phi.reshape(-1)).real)


@pytest.mark.parametrize("circuit, precision, dtype, tol", [
    (RING, "single", torch.float64, 2e-6),
    (RING, "df64", torch.float64, 1e-13),
    (SU2, "single", torch.float64, 2e-6),
    (SU2, "double", torch.float64, 1e-13),
    ("mixed", "double", torch.float64, 1e-13)])
@pytest.mark.parametrize("blocks", [1, 4])
def test_reference_state_matches_the_port(circuit, precision, dtype, tol,
                                          blocks):
    n = 10
    gates = MIXED if circuit == "mixed" else workload.circuit(
        dict(circuit, num_qubits=n))
    theta = np.random.default_rng(5).uniform(0, 2 * math.pi,
                                             workload.num_params(gates) + 8)
    want = port_state(n, gates, theta, precision)
    state = ref.simulate(n, gates, theta, dtype, [CPU] * blocks)
    got = []
    for b in range(blocks):
        re, im = ref.planes(state, b << state.local_bits,
                            1 << state.local_bits)
        got.append(re.numpy() + (0 if im is None else 1j * im.numpy()))
    got = np.concatenate(got)
    assert np.max(np.abs(got - want)) < tol
    p = np.abs(want) ** 2
    idx = np.arange(1 << n)
    assert np.allclose(ref.probabilities_at(state, idx), p, atol=tol)
    for k in (2, 3):
        assert math.isclose(ref.power_sum(state, k), float((p ** k).sum()),
                            rel_tol=10 * tol)
    terms = workload.observable({"num_qubits": n, "observable": {
        "name": "tfim", "j": 1.0, "h": 0.5}})
    want_e = sum(c * dense_expval(want, n, t) for c, t in terms)
    assert abs(ref.energy(state, terms) - want_e) < 50 * tol
    for term in [(("Y", 3),), (("Y", 9),), (("X", 1), ("Y", 8)),
                 (("Y", 0), ("Y", 9)), (("Y", 2), ("Z", 5), ("Y", 6)),
                 (("X", 9), ("Y", 8), ("Z", 0), ("Y", 4)),
                 (("Y", 1), ("Y", 2), ("Y", 3))]:
        assert abs(ref.pauli_term(state, term)
                   - dense_expval(want, n, term)) < 50 * tol, term


def test_reference_sampler_draws_from_the_state():
    n = 6
    gates = workload.circuit(dict(RING, num_qubits=n, layers=2))
    theta = np.random.default_rng(2).uniform(0, 2 * math.pi, 12)
    state = ref.simulate(n, gates, theta, torch.float64, [CPU] * 2)
    gen = torch.Generator().manual_seed(3)
    draws = ref.sample(state, 200000, gen)
    freq = np.bincount(draws, minlength=1 << n) / draws.size
    p = ref.probabilities_at(state, np.arange(1 << n))
    assert np.max(np.abs(freq - p)) < 0.01


@pytest.mark.parametrize("cell", ["ring29_f32.energy", "ring29_f32.shots",
                                  "ring29_df64.energy"])
def test_cells_are_correct_on_the_port_cpu_path(cell, tmp_path):
    bench_dir = smallcopy.make(tmp_path, num_qubits=15)
    r = harness.run(harness.Cell(cell, bench_dir),
                    harness.Devices([CPU]), 2**31 + 11, 0.5, False,
                    time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def test_sharded_cell_is_correct_on_virtual_shards(tmp_path):
    bench_dir = smallcopy.make(tmp_path, num_qubits=10)
    smallcopy.write_json(bench_dir, "limits",
                         "su2ring32_c64_4card.energy",
                         {"energy_err": 1e-5, "state_err": 1e-4})
    smallcopy.add_cell(bench_dir, "su2ring32_c64_4card.energy",
                       "su2ring32_c64_4card", "energy", chips=4,
                       metrics=["exchange_gib"])
    assert harness.Cell("su2ring32_c64_4card.energy", bench_dir).gates[-1] \
        == ("RZ", (9,), 179)  # EfficientSU2's last column, 9 x 2 x 10
    cell = harness.Cell("su2ring32_c64_4card.energy", bench_dir)
    r = harness.run(cell, harness.Devices([CPU] * 4), 9, 0.5, True,
                    time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["metrics"]["exchange_gib"]["value"] > 0


def test_reference_imports_nothing_of_the_program_or_jax():
    folder = os.path.join(smallcopy.BENCH, "reference")
    seen = set()
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                seen |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, "no relative imports"
                if node.module == "portbench.reference":
                    continue  # its own modules
                seen.add(node.module.split(".")[0])
    assert not seen & {"rocquantum_tpu_torch", "rocquantum_tpu", "jax",
                       "jaxlib", "flax", "portbench"}
    assert seen <= {"math", "numpy", "torch"}
