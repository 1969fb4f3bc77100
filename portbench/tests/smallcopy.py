"""A copy of the benchmark's folder and BENCHMARK.json in a temporary
directory, its configurations cut to sizes a CPU test holds."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def make(tmp, num_qubits=15):
    """``<tmp>/portbench`` (without the tests) beside ``<tmp>/
    BENCHMARK.json``; every configuration cut to ``num_qubits``. Returns
    the copy's benchmark folder."""
    dst = os.path.join(str(tmp), "portbench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp))
    for name in os.listdir(os.path.join(dst, "configs")):
        path = os.path.join(dst, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["num_qubits"] = num_qubits
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dst


def add_cell(bench_dir, name, config, traffic, chips=1, metrics=()):
    """Add a workload to the copy's BENCHMARK.json, unless it is there,
    and ``metrics`` (names of readers under metrics/) to its per-layer
    list for that cell."""
    path = os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    if any(w["name"] == name for w in bench["workloads"]):
        return
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": chips,
                               "why": "a test cell"})
    for m in metrics:
        bench["per_layer"].append({
            "name": m, "unit": "1", "better": "higher", "source":
            "program_counter", "layer": "test", "moves": "request_ms",
            "workloads": [name]})
    with open(path, "w") as f:
        json.dump(bench, f)


def write_json(bench_dir, kind, name, obj):
    with open(os.path.join(bench_dir, kind, name + ".json"), "w") as f:
        json.dump(obj, f)
