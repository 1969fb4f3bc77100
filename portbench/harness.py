"""One run of one cell: set-up, the measured window, the per-layer
readers, and the comparison with the plain reference that decides
``correct``.

Everything a cell is comes from files found by name: the cell in
``BENCHMARK.json``; its configuration and traffic mix under ``configs/``
and ``traffic/``; the configuration's circuit generator and observable
under ``circuits/`` and ``observables/``; the mix's request kind, with
its part of the comparison, under ``requests/``; the cell's limits under
``limits/``; each per-layer metric's reader under ``metrics/``. Adding a
cell adds files and touches none.

A request kind either reads a state the engine made: ``answer(system,
handle, cell, traffic)`` after ``engine(theta)``, and ``compare(cell,
traffic, checked)`` over ``(answer, reference state)`` pairs, with the
last request's state held to the reference as ``state_err``. Or it owns
its whole request: ``request(system, theta, cell, traffic) -> answer``
through a method the program and the control both have (``gradient``),
and ``compare(cell, traffic, checked, dtype, devices)`` over ``(answer,
theta)`` pairs, working its reference out itself in ``dtype`` on
``devices``; no state is held and no ``state_err`` is read.
"""

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import trace, workload
from portbench.reference import adjoint
from portbench.reference import statevector as ref

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "rocquantum_tpu")
GIB = float(1 << 30)
SLICE_BITS = 24  # amplitudes compared per read-back of the held state

# precision named in a configuration -> (the program's setting, the
# reference's dtype name, the control's: the nearest precision below)
PRECISIONS = {"f32": ("single", "float64", "bfloat16"),
              "c64": ("single", "float64", "bfloat16"),
              "df64": ("df64", "float64", "float32")}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files, read from
    ``bench_dir`` (the benchmark's folder; BENCHMARK.json lies beside
    it)."""

    def __init__(self, name, bench_dir=HERE):
        root = os.path.dirname(bench_dir)
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        found = [w for w in bench["workloads"] if w["name"] == name]
        if len(found) != 1:
            raise ValueError(f"BENCHMARK.json has {len(found)} workloads "
                             f"named {name!r}")
        self.entry = found[0]
        self.name = name
        self.bench_dir = bench_dir
        self.chips = self.entry["chips"]
        self.config = workload.load_json("configs", self.entry["config"],
                                         bench_dir)
        self.traffic = workload.load_json("traffic", self.entry["traffic"],
                                          bench_dir)
        loop = (self.traffic["loop"], self.traffic["clients"])
        if loop != ("closed", 1):
            raise ValueError(f"{name}: the harness drives a closed loop of "
                             f"one client, not {loop}")
        self.kind = workload.load_module("requests",
                                         self.traffic["request"], bench_dir)
        self.owns_request = hasattr(self.kind, "request")
        self.limits = workload.load_json("limits", name, bench_dir)
        want = set(self.kind.NUMBERS) | (
            set() if self.owns_request else {"state_err"})
        if set(self.limits) != want:
            raise ValueError(f"{name}: limits for {sorted(self.limits)}, "
                             f"the comparison reads {sorted(want)}")
        applies = lambda m: name in m.get("workloads", [name])  # noqa: E731
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]
        self.gates = workload.circuit(self.config, bench_dir)
        self.terms = workload.observable(self.config, bench_dir)
        self.n = self.config["num_qubits"]

    def reader(self, metric):
        return workload.load_module("metrics", metric, self.bench_dir).read


class Devices:
    """The cards a cell uses, or CPU devices standing in for them in
    tests."""

    def __init__(self, devices):
        self.list = devices
        self.cuda = devices[0].type == "cuda"

    def sync(self):
        if self.cuda:
            for d in self.list:
                torch.cuda.synchronize(d)

    def reset_peak(self):
        if self.cuda:
            for d in self.list:
                torch.cuda.reset_peak_memory_stats(d)

    def peak(self):
        if not self.cuda:
            return 0
        return max(torch.cuda.max_memory_allocated(d) for d in self.list)

    def free(self):
        if self.cuda:
            torch.cuda.empty_cache()


class Program:
    """The system under test: the port's ``compile_program`` of the cell's
    circuit, each request ``run(theta)`` and then the request kind's
    readout (``expval``, ``sample``) on the handle it returns; or, for a
    kind that owns its request, the port's ``adjoint_grad`` on the kernel
    it traces (``gradient``), with no program compiled."""

    def __init__(self, cell, devices, theta0, seed):
        import rocquantum_tpu_torch as rq
        from rocquantum_tpu_torch.ops import fused_df64, fused_sv
        from rocquantum_tpu_torch.parallel import default_mesh, make_mesh
        from rocquantum_tpu_torch.parallel import sharded
        self.rq, self.fused_sv, self.fused_df64 = rq, fused_sv, fused_df64
        self.sharded = sharded
        cfg = cell.config
        rq.set_precision(PRECISIONS[cfg["precision"]][0])
        gates = cell.gates

        def kernel(q, *theta):
            for name, qubits, param in gates:
                angle = () if param is None else (theta[param],)
                getattr(q, name.lower())(*angle, *qubits)

        mesh = None
        if cfg.get("mesh"):
            mesh = (default_mesh() if devices.cuda
                    else make_mesh(len(devices.list), devices=devices.list))
        self.kernel, self.n = kernel, cell.n
        self.sim = rq.Simulator(seed=seed & (2**63 - 1),
                                device=devices.list[0])
        if not cell.owns_request:
            ir = rq.trace_kernel(kernel, cell.n, *theta0)
            self.prog = rq.compile_program(ir, self.sim, mesh=mesh)
        self.operators = {}

    def operator(self, terms):
        """The port's ``PauliOperator`` of ``terms``, built once."""
        key = tuple(terms)
        if key not in self.operators:
            op = self.rq.PauliOperator()
            for coeff, term in terms:
                op = op + self.rq.PauliOperator(
                    {" ".join(f"{p}{q}" for p, q in term): coeff})
            self.operators[key] = op
        return self.operators[key]

    def engine(self, theta):
        return self.prog.run(theta)

    def expval(self, handle, terms):
        return handle.expval(self.operator(terms))

    def sample(self, handle, qubits, shots):
        return handle.sample(qubits, shots)

    def gradient(self, theta, terms):
        """``(energy, dE/dtheta)`` by the port's public adjoint gradient."""
        return self.rq.adjoint_grad(self.kernel, self.n, self.sim,
                                    theta, self.operator(terms),
                                    return_value=True)

    def counters(self):
        return {"fused_sv": self.fused_sv.LAUNCHES,
                "fused_sv_fresh": self.fused_sv.INIT_LAUNCHES,
                "fused_df64": self.fused_df64.LAUNCHES,
                "bytes_moved": self.sharded.BYTES_MOVED}

    def read_back(self, handle, start, size):
        """``(re, im)`` of amplitudes ``[start, start + size)`` on the
        device: views of the public ``Circuit.state`` planes once a
        one-amplitude ``get_statevector_slice`` has brought the state to
        its logical order, or ``sharded.gather_slice`` of a sharded one."""
        handle.get_statevector_slice(start, 1)
        state = handle.state
        if isinstance(state, tuple):
            return tuple(None if p is None else p[start:start + size]
                         for p in state)
        (plane,) = self.sharded.gather_slice(state, start, size)
        return plane.real, plane.imag


class Control:
    """The reference in the program's place, in the precision below the
    configuration's: the comparison has to find it not correct."""

    def __init__(self, cell, devices, theta0, seed):
        self.cell = cell
        self.devices = devices
        self.dtype = getattr(torch, PRECISIONS[cell.config["precision"]][2])
        self.gen = torch.Generator(device=devices.list[0])
        self.gen.manual_seed(seed & (2**63 - 1))

    def engine(self, theta):
        return ref.simulate(self.cell.n, self.cell.gates, theta, self.dtype,
                            self.devices.list)

    def expval(self, state, terms):
        return ref.energy(state, terms)

    def sample(self, state, qubits, shots):
        x = ref.sample(state, shots, self.gen)
        return sum(((x >> q) & 1) << k for k, q in enumerate(qubits))

    def gradient(self, theta, terms):
        return adjoint.gradient(self.cell.n, self.cell.gates, theta, terms,
                                self.dtype, self.devices.list)

    def counters(self):
        return {}

    @staticmethod
    def read_back(state, start, size):
        return ref.planes(state, start, size)


def make_request(sut, cell, spans):
    """``request(theta) -> (answer, handle)``: the engine, then the mix's
    request kind; or the kind's own ``request``, which holds no handle."""
    if cell.owns_request:
        return lambda theta: (cell.kind.request(sut, theta, cell,
                                                cell.traffic), None)
    answer = cell.kind.answer

    def request(theta):
        with spans.span("engine"):
            handle = sut.engine(theta)
        with spans.span("readout"):
            out = answer(sut, handle, cell, cell.traffic)
        return out, handle
    return request


def judge(cell, devices, thetas, answers, handle, read_back, seed, failed):
    """The comparison: the checked requests' answers (by the request
    kind's ``compare``) and, unless the kind owns its request, the held
    state of the last one against the reference in float64. Returns
    (correct, {number: (value, limit)})."""
    ref.full_precision()
    dtype = getattr(torch, PRECISIONS[cell.config["precision"]][1])
    picked = workload.checked_requests(len(answers), cell.config, seed)
    state_err = []

    def angles():
        for i in picked:
            yield answers[i], thetas[i]
            devices.free()

    def checked():
        for i in picked:
            state = ref.simulate(cell.n, cell.gates, thetas[i], dtype,
                                 devices.list)
            yield answers[i], state
            if i == len(answers) - 1:
                state_err.append(_state_error(cell.n, state, handle,
                                              read_back))
            del state
            devices.free()

    if cell.owns_request:
        checks = dict(cell.kind.compare(cell, cell.traffic, angles(), dtype,
                                        devices.list))
    else:
        checks = dict(cell.kind.compare(cell, cell.traffic, checked()))
        checks["state_err"] = state_err[0] if state_err else np.inf
    out = {k: (float(checks.get(k, np.inf)), float(lim))
           for k, lim in cell.limits.items()}
    correct = (failed == 0 and bool(answers)
               and all(v <= lim for v, lim in out.values()))
    return correct, out


def _state_error(n, state, handle, read_back):
    """max |psi - psi_ref| / max |psi_ref| over the whole state, compared
    slice by slice in float64 on the reference's device."""
    size = 1 << min(SLICE_BITS, state.local_bits)
    worst = top = 0.0
    for start in range(0, 1 << n, size):
        want = ref.planes(state, start, size)
        dev = want[0].device
        got = [None if p is None else p.to(dev).double()
               for p in read_back(handle, start, size)]
        err2 = mag2 = 0
        for g, w in zip(got, want):
            w = None if w is None else w.double()
            d = g if w is None else w if g is None else g - w
            if d is not None:
                err2 = err2 + d * d
            if w is not None:
                mag2 = mag2 + w * w
        worst = max(worst, float(err2.max()) ** 0.5)
        top = max(top, float(mag2.max()) ** 0.5)
    return worst / top if top else np.inf


def run(cell, devices, seed, seconds, traced, t_start, system=None,
        log=print):
    """One run of ``cell`` against ``system(cell, devices, theta0, seed)``
    (:class:`Program` unless given: :class:`Control`, or a test's fault):
    returns the result's dict (without the contract's ``device`` key,
    which the caller adds)."""
    traffic = cell.traffic
    count = workload.num_params(cell.gates)
    warm = workload.Angles(traffic, count, seed, stream=1)
    angles = workload.Angles(traffic, count, seed)
    t_enter = time.perf_counter()
    sut = (system or Program)(cell, devices, warm.next(), seed)
    spans = trace.Spans(traced, devices.sync)
    request = make_request(sut, cell, spans)
    devices.sync()
    t_sut = time.perf_counter()
    warm_s = []
    for _ in range(traffic["warmup"]):
        request(warm.next())
        devices.sync()
        warm_s.append(time.perf_counter() - (t_sut + sum(warm_s)))
    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded after set-up: {found}")
    setup_peak = devices.peak()
    devices.reset_peak()
    spans.seconds.clear()
    before = sut.counters()
    prof = trace.profiler(devices.cuda) if traced else None
    if prof is not None:
        prof.start()
    setup_s = time.perf_counter() - t_start
    log(f"set-up seconds: to the harness {t_enter - t_start:.2f}, program "
        f"and plan {t_sut - t_enter:.2f}, warm-up requests "
        + ", ".join(f"{w:.2f}" for w in warm_s), file=sys.stderr)

    thetas, answers, latencies, failed, attempted = [], [], [], 0, 0
    handle = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    window_end = t0
    with (torch.profiler.record_function(trace.WINDOW) if traced
          else contextlib.nullcontext()):
        while not (attempted and time.perf_counter() >= deadline):
            theta = angles.next()
            attempted += 1
            ta = time.perf_counter()
            try:
                answer, handle = request(theta)
            except Exception as exc:  # a request that fails is counted
                failed += 1
                log(f"request {attempted} failed: {exc!r}", file=sys.stderr)
                continue
            window_end = time.perf_counter()
            latencies.append(window_end - ta)
            thetas.append(theta)
            answers.append(answer)
        devices.sync()
    if prof is not None:
        prof.stop()
    window_s = window_end - t0
    after = sut.counters()
    peak = devices.peak()
    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded once the window closed: {found}")

    result = {"attempted": attempted, "failed": failed}
    memory_peak = max(setup_peak, peak)
    completed = len(answers)
    if traced:
        timeline = (trace.Timeline(prof, len(devices.list))
                    if devices.cuda else None)
        recs = trace.Records(
            cell.config, traffic, cell.gates, completed,
            dict(spans.seconds),
            {k: after[k] - before[k] for k in after}, timeline, cell.chips)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(recs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        result["metrics"] = metrics
        if timeline is not None:
            result["busy_s"] = timeline.busy_s()
            result["window_s"] = timeline.window_s
            result["breakdown"] = timeline.breakdown()
        del prof
    else:
        e2e = {"request_ms": 1e3 * window_s / max(completed, 1),
               "request_p95_ms": 1e3 * float(np.percentile(latencies, 95))
               if latencies else float("nan"),
               "peak_mem_gib": peak / GIB,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["memory_peak_bytes"] = memory_peak

    del request
    t_judge = time.perf_counter()
    correct, checks = judge(cell, devices, thetas, answers, handle,
                            sut.read_back, seed, failed)
    log(f"seconds: set-up {setup_s:.2f}, window {window_s:.2f}, after the "
        f"window {t_judge - t0 - window_s:.2f}, comparison "
        f"{time.perf_counter() - t_judge:.2f}", file=sys.stderr)
    result["correct"] = correct
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
