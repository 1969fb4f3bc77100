#!/usr/bin/env python3
"""Profile the PyTorch port (rocquantum_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one CUDA device visible:

    python3 chip_profile.py

Seven measurements, printed between two lines of the card's name and power
limit:

  1. Where the time of one energy request goes: a ring ansatz (8 RY-column
     + CNOT-ring layers) flushed and read out against a transverse-field
     Ising Hamiltonian, once in single precision at n = 29 and once under
     set_precision("df64") at n = 26. After a warm-up request, one request
     runs under torch.profiler: wall time (host clock, ends in a
     synchronize), device busy time (the sum of the kernels' durations; one
     stream, so they do not overlap), the idle share, and the device time
     by top-level operator.
  2. How a fused-layer pass's time grows with its gate count: K RY gates
     per pass (CUDA events over 10 passes), with no pair bits and with
     three (and, on the f32 kernel's real plane, five), on the real and the
     complex carry, for the f32 kernel at n = 29 and the df64 kernel at
     n = 26, beside a device copy of the same planes.
  3. The f32 kernel's two pass geometries on the main path: the n = 29,
     8-layer ring ansatz planned with at most 3 and at most 5 pair bits a
     pass, every pass of each plan run on one real plane (CUDA events, in
     turns 3, 5, 5, 3): passes, ms per pass and ms for all of them; then
     each pass alone, grouped by tile size, exchanges and gates.
  4. The kept plan with its exchanging passes at 32, 64 and 128
     amplitudes a thread.
  5. The df64 kernel's passes on its main path: the n = 26, 8-layer ring
     ansatz on the real carry as the planner plans it, every pass run in
     turn (CUDA events) beside the host's wall time to issue them, the
     host's CPU time per launch without the launch (check, cached
     schedule, parameter block), and each pass alone, grouped by tile size
     and exchanges.
  6. Where the time of one gradient goes: adjoint_grad of the same ansatz
     as a @kernel function against the same Hamiltonian, in single
     precision at n = 29 (8 layers) and under set_precision("df64") at
     n = 26 (2 layers, the exact engine); after a warm-up gradient, one
     runs under torch.profiler, reported as in section 1.
  7. Where the time of one density request goes: DensityCircuit(14) in
     single precision, bench.py:485's workload (2 layers of RY on every
     qubit, then depolarizing(0.02) on every qubit) flushed and read out
     (<Z_q> of every qubit and a TFIM expectation, as chip_smoke.py phase
     12 does); after a warm-up request, one runs under torch.profiler,
     reported as in section 1.

Needs CUDA; without it, exits non-zero and prints nothing else.
"""

import collections
import subprocess
import sys
import time

LAYERS = 8
F32_N = 29
DF64_N = 26
DENSITY_N = 14
SCAN_K = (1, 4, 16, 64)
REPS = 10
# f32 pass planner geometries compared: (reach, max_pairs)
GEOMETRIES = ((10, 3), (10, 5), (7, 5))


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def request(circ, n, theta, hamiltonian):
    """One energy request: queue the ansatz, flush, read the energy."""
    import torch
    circ.reset()
    k = 0
    for _ in range(LAYERS):
        for q in range(n):
            circ.ry(float(theta[k]), q)
            k += 1
        for q in range(n):
            circ.cx(q, (q + 1) % n)
    energy = circ.expval(hamiltonian)
    torch.cuda.synchronize()
    return energy


def _top_level(evt):
    while evt.cpu_parent is not None:
        evt = evt.cpu_parent
    return evt.name


def profile_request(label, rq, n, sim):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    hamiltonian = rq.PauliOperator(
        {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}) + \
        rq.PauliOperator({f"X{q}": -0.5 for q in range(n)})
    theta = np.random.default_rng(100).normal(size=n * LAYERS)
    circ = rq.Circuit(n, sim)
    request(circ, n, theta, hamiltonian)      # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request(circ, n, theta, hamiltonian)
        wall = time.perf_counter() - t0
    report(f"[{label}] one request at n={n}, {LAYERS} layers", label, prof,
           wall)
    del circ
    torch.cuda.empty_cache()


def report(title, label, prof, wall):
    """Wall time, device busy time, idle share, then device time by
    top-level operator and by kernel of one profiled run."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_op = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0:
            top = _top_level(e)
            by_op[top] += e.self_device_time_total
            calls[top] += 1
    by_kernel = collections.Counter()
    for e in kernels:
        by_kernel[e.name[:70]] += e.time_range.elapsed_us()
    print(f"{title}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e3 / (wall * 1e3):.3f}")
    for name, us in by_op.most_common(10):
        print(f"[{label}]   op {name}: {us / 1e3:.1f} ms "
              f"({us / max(busy_us, 1):.1%}), {calls[name]} kernel-bearing "
              f"calls")
    for name, us in by_kernel.most_common(6):
        print(f"[{label}]   kernel {name}: {us / 1e3:.1f} ms")


def ring_kernel(q, *theta):
    """The request's ansatz as a kernel body."""
    n = q.num_qubits
    for layer in range(len(theta) // n):
        for qq in range(n):
            q.ry(theta[layer * n + qq], qq)
        for qq in range(n):
            q.cx(qq, (qq + 1) % n)


def profile_gradient(label, rq, n, layers, sim):
    """Section 6: one warm adjoint_grad of the ring ansatz under
    torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    hamiltonian = rq.PauliOperator(
        {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}) + \
        rq.PauliOperator({f"X{q}": -0.5 for q in range(n)})
    theta = np.random.default_rng(100).normal(size=n * layers)
    ring = rq.kernel(ring_kernel)

    def gradient():
        rq.adjoint_grad(ring, n, sim, theta, hamiltonian)
        torch.cuda.synchronize()

    gradient()  # warm-up: plans
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gradient()
        wall = time.perf_counter() - t0
    report(f"[{label}] one gradient at n={n}, {layers} layers, "
           f"{len(theta)} angles", label, prof, wall)
    torch.cuda.empty_cache()


def profile_density(rq, n, sim):
    """Section 7: one warm f32 density request under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    hamiltonian = rq.PauliOperator(
        {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}) + \
        rq.PauliOperator({f"X{q}": -0.5 for q in range(n)})
    circ = rq.DensityCircuit(n, sim)

    def density_request():
        circ.reset()
        for _ in range(2):
            for q in range(n):
                circ.ry(0.3 + 0.01 * q, q)
            circ.apply_channel("depolarizing", 0.02, list(range(n)))
        for q in range(n):
            circ.expval(rq.PauliOperator(f"Z{q}"))
        circ.expval(hamiltonian)
        torch.cuda.synchronize()

    density_request()  # warm-up: plans
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        density_request()
        wall = time.perf_counter() - t0
    report(f"[density] one request at n={n} (a {2 * n}-bit view), 2 "
           f"layers", "density", prof, wall)
    del circ
    torch.cuda.empty_cache()


def scan(label, n, layer, make_planes, gates, wide=()):
    """ms per pass of ``layer(planes, specs)`` for K gates from
    ``gates(K, pair_bits, complex)`` (RY on the real carry, random unitaries
    on the complex one), beside a device copy of the same planes."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / REPS

    for cplx in (False, True):
        planes = make_planes(cplx)
        carry = "complex" if cplx else "real"
        for pair_bits in ((), (11, 17, 25)) + (() if cplx else wide):
            row = []
            for k in (SCAN_K[::2] if cplx else SCAN_K):
                specs = gates(k, pair_bits, cplx)
                ms = timed(lambda: layer(planes, specs))
                row.append(f"K={k} {ms:.3f}")
            print(f"[{label} scan n={n}] {carry} carry, pairs {pair_bits}: "
                  + ", ".join(row) + " ms")
        src = [p for p in planes if p is not None]
        dst = [torch.empty_like(p) for p in src]

        def copy():
            for d, p in zip(dst, src):
                d.copy_(p)

        print(f"[{label} scan n={n}] device copy of the {carry}-carry "
              f"planes: {timed(copy):.3f} ms")
        del planes, src, dst
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; this "
              "script needs one CUDA GPU", file=sys.stderr)
        return 1
    import numpy as np

    import rocquantum_tpu_torch as rq
    from rocquantum_tpu_torch.ops import df64, fused_df64, fused_sv

    dev = torch.device("cuda")
    print(f"card: {smi_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    sim = rq.Simulator(seed=7, device=dev)

    rq.set_precision("single")
    profile_request("f32", rq, F32_N, sim)
    rq.set_precision("df64")
    profile_request("df64", rq, DF64_N, sim)
    rq.set_precision("single")

    rng = np.random.default_rng(3)

    def gates(k, pair_bits, cplx):
        """(specs, complex 2x2s, real flags, pair bits) of K 1q gates over
        the pass's local set."""
        local = list(range(fused_sv.W_BITS)) + list(pair_bits)
        specs = [("U", local[i % len(local)]) for i in range(k)]
        if cplx:
            mats = [np.linalg.qr(rng.normal(size=(2, 2))
                                 + 1j * rng.normal(size=(2, 2)))[0]
                    for _ in range(k)]
        else:
            mats = [np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
                    for t in rng.normal(size=k)]
        return specs, mats, [not cplx] * k, pair_bits

    def f32_planes(cplx):
        re = torch.full((1 << F32_N,), 2.0 ** (-F32_N / 2), device=dev)
        return re, (torch.zeros_like(re) if cplx else None)

    def f32_layer(planes, g):
        specs, mats, flags, pair_bits = g
        gm = np.stack([np.stack([m.real, m.imag], -1)
                       for m in mats]).astype(np.float32)
        fused_sv.apply_fused_layer(*planes, specs, gm, pair_bits=pair_bits,
                                   real_flags=flags)

    def df64_planes(cplx):
        re = torch.full((1 << DF64_N,), 2.0 ** (-DF64_N / 2),
                        dtype=torch.float64, device=dev)
        return df64.state_from_pair_f64(re, torch.zeros_like(re) if cplx
                                        else None)

    def df64_layer(planes, g):
        specs, mats, flags, pair_bits = g
        fused_df64.apply_fused_layer_df64(
            *planes, specs, fused_df64.pack_gate_mats_df64(mats),
            pair_bits=pair_bits, real_flags=flags)

    scan("f32", F32_N, f32_layer, f32_planes, gates,
         wide=((11, 13, 17, 21, 25),))
    scan("df64", DF64_N, df64_layer, df64_planes, gates)
    compare_geometries(dev)
    compare_exchange_regs(dev)
    df64_plan_passes(dev)
    profile_gradient("f32 gradient", rq, F32_N, LAYERS, sim)
    rq.set_precision("df64")
    profile_gradient("double gradient", rq, DF64_N, 2, sim)
    rq.set_precision("single")
    profile_density(rq, DENSITY_N, sim)
    print(f"card: {smi_line()}")
    return 0


def compare_exchange_regs(dev):
    """Section 4: the kept plan of the n = 29 ansatz with the passes that
    need exchanges run at 32, 64 and 128 amplitudes a thread (the
    ``exchange_reg_bits`` of fused_sv.F32_RULE 5, 6, 7), in turns 5, 6, 7,
    7, 6, 5."""
    import dataclasses

    import numpy as np
    import torch
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir
    from rocquantum_tpu_torch.ops import fused_sv

    n = F32_N
    (block,) = interpreter.plan_items(
        hardware_efficient_ansatz_ir(n, LAYERS).ops, n)
    kinds, supports, gm, flags = interpreter.pallas_block_specs(
        block, np.random.default_rng(5).normal(size=n * LAYERS))
    passes = [(tuple((kinds[i],) + tuple(p)
                     for i, p in zip(item.gate_idx, item.positions)),
               gm[list(item.gate_idx)], item.pair_bits,
               [flags[i] for i in item.gate_idx])
              for item in interpreter.kernel_plan(n, kinds, supports)]
    state = torch.full((1 << n,), 2.0 ** (-n / 2), device=dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    kept = fused_sv.F32_RULE
    times = {}
    try:
        for regs in (5, 6, 7, 7, 6, 5):
            fused_sv.F32_RULE = dataclasses.replace(kept,
                                                    exchange_reg_bits=regs)
            for specs, g, pb, fl in passes:  # warm-up
                fused_sv.apply_fused_layer(state, None, specs, g,
                                           pair_bits=pb, real_flags=fl)
            torch.cuda.synchronize()
            start.record()
            for specs, g, pb, fl in passes:
                fused_sv.apply_fused_layer(state, None, specs, g,
                                           pair_bits=pb, real_flags=fl)
            stop.record()
            torch.cuda.synchronize()
            times.setdefault(regs, []).append(start.elapsed_time(stop))
    finally:
        fused_sv.F32_RULE = kept
    for regs, ts in sorted(times.items()):
        print(f"[f32 exchanges n={n}] {len(passes)} passes, those with "
              f"exchanges at {1 << regs} amplitudes a thread: all passes "
              f"{', '.join(f'{t:.3f}' for t in ts)} ms")
    del state
    torch.cuda.empty_cache()


def df64_plan_passes(dev):
    """Section 5: the n = 26 ansatz's df64 plan (the planner's geometry) on
    one real carry: every pass run in turn, device time (CUDA events) beside
    the host's wall time to issue them; the host's part of each launch
    alone (check, schedule, parameter block); then each pass alone, grouped
    by tile size and exchanges."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir
    from rocquantum_tpu_torch.ops import df64, fused_df64

    n = DF64_N
    (block,) = interpreter.plan_items(
        hardware_efficient_ansatz_ir(n, LAYERS).ops, n)
    kinds, supports, gm, flags = interpreter.pallas_block_specs_df64(
        block, np.random.default_rng(5).normal(size=n * LAYERS))
    plan = interpreter.kernel_plan(n, kinds, supports, fused_df64)
    passes = [(tuple((kinds[i],) + tuple(p)
                     for i, p in zip(item.gate_idx, item.positions)),
               gm[list(item.gate_idx)], item.pair_bits,
               [flags[i] for i in item.gate_idx]) for item in plan]
    re = torch.full((1 << n,), 2.0 ** (-n / 2), dtype=torch.float64,
                    device=dev)
    planes = df64.state_from_pair_f64(re, None)
    del re
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def run_all(passes):
        for specs, g, pb, fl in passes:
            fused_df64.apply_fused_layer_df64(*planes, specs, g, pair_bits=pb,
                                              real_flags=fl)

    def prepare_all():
        count = 0
        for specs, g, pb, fl in passes:
            m, sp, _, rf = fused_df64._check_layer(planes, specs, g, pb, fl)
            for launch in fused_df64.pass_schedule(m, sp, False):
                fused_df64.launch_params(m, launch, g, rf)
                count += 1
        return count

    run_all(passes)  # warm-up (and the schedules' cache)
    torch.cuda.synchronize()
    launches = prepare_all()
    for _ in range(3):
        t0 = time.perf_counter()
        start.record()
        run_all(passes)
        stop.record()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        print(f"[df64 plan n={n}] {len(passes)} passes ({launches} launches, "
              f"{len(passes) / LAYERS:.3f} per layer): device "
              f"{start.elapsed_time(stop):.3f} ms, host wall to issue them "
              f"{issued * 1e3:.3f} ms")
    t0 = time.process_time()
    reps = 20
    for _ in range(reps):
        prepare_all()
    host = (time.process_time() - t0) / (reps * launches)
    print(f"[df64 plan n={n}] host CPU time per launch to check, schedule "
          f"(cached) and pack its parameter block, no launch: "
          f"{host * 1e3:.4f} ms")
    groups = {}
    for specs, g, pb, fl in passes:
        (launch, *more) = fused_df64.pass_schedule(
            n, fused_df64._normalize_specs(specs), False)
        one = [(specs, g, pb, fl)]
        run_all(one)
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            run_all(one)
        stop.record()
        torch.cuda.synchronize()
        key = (launch.tile_bits, launch.swaps, len(more))
        groups.setdefault(key, []).append(
            (start.elapsed_time(stop) / 3,
             sum(sp[0] in ("U", "CU") for sp in specs)))
    for (t, swaps, extra), rows in sorted(groups.items()):
        total = sum(ms for ms, _ in rows)
        real = sum(k for _, k in rows) / len(rows)
        print(f"[df64 plan n={n}]   {len(rows)} passes of {1 << t} "
              f"amplitudes a tile, {swaps} exchanges, {extra + 1} "
              f"launch(es), {real:.1f} RY: {total / len(rows):.4f} ms each, "
              f"{total:.3f} ms in all")
    del planes
    torch.cuda.empty_cache()


def compare_geometries(dev):
    """Section 3: the n = 29 ansatz's passes planned with 3 and with 5 pair
    bits a pass, each plan run whole on one real plane."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.models import hardware_efficient_ansatz_ir
    from rocquantum_tpu_torch.ops import fused_sv

    n = F32_N
    (block,) = interpreter.plan_items(
        hardware_efficient_ansatz_ir(n, LAYERS).ops, n)
    kinds, supports, gm, flags = interpreter.pallas_block_specs(
        block, np.random.default_rng(5).normal(size=n * LAYERS))
    runs = {}
    for geometry in GEOMETRIES:
        plan = interpreter._block_plan(n, tuple(kinds),
                                       tuple(tuple(s) for s in supports),
                                       *geometry, fused_sv.window_bits(n))
        runs[geometry] = [(tuple((kinds[i],) + tuple(p)
                              for i, p in zip(item.gate_idx, item.positions)),
                        gm[list(item.gate_idx)], item.pair_bits,
                        [flags[i] for i in item.gate_idx]) for item in plan]
    state = torch.full((1 << n,), 2.0 ** (-n / 2), device=dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def run_all(passes):
        for specs, g, pb, fl in passes:
            fused_sv.apply_fused_layer(state, None, specs, g, pair_bits=pb,
                                       real_flags=fl)

    times = {geometry: [] for geometry in GEOMETRIES}
    for geometry in GEOMETRIES + GEOMETRIES[::-1]:
        run_all(runs[geometry])  # warm-up (and the schedules' host cache)
        torch.cuda.synchronize()
        start.record()
        run_all(runs[geometry])
        stop.record()
        torch.cuda.synchronize()
        times[geometry].append(start.elapsed_time(stop))
    for geometry in GEOMETRIES:
        reach, pairs = geometry
        count = len(runs[geometry])
        best = min(times[geometry])
        print(f"[f32 geometry n={n}] reach {reach}, at most {pairs} pair "
              f"bits: {count} passes ({count / LAYERS:.3f} per layer), all "
              f"passes {', '.join(f'{t:.3f}' for t in times[geometry])} ms, "
              f"{best / count:.4f} ms per pass")
        # every pass alone, grouped by its launch's shape
        groups = {}
        for specs, g, pb, fl in runs[geometry]:
            (launch, *more) = fused_sv.pass_schedule(
                n, fused_sv._normalize_specs(specs))
            key = (launch.tile_bits, launch.reg_bits, launch.swaps,
                   len(more))
            one = [(specs, g, pb, fl)]
            run_all(one)
            torch.cuda.synchronize()
            start.record()
            for _ in range(3):
                run_all(one)
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / 3
            groups.setdefault(key, []).append((ms, len(specs)))
        for (t, r, swaps, extra), rows in sorted(groups.items()):
            total = sum(ms for ms, _ in rows)
            gates = sum(k for _, k in rows) / len(rows)
            print(f"[f32 geometry n={n}]   ({reach}, {pairs}): {len(rows)} "
                  f"passes "
                  f"of {1 << t} amplitudes a tile, {1 << r} a thread, "
                  f"{swaps} exchanges, {extra + 1} launch(es), "
                  f"{gates:.1f} gates: {total / len(rows):.4f} ms each, "
                  f"{total:.3f} ms in all")
    del state
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
