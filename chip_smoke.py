#!/usr/bin/env python3
"""Drive the PyTorch port (rocquantum_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with one CUDA device visible:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions
     and which gate-pass planner runs;
  2. build the fused-layer kernel (csrc/fused_sv.cu) from the checkout;
  3. kernel against its plain-torch version on the card: seeded random
     passes at n = 22 over every gate kind, {no pair bits, one, three},
     {real plane, complex} and the start-from-|0...0> mode, then every pass
     of one ansatz layer at n = 29 (the main path's shapes), timed;
  4. the slice: Circuit(29) with 8 RY-column + CNOT-ring layers answering
     3 energy requests (transverse-field Ising Hamiltonian), held against
     the same requests run with the plain layer function; QFT of a basis
     state at n = 26 against its closed form; GHZ at n = 29, sampled;
  5. times: kernel and plain ms per pass, passes per layer, gates/s.

Prints a kernels JSON line, the nvidia-smi line and, last, the
{"ok": true, "device": ...} line. Any failed check raises (non-zero exit,
no result line); so does a machine without CUDA.
"""

import contextlib
import json
import subprocess
import sys
import time

ANSATZ_N = 29
ANSATZ_LAYERS = 8
REQUESTS = 3
QFT_N = 26
GHZ_N = 29
GHZ_SHOTS = 4096
RANDOM_N = 22
KERNEL_TOL = 1e-5     # max abs amplitude error, kernel vs plain (f32)
ENERGY_RTOL = 1e-4
NORM_TOL = 1e-4
QFT_ATOL = 2e-6


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_specs(rng, n, w, pair_bits, k, real):
    """k random gate specs legal for a pass with local set
    {0..w-1} | pair_bits: every kind, free controls and free D2 bits."""
    import numpy as np

    local = list(range(w)) + list(pair_bits)
    specs, mats = [], []
    for i in range(k):
        kind = ("U", "CNOT", "CU", "D2")[i % 4]
        if kind == "U":
            specs.append(("U", int(rng.choice(local))))
        elif kind in ("CNOT", "CU"):
            t = int(rng.choice(local))
            c = int(rng.choice([q for q in range(n) if q != t]))
            specs.append((kind, c, t))
        else:
            a, b = (int(q) for q in rng.integers(0, n, 2))
            specs.append(("D2", a, b))
        if real:
            th = rng.normal()
            m = np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
            if kind == "D2":
                m = rng.choice([-1.0, 1.0], (2, 2)) * rng.uniform(0.5, 1, (2, 2))
        else:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            m, _ = np.linalg.qr(z)
            if kind == "D2":
                m = np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 2)))
        mats.append(np.stack([m.real, m.imag], -1).astype(np.float32))
    return specs, np.stack(mats)


def max_err(a, b):
    if a is None:
        return 0.0
    return float((a - b).abs().max())


@contextlib.contextmanager
def plain_layers(fused_sv):
    """Route the slice's passes through the plain-torch layer function."""
    kernel_fn = fused_sv.apply_fused_layer
    fused_sv.apply_fused_layer = fused_sv.apply_fused_layer_reference
    try:
        yield
    finally:
        fused_sv.apply_fused_layer = kernel_fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    import numpy as np

    import rocquantum_tpu_torch as rq
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.compiler.passes import PallasBlock
    from rocquantum_tpu_torch.models import (ghz_ir,
                                             hardware_efficient_ansatz_ir,
                                             qft_ir)
    from rocquantum_tpu_torch.ops import _build, _native_planner, fused_sv
    from rocquantum_tpu_torch.ops import pairsim

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card, versions, planner -------------------------------------
    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}")
    print(f"planner: {_native_planner.planner_name()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    fused_sv.build()
    print(f"build: fused_sv.cu in {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOGS.get("fused_sv", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain ---------------------------------------------
    rng = np.random.default_rng(2026)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    worst = 0.0
    n = RANDOM_N
    w = fused_sv.window_bits(n)
    for pair_bits in ((), (15,), (11, 17, 21)):
        for mode in ("real", "complex", "zero"):
            specs, gm = random_specs(rng, n, w, pair_bits, 48,
                                     real=mode != "complex")
            flags = [mode != "complex"] * len(specs)
            if mode == "zero":
                re = im = None
            else:
                re = torch.randn(1 << n, generator=gen, device=dev)
                im = None if mode == "real" else \
                    torch.randn(1 << n, generator=gen, device=dev)
                scale = float(pairsim.norm2_pair(re, im)) ** -0.5
                re *= scale
                if im is not None:
                    im *= scale
            ref = fused_sv.apply_fused_layer_reference(
                re, im, specs, gm, real_flags=flags, num_qubits=n,
                device=dev)
            got = fused_sv.apply_fused_layer(
                None if re is None else re.clone(),
                None if im is None else im.clone(), specs, gm,
                pair_bits=pair_bits, real_flags=flags, num_qubits=n,
                device=dev)
            torch.cuda.synchronize()
            err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
            worst = max(worst, err)
            print(f"kernel vs plain n={n} pairs={pair_bits} {mode}: "
                  f"max abs err {err:.3e}")
            check(err <= KERNEL_TOL, f"n={n} {pair_bits} {mode}: {err}")

    # one ansatz layer at the main path's shape, pass by pass
    n = ANSATZ_N
    layer = hardware_efficient_ansatz_ir(n, 1)
    (block,) = interpreter.plan_items(layer.ops, n)
    check(isinstance(block, PallasBlock), "ansatz layer is one kernel block")
    params = rng.normal(size=n).astype(np.float32)
    kinds, supports, gm, flags = interpreter.pallas_block_specs(
        block, interpreter._host_params(params))
    plan = interpreter._block_plan(n, tuple(kinds), tuple(supports))
    passes = [(tuple((kinds[i],) + tuple(p)
                     for i, p in zip(item.gate_idx, item.positions)),
               gm[list(item.gate_idx)], item.pair_bits,
               [flags[i] for i in item.gate_idx]) for item in plan]
    state = torch.randn(1 << n, generator=gen, device=dev)
    state /= torch.linalg.vector_norm(state)
    for specs, g, pb, fl in passes:
        ref, _ = fused_sv.apply_fused_layer_reference(
            state, None, specs, g, real_flags=fl)
        got, _ = fused_sv.apply_fused_layer(state.clone(), None, specs, g,
                                            pair_bits=pb, real_flags=fl)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        worst = max(worst, err)
        check(err <= KERNEL_TOL, f"n={n} pass {pb}: {err}")
        del ref, got
    print(f"kernel vs plain n={n}: {len(passes)} ansatz-layer passes, "
          f"max abs err {worst:.3e}")

    def time_passes(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        x = state.clone()
        for specs, g, pb, fl in passes:  # warm-up
            x, _ = fn(x, None, specs, g, pair_bits=pb, real_flags=fl)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            for specs, g, pb, fl in passes:
                x, _ = fn(x, None, specs, g, pair_bits=pb, real_flags=fl)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (reps * len(passes))

    plain_ms = time_passes(fused_sv.apply_fused_layer_reference, 1)
    kernel_ms = time_passes(fused_sv.apply_fused_layer, 10)
    kernel_ms_2 = time_passes(fused_sv.apply_fused_layer, 10)
    plain_ms_2 = time_passes(fused_sv.apply_fused_layer_reference, 1)
    del state
    torch.cuda.empty_cache()

    # ---- 4. slice -------------------------------------------------------
    n = ANSATZ_N
    zz = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    hamiltonian = rq.PauliOperator(zz) + rq.PauliOperator(
        {f"X{q}": -0.5 for q in range(n)})
    requests = [np.random.default_rng(100 + r).normal(
        size=n * ANSATZ_LAYERS).astype(np.float32) for r in range(REQUESTS)]
    sim = rq.Simulator(seed=7, device=dev)
    circ = rq.Circuit(n, sim)

    def answer(theta):
        circ.reset()
        k = 0
        for _ in range(ANSATZ_LAYERS):
            for q in range(n):
                circ.ry(float(theta[k]), q)
                k += 1
            for q in range(n):
                circ.cx(q, (q + 1) % n)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        circ.flush()
        torch.cuda.synchronize()
        t_flush = time.perf_counter() - t_start
        energy = circ.expval(hamiltonian)
        norm = float(pairsim.norm2_pair(*circ.state))
        check(circ.state[1] is None, "ansatz state stays real")
        return energy, norm, t_flush

    fused_sv.LAUNCHES = 0
    answers = [answer(theta) for theta in requests]
    launches = fused_sv.LAUNCHES
    with plain_layers(fused_sv):
        plain_answers = [answer(theta) for theta in requests]
    check(fused_sv.LAUNCHES == launches, "plain run launched no kernel")
    check(launches > 0, "the slice launched the fused kernel")
    gates = ANSATZ_LAYERS * 2 * n
    for r, ((e, nrm, t), (e_ref, nrm_ref, t_ref)) in enumerate(
            zip(answers, plain_answers)):
        rel = abs(e - e_ref) / max(abs(e_ref), 1e-30)
        print(f"request {r}: energy {e:.7f} (plain {e_ref:.7f}, rel diff "
              f"{rel:.2e}), norm {nrm:.7f}, flush {t * 1e3:.2f} ms = "
              f"{gates / t:.1f} gates/s (plain layers {t_ref * 1e3:.1f} ms)")
        check(np.isfinite(e) and rel <= ENERGY_RTOL, f"energy {e} vs {e_ref}")
        check(abs(nrm - 1.0) <= NORM_TOL, f"norm {nrm}")
    del circ
    torch.cuda.empty_cache()

    # QFT of a basis state against its closed form
    n = QFT_N
    x = 0x2A5F3C1 % (1 << n)
    circ = rq.Circuit(n, sim)
    for q in range(n):
        if (x >> q) & 1:
            circ.x(q)
    for op in qft_ir(n).ops:
        circ._enqueue(op.name, op.targets, op.controls, op.params)
    psi = circ.get_statevector()
    check(circ.state[1] is not None, "QFT carries a complex state")
    k = np.arange(1 << n, dtype=np.int64)
    phase = ((x * k) % (1 << n)).astype(np.float64) * (2 * np.pi / (1 << n))
    expected = np.exp(1j * phase) / np.sqrt(1 << n)
    qft_err = float(np.abs(psi - expected).max())
    print(f"QFT n={n} of |{x}>: max abs err vs closed form {qft_err:.3e}")
    check(qft_err <= QFT_ATOL, f"QFT error {qft_err}")
    del circ, psi, expected, k, phase
    torch.cuda.empty_cache()

    # GHZ, sampled
    n = GHZ_N
    circ = rq.Circuit(n, sim)
    for op in ghz_ir(n).ops:
        circ._enqueue(op.name, op.targets, op.controls)
    shots = circ.sample(list(range(n)), GHZ_SHOTS)
    ones = int(np.sum(shots == (1 << n) - 1))
    zeros = int(np.sum(shots == 0))
    print(f"GHZ n={n}: {GHZ_SHOTS} shots, all-0 {zeros}, all-1 {ones}")
    check(zeros + ones == GHZ_SHOTS, "GHZ samples only all-0 and all-1")
    check(0.45 <= ones / GHZ_SHOTS <= 0.55, f"GHZ all-1 fraction {ones}")
    del circ
    torch.cuda.empty_cache()

    # ---- 5. times -------------------------------------------------------
    n = ANSATZ_N
    full = hardware_efficient_ansatz_ir(n, ANSATZ_LAYERS)
    total_passes = sum(interpreter.block_pass_count(item, n)
                       for item in interpreter.plan_items(full.ops, n)
                       if isinstance(item, PallasBlock))
    print(f"passes: one layer {len(passes)}, {ANSATZ_LAYERS} layers "
          f"{total_passes} ({total_passes / ANSATZ_LAYERS:.3f} per layer)")
    print(f"per pass at n={n}, real plane (ms, kernel/plain in turns): "
          f"plain {plain_ms:.4f}, kernel {kernel_ms:.4f}, kernel "
          f"{kernel_ms_2:.4f}, plain {plain_ms_2:.4f}")
    best = min(t for _, _, t in answers)
    print(f"ansatz: {gates} gates per request, best flush "
          f"{best * 1e3:.2f} ms = {gates / best:.1f} gates/s")
    print(f"launches in the main-path run: {launches}")

    print(json.dumps({"kernels": [{
        "name": "fused_layer",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/fused_sv.cu",
        "replaces": "rocquantum_tpu/ops/pallas_sv.py:780",
        "launches": launches,
        "max_abs_err": worst,
        "ms": min(kernel_ms, kernel_ms_2),
        "plain_ms": min(plain_ms, plain_ms_2),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
