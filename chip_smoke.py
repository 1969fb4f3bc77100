#!/usr/bin/env python3
"""Drive the PyTorch port (rocquantum_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with one CUDA device visible:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions
     and which gate-pass planner runs;
  2. build the four kernels (csrc/fused_sv.cu, fused_df64.cu,
     rotate_bits.cu, region_dot.cu) from the checkout, one nvcc per source,
     all started together;
  3. kernel against its plain-torch version on the card: seeded random
     passes at n = 22 over every gate kind, {no pair bits, one, three,
     five (real plane only)}, {real plane, complex} and the
     start-from-|0...0> mode, then every pass of one ansatz layer at
     n = 29 (the main path's shapes), timed;
  4. the slice: Circuit(29) with 8 RY-column + CNOT-ring layers answering
     3 energy requests (transverse-field Ising Hamiltonian), held against
     the same requests run with the plain layer function; QFT of a basis
     state at n = 26 against its closed form; GHZ at n = 29, sampled;
  5. times: kernel and plain ms per pass, passes per layer, exchanges per
     pass, gates/s; the |0...0> fill kernel at n = 29 beside its plain
     version, torch.zeros and its write bound; the first pass from
     |0...0> beside the same pass reading a state and its plain version,
     each beside its own bound (writes or reads and writes, against the
     pass's FP32 instructions);
  6. the df64 kernel (csrc/fused_df64.cu) against its plain-torch version
     on the card: seeded random passes at n = 22 over every gate kind,
     {no pair bits, one, three}, {real carry, complex carry}, then every
     pass of one ansatz layer at n = 26 (the df64 main path's shapes),
     timed beside its bound in FP32 instructions; the QFT's kernel block
     at n = 26 on the complex carry: its widest pass against the plain
     version, every pass timed;
  7. the double-precision slice: set_precision("df64"), Circuit(26) with
     8 RY-column + CNOT-ring layers answering 3 TFIM energy requests, held
     against one request run with the plain df64 layer function and one
     under set_precision("double") (exact complex128 per op); QFT of a
     basis state at n = 26 in df64 against its closed form; times;
  8. the index-bit rotation kernel (csrc/rotate_bits.cu) against its
     plain-torch version, bitwise: n = 22, every shift, batch 1 and 3;
     n = 29, shifts 1, 3, 12, 21, timed beside the plain version (itself
     one PyTorch copy), a device copy of the plane and the bound;
  9. the relabel path at n = 29: one RY layer from |0...0> through
     relabel.execute_plan, planned with pair bits and with window-only
     passes plus Rotations; the two states agree and match the closed form;
  10. the tensor-core probe (csrc/region_dot.cu): the 3xTF32 lane and row
     dots against float64 at R = 128 and R = 2^17, timed beside
     torch.matmul in full float32 and the bound; seven RY gates on qubits
     0-6 at n = 29 as one composed lane dot and as one fused-kernel pass,
     held against each other and timed in turns;
  12. the density engine (since its port): DensityCircuit(14), a
     2n = 28-bit view, in single precision answering 3 requests of
     bench.py:485's workload (2 layers of RY on every qubit then
     depolarizing(0.02) on every qubit; <Z_q> of every qubit and a TFIM
     expectation) against the closed form and one request on the plain
     layers; a complex carry (H, RZ, a CNOT ring, a CRZ, amplitude
     damping and phase flip on every qubit) against the plain layers,
     its trace and Hermiticity on the card, a measure and a further
     flush, 4096 shots; the same requests under set_precision("df64")
     against the closed form, and at n = 12 the whole rho against
     set_precision("double")'s exact engine; flush times, planned passes,
     launches, ms per pass beside its bound, peak memory.
  11. the kernel front end, compiled programs and adjoint gradients: a
     @kernel ring ansatz at n = 29 (8 layers, 232 angles) differentiated by
     adjoint_grad against phase 4's energy, parameter shift through
     compile_program and the same sweep with the plain layer function,
     with its launches, times and peak memory beside a 2-layer run; the
     double-precision gradient under set_precision("df64") at n = 26 (2
     layers) against parameter shift and the exact engine's energy;
     compile_program replays of the n = 29 ansatz (phase 4's energies), of
     the QFT at n = 26 (against Circuit runs, timed beside them) and of the
     df64 ansatz (phase 7's energy); VQE-H2 (examples/vqe_h2.py) with
     L-BFGS-B on the card.
  13. tensor networks and the df64 readout twins (since their port): the
     df64 twins on phase 7's n = 26 state (expval_terms_df64 of the TFIM
     against the Circuit's energy, norm2_df64, prob_one_df64 and
     collapse_df64, 20000 int32 draws of sample_df64 against the marginal)
     and compile_df64_ir of a 2-layer ansatz at n = 22 against the fused
     flush, run inside phase 7; then bench.py's ring A(a,b) B(b,c) C(c,a)
     -> scalar at d = 8192 through TensorNetwork with num_slices 4, timed
     beside its FP32 bound and one torch.einsum, against complex128, and
     again under set_precision("double"); the precision guard (a d = 8192
     GEMM through the executor with TF32 off and under
     torch.set_float32_matmul_precision("high")); memory-limited slicing
     of a 512 MiB output under a limit of 1/64 of it (allocator peak and
     the executor's tally) and contracted-index slicing of a d = 8192
     scalar contraction; tensor_svd of a (64, 64, 64, 64) tensor.

Each path (phases 4, 7, 9, 11's gradient and 12's f32 and df64 requests,
and the probe's R = 2^17 call of each dot) runs with every launch count
set to 0 just before it and read just after; the kernels line gives phase
12's counts as "density_launches" and its ms per pass of the density
plans as "density_ms".
Prints a kernels JSON line (time, plain time, bound and one-call PyTorch
time of each kernel), the nvidia-smi line and, last, the
{"ok": true, "device": ...} line. Any failed check raises (non-zero exit,
no result line); so does a machine without CUDA.
"""

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
DF64_N = 26           # the JAX package's fp64/df64 width (bench.py FP64_N)
DF64_KERNEL_TOL = 1e-13   # promoted f64, kernel vs plain, normalized state
DF64_ENERGY_RTOL = 1e-12  # df64 kernel path vs plain df64 layers
DOUBLE_ENERGY_RTOL = 1e-11  # df64 vs the exact complex128 engine
DF64_NORM_TOL = 1e-12
DF64_QFT_ATOL = 1e-13
ROTATE_N = 29         # one real plane of the main path
ROTATE_SHIFTS = (1, 3, 12, 21)
PROBE_ROWS_SMALL = 1 << 7   # the MXU probe's own size (tpu_mxu_probe.py:42)
PROBE_ROWS = 1 << 17        # (R, 4096) float32 = one n = 29 plane
PROBE_TOL = 1e-5      # region dots: max abs error / max|y| vs float64
GRAD_SHIFT_ATOL = 2e-3   # f32 adjoint gradient vs parameter shift
GRAD_PLAIN_ATOL = 1e-3   # f32 gradient, kernel vs plain layers
GRAD_MEMORY_RATIO = 1.25  # peak memory, 8 layers over 2 layers
DF64_GRAD_ATOL = 1e-9    # double adjoint gradient vs parameter shift
DF64_GRAD_LAYERS = 2
REPLAY_RTOL = 1e-6       # compile_program vs the Circuit it replays (f32)
DF64_REPLAY_RTOL = 1e-12
QFT_REPLAYS = 5
VQE_H2_ENERGY = -1.13728  # ROADMAP "Source paper"; examples/vqe_h2.py
VQE_H2_ATOL = 2e-3
DENSITY_N = 14        # the JAX bench's largest density width (bench.py:477)
DENSITY_LAYERS = 2    # bench.py:485: RY on every qubit, then depolarizing
DENSITY_P = 0.02
DENSITY_ANGLES = (0.3, 0.5, 0.7)  # three requests: RY(a + 0.01 q)
DENSITY_TOL = 1e-5        # f32: <Z_q>, trace, kernel vs plain / max|rho|
DENSITY_PURITY_RTOL = 1e-4
DENSITY_HERMITIAN_TOL = 1e-6  # of max|rho|
DENSITY_SHOTS = 4096
DENSITY_FRACTION_TOL = 0.03
DENSITY_DF64_TOL = 1e-12  # df64: <Z_q> and trace vs the closed form
DENSITY_EXACT_N = 12
DENSITY_EXACT_TOL = 1e-11  # df64 rho vs the exact double engine
TWIN_TOL = 1e-12          # df64 twins vs the Circuit / the fused flush
TWIN_SHOTS = 20000
TWIN_FREQ_TOL = 0.03
TWIN_IR_N = 22
TWIN_IR_LAYERS = 2
TN_DIM = 8192             # bench.py's ring (TN_DIM, TN_SLICES)
TN_SLICES = 4
TN_RING_TOL = 1e-5        # |diff| / Cauchy-Schwarz scale, vs complex128
TN_GUARD_TOL = 5e-5       # max|diff| / max|out| of a d = 8192 GEMM:
                          # float32 5.7e-6, TF32 2.9e-4 on an H100 80GB HBM3
TN_SLICE_DIM = 1 << 13    # a 2^26-element (512 MiB) output
TN_SLICE_K = 16
TN_SLICE_TOL = 1e-6
TN_SVD_SHAPE = (64, 64, 64, 64)
TN_SVD_TOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet): device memory, FP32 outside the
# tensor cores and dense TF32 on them; a bound is the larger of bytes / HBM
# and operations / the peak of the units that do them. FP32 work is counted
# in instructions: 132 SMs x 128 lanes x 1.98 GHz (half the 67 TFLOP/s,
# which counts an FMA as two)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32_INSTR_PER_S = 33.5e12
TF32_OPS_PER_S = 495e12
FP64_TC_FLOPS = 67e12     # FP64 on the tensor cores (DMMA)


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
    {0..w-1} | pair_bits: every kind, free controls and free D2 bits; the
    matrices as a list of complex128 2x2s."""
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
        mats.append(np.asarray(m, np.complex128))
    return specs, mats


def pack_f32(mats):
    """complex 2x2s -> the f32 kernel's (K, 2, 2, 2) re/im table."""
    import numpy as np
    return np.stack([np.stack([m.real, m.imag], -1)
                     for m in mats]).astype(np.float32)


def gate_ops(kind, real_mat, complex_state, df):
    """FP32 instructions per amplitude of the state for one gate of a pass.
    An FMA is one instruction: the pipe issues one instruction a lane a
    clock, FP32_INSTR_PER_S on the H100 SXM (the 67 TFLOP/s of the data
    sheet counts an FMA as two operations). In f32 a product is one
    instruction and a product added to a sum one (an FMA). In df64 a
    df_mul is 9 (two_prod 2, cross terms 3, their sum 1, quick_two_sum 3)
    and a df_add 20 (two two_sums 12, two sums 2, two quick_two_sums 6):
    plain adds and products, whose only FMA is two_prod's. A 2x2 row is
    two products and a sum per output component, a diagonal one product; a
    complex product is two real products and a sum per component. CU acts
    on the half of the amplitudes where its control is 1."""
    if kind == "CNOT":
        return 0.0
    if df:
        mul, add = 9, 20
        row, cmul = 2 * mul + add, 2 * mul + add
        crow = 2 * cmul + add
    else:
        mul, row, cmul, crow = 1, 2, 2, 4
    if kind == "D2":
        per = mul if not complex_state else 2 * mul if real_mat else 2 * cmul
    elif not complex_state:
        per = row
    elif real_mat:
        per = 2 * row
    else:
        per = 2 * crow
    return per * (0.5 if kind == "CU" else 1.0)


def bound_ms(n, passes, planes, complex_state, df):
    """(mean least time per pass in ms, "bytes" or "operations") for
    passes ``[(specs, real_flags), ...]`` over ``planes`` float32 planes
    of 2^n amplitudes: each plane read once and written once, against the
    instructions of :func:`gate_ops`. ``bound_by`` names the larger of the
    two sums over the passes."""
    byte_s = op_s = total = 0.0
    for specs, flags in passes:
        b = (1 << n) * 4 * planes * 2 / HBM_BYTES_PER_S
        o = (1 << n) * sum(gate_ops(sp[0], fl, complex_state, df)
                           for sp, fl in zip(specs, flags)) / FP32_INSTR_PER_S
        byte_s += b
        op_s += o
        total += max(b, o)
    return (total * 1e3 / len(passes),
            "operations" if op_s > byte_s else "bytes")


def df64_bound_before(n, passes):
    """The df64 real-carry bound per pass as this script counted it before
    (40 operations a real gate, 20 a CU, at 67e12/s): printed once beside
    the instruction count."""
    total = 0.0
    for specs, _ in passes:
        ops = sum({"CNOT": 0, "CU": 20, "D2": 10}.get(sp[0], 40)
                  for sp in specs)
        total += max((1 << n) * 16 / HBM_BYTES_PER_S,
                     (1 << n) * ops / FP32_OPS_PER_S)
    return total * 1e3 / len(passes)


def max_err(a, b):
    if a is None:
        return 0.0
    return float((a - b).abs().max())


def zero_counts(*modules):
    """Set every launch count of these kernel modules to 0."""
    for module in modules:
        for name in dir(module):
            if name.endswith("LAUNCHES"):
                setattr(module, name, 0)


@contextlib.contextmanager
def plain_layers(module, name, plain):
    """Route the slice's passes through the plain-torch layer function."""
    kernel_fn = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel_fn)


def timed(fn, reps):
    """ms per unit of work, CUDA events: ``fn(reps)`` runs the work and
    returns how many units it ran; one warm-up call first."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    count = fn(1)  # warm-up
    torch.cuda.synchronize()
    start.record()
    count = fn(reps)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / count


def repeat(call):
    """``call()`` as a ``timed`` work function: one unit per call."""
    def run(reps):
        for _ in range(reps):
            call()
        return reps
    return run


def time_turns(run_kernel, run_plain, kernel_reps, plain_reps=1):
    """ms per pass, CUDA events, in turns: plain, kernel, kernel, plain."""
    return (timed(run_plain, plain_reps), timed(run_kernel, kernel_reps),
            timed(run_kernel, kernel_reps), timed(run_plain, plain_reps))


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
    from rocquantum_tpu_torch.ops import (_build, _native_planner, df64,
                                          fused_df64, fused_sv, pairsim,
                                          region_dot, relabel, rotate)

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

    # ---- 2. build: one nvcc per source, all started together -------------
    t0 = time.perf_counter()
    kernel_modules = (fused_sv, fused_df64, rotate, region_dot)
    with ThreadPoolExecutor(len(kernel_modules)) as pool:
        for job in [pool.submit(m.build) for m in kernel_modules]:
            job.result()
    print(f"build: fused_sv.cu, fused_df64.cu, rotate_bits.cu and "
          f"region_dot.cu in parallel in {time.perf_counter() - t0:.2f} s")
    for name in ("fused_sv", "fused_df64", "rotate_bits", "region_dot"):
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 3. kernel vs plain ---------------------------------------------
    rng = np.random.default_rng(2026)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    worst = 0.0
    n = RANDOM_N
    w = fused_sv.window_bits(n)
    for pair_bits in ((), (15,), (11, 17, 21), (11, 13, 17, 19, 21)):
        for mode in ("real", "complex", "zero"):
            if len(pair_bits) > fused_sv.max_pairs(complex_carry=True) \
                    and mode == "complex":
                continue  # five pair bits: the real plane only
            specs, mats = random_specs(rng, n, w, pair_bits, 48,
                                       real=mode != "complex")
            gm = pack_f32(mats)
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
    plan = interpreter.kernel_plan(n, kinds, supports)
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

    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    answers = [answer(theta) for theta in requests]
    launches = fused_sv.LAUNCHES
    init_launches = fused_sv.ZERO_LAUNCHES
    check(fused_df64.LAUNCHES == 0, "the f32 slice launched no df64 pass")
    check(init_launches > 0, "each request started from the fill launch")
    with plain_layers(fused_sv, "apply_fused_layer",
                      fused_sv.apply_fused_layer_reference):
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
    qft_f32_err = qft_err
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
    schedules = [fused_sv.pass_schedule(n, fused_sv._normalize_specs(specs))
                 for specs, _, _, _ in passes]
    print("exchanges per pass of one layer (launches): " + ", ".join(
        f"{sum(x.swaps for x in sch)} ({len(sch)})" for sch in schedules))
    print(f"per pass at n={n}, real plane (ms, kernel/plain in turns): "
          f"plain {plain_ms:.4f}, kernel {kernel_ms:.4f}, kernel "
          f"{kernel_ms_2:.4f}, plain {plain_ms_2:.4f}")
    best = min(t for _, _, t in answers)
    print(f"ansatz: {gates} gates per request, best flush "
          f"{best * 1e3:.2f} ms = {gates / best:.1f} gates/s")
    print(f"launches in the main-path run: {launches}")
    f32_bound, f32_bound_by = bound_ms(
        n, [(specs, fl) for specs, _, _, fl in passes], 1,
        complex_state=False, df=False)
    print(f"bound per pass at n={n}, real plane: {f32_bound:.4f} ms "
          f"({f32_bound_by})")
    init = init_timing(fused_sv, n, dev)
    init["launches"] = init_launches
    gen_zero_timing(fused_sv, passes[0], n, dev)
    print(f"fill launches in the main-path run: {init_launches}")

    phase4_energies = [e for e, _, _ in answers]
    df, df64_energy = df64_phases(rq, interpreter, PallasBlock,
                     hardware_efficient_ansatz_ir, qft_ir, df64, fused_df64,
                     fused_sv, pairsim, rng, gen, dev, sim, qft_f32_err)
    rot = rotation_phases(fused_sv, relabel, rotate, rng, gen, dev)
    lane, row = probe_phase(region_dot, fused_sv, gen, dev)
    gradient_phase(rq, qft_ir, fused_sv, fused_df64, rotate, region_dot,
                   requests, phase4_energies, df64_energy, dev)
    density, density_ms = density_phase(rq, interpreter, PallasBlock,
                                        fused_sv, fused_df64, df64, rotate,
                                        region_dot, dev)
    tensornet_phase(rq, dev)

    print(json.dumps({"kernels": [{
        "name": "fused_layer",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/fused_sv.cu",
        "replaces": "rocquantum_tpu/ops/pallas_sv.py:780",
        "launches": launches,
        "max_abs_err": worst,
        "ms": min(kernel_ms, kernel_ms_2),
        "plain_ms": min(plain_ms, plain_ms_2),
        "bound_ms": f32_bound,
        "bound_by": f32_bound_by,
        "library_ms": None,
        "density_launches": density["fused_layer"],
        "density_ms": density_ms["fused_layer"],
    }, {
        "name": "fused_layer_init",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/fused_sv.cu",
        "replaces": "rocquantum_tpu/ops/pallas_sv.py:1667",
        **init,
        "density_launches": density["fused_layer_init"],
    }, {
        "name": "fused_layer_df64",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/fused_df64.cu",
        "replaces": "rocquantum_tpu/ops/pallas_df64.py:240",
        **df,
        "density_launches": density["fused_layer_df64"],
        "density_ms": density_ms["fused_layer_df64"],
    }, {
        "name": "rotate_bits",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/rotate_bits.cu",
        "replaces": "rocquantum_tpu/ops/relabel.py:91",
        **rot,
    }, {
        "name": "region_dot_lane",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/region_dot.cu",
        "replaces": ".scratch/tpu_mxu_probe.py:27",
        **lane,
    }, {
        "name": "region_dot_row",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/region_dot.cu",
        "replaces": ".scratch/tpu_mxu_probe.py:55",
        **row,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def df64_phases(rq, interpreter, PallasBlock, ansatz_ir, qft_ir, df64,
                fused_df64, fused_sv, pairsim, rng, gen, dev, sim,
                qft_f32_err):
    """Phases 6 and 7: the df64 kernel against its plain version on the
    card, then the double-precision slice at n = 26. Returns the df64
    kernel's numbers for the kernels line and the first request's
    energy."""
    import numpy as np
    import torch

    t_phases = time.perf_counter()

    def promoted_err(got, want):
        err = 0.0
        for a, b in zip(df64.state_to_pair_f64(got),
                        df64.state_to_pair_f64(want)):
            if b is not None:
                err = max(err, float((a - b).abs().max()))
        return err

    def clone(planes):
        return tuple(None if p is None else p.clone() for p in planes)

    # ---- 6. df64 kernel vs plain ----------------------------------------
    worst = 0.0
    n = RANDOM_N
    w = fused_sv.window_bits(n)
    for pair_bits in ((), (15,), (11, 17, 21)):
        for mode in ("real", "complex"):
            real = mode == "real"
            specs, mats = random_specs(rng, n, w, pair_bits, 48, real=real)
            gm = fused_df64.pack_gate_mats_df64(mats)
            flags = [real] * len(specs)
            v = torch.randn(1 if real else 2, 1 << n, generator=gen,
                            dtype=torch.float64, device=dev)
            v /= torch.linalg.vector_norm(v)
            planes = df64.state_from_pair_f64(v[0], None if real else v[1])
            want = fused_df64.apply_fused_layer_df64_reference(
                *planes, specs, gm, real_flags=flags)
            got = fused_df64.apply_fused_layer_df64(
                *clone(planes), specs, gm, pair_bits=pair_bits,
                real_flags=flags)
            torch.cuda.synchronize()
            err = promoted_err(got, want)
            worst = max(worst, err)
            print(f"df64 kernel vs plain n={n} pairs={pair_bits} {mode}: "
                  f"max abs err {err:.3e}")
            check(err <= DF64_KERNEL_TOL, f"df64 n={n} {pair_bits} {mode}: "
                  f"{err}")

    # one ansatz layer at the df64 main path's shape, pass by pass
    n = DF64_N
    (block,) = interpreter.plan_items(ansatz_ir(n, 1).ops, n)
    check(isinstance(block, PallasBlock), "df64 ansatz layer is one block")
    kinds, supports, gm, flags = interpreter.pallas_block_specs_df64(
        block, rng.normal(size=n))
    check(all(flags), "the ansatz layer is real")
    plan = interpreter.kernel_plan(n, kinds, supports, fused_df64)
    passes = [(tuple((kinds[i],) + tuple(p)
                     for i, p in zip(item.gate_idx, item.positions)),
               gm[list(item.gate_idx)], item.pair_bits,
               [flags[i] for i in item.gate_idx]) for item in plan]
    v = torch.randn(1 << n, generator=gen, dtype=torch.float64, device=dev)
    state = df64.state_from_pair_f64(v / torch.linalg.vector_norm(v), None)
    del v
    for specs, g, pb, fl in passes:
        want = fused_df64.apply_fused_layer_df64_reference(
            *state, specs, g, real_flags=fl)
        got = fused_df64.apply_fused_layer_df64(*clone(state), specs, g,
                                                pair_bits=pb, real_flags=fl)
        torch.cuda.synchronize()
        err = promoted_err(got, want)
        worst = max(worst, err)
        check(err <= DF64_KERNEL_TOL, f"df64 n={n} pass {pb}: {err}")
        del want, got
    print(f"df64 kernel vs plain n={n}: {len(passes)} ansatz-layer passes, "
          f"max abs err {worst:.3e}")

    def chain(fn):
        x = [clone(state)]

        def run(reps):
            for _ in range(reps):
                for specs, g, pb, fl in passes:
                    x[0] = fn(*x[0], specs, g, pair_bits=pb, real_flags=fl)
            return reps * len(passes)
        return run

    turns = time_turns(chain(fused_df64.apply_fused_layer_df64),
                       chain(fused_df64.apply_fused_layer_df64_reference),
                       10)
    bound, bound_by = bound_ms(n, [(specs, fl) for specs, _, _, fl in passes],
                               2, complex_state=False, df=True)
    bound_before = df64_bound_before(
        n, [(specs, fl) for specs, _, _, fl in passes])
    del state
    torch.cuda.empty_cache()
    qft_pass = df64_qft_pass(interpreter, PallasBlock, qft_ir, df64,
                             fused_df64, promoted_err, gen, dev)
    worst = max(worst, qft_pass)

    # ---- 7. double-precision slice --------------------------------------
    zz = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    hamiltonian = rq.PauliOperator(zz) + rq.PauliOperator(
        {f"X{q}": -0.5 for q in range(n)})
    requests = [np.random.default_rng(200 + r).normal(size=n * ANSATZ_LAYERS)
                for r in range(REQUESTS)]

    def answer(circ, theta, real_carry):
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
        check(circ.state[0].dtype == torch.float64, "a float64 state")
        check((circ.state[1] is None) == real_carry,
              f"the state is (re, None): {real_carry}")
        energy = circ.expval(hamiltonian)
        norm = float(pairsim.norm2_pair(*circ.state))
        return energy, norm, t_flush

    rq.set_precision("df64")
    circ = rq.Circuit(n, sim)
    fused_sv.LAUNCHES = fused_df64.LAUNCHES = 0
    answers = [answer(circ, theta, True) for theta in requests]
    launches = fused_df64.LAUNCHES
    check(launches > 0, "the df64 slice launched the df64 kernel")
    check(fused_sv.LAUNCHES == 0, "the df64 slice launched no f32 pass")
    df64_twins(rq, interpreter, ansatz_ir, df64, pairsim, circ, hamiltonian,
               answers[-1][0], sim, dev)
    fused_sv.LAUNCHES = fused_df64.LAUNCHES = 0
    with plain_layers(fused_df64, "apply_fused_layer_df64",
                      fused_df64.apply_fused_layer_df64_reference):
        plain = answer(circ, requests[0], True)
    check(fused_df64.LAUNCHES == 0, "plain run launched no kernel")
    del circ
    rq.set_precision("double")
    exact = answer(rq.Circuit(n, sim), requests[0], False)
    rq.set_precision("df64")
    torch.cuda.empty_cache()
    gates = ANSATZ_LAYERS * 2 * n
    for r, (e, nrm, t) in enumerate(answers):
        print(f"df64 request {r}: energy {e:.15f}, norm {nrm:.15f}, flush "
              f"{t * 1e3:.2f} ms = {gates / t:.1f} gates/s")
        check(np.isfinite(e) and abs(nrm - 1.0) <= DF64_NORM_TOL,
              f"df64 energy {e}, norm {nrm}")
    e0 = answers[0][0]
    for name, (e_ref, _, t_ref), tol in (
            ("plain df64 layers", plain, DF64_ENERGY_RTOL),
            ("exact double", exact, DOUBLE_ENERGY_RTOL)):
        rel = abs(e0 - e_ref) / max(abs(e_ref), 1e-30)
        print(f"df64 request 0 vs {name}: energy {e_ref:.15f}, rel diff "
              f"{rel:.3e} (limit {tol:.0e}), flush {t_ref * 1e3:.1f} ms")
        check(rel <= tol, f"df64 energy {e0} vs {name} {e_ref}")

    # QFT of a basis state in df64 against its closed form
    x = 0x2A5F3C1 % (1 << n)
    circ = rq.Circuit(n, sim)
    for q in range(n):
        if (x >> q) & 1:
            circ.x(q)
    for op in qft_ir(n).ops:
        circ._enqueue(op.name, op.targets, op.controls, op.params)
    psi = circ.get_statevector()
    check(circ.state[1] is not None, "the df64 QFT carries a complex state")
    k = np.arange(1 << n, dtype=np.int64)
    phase = ((x * k) % (1 << n)).astype(np.float64) * (2 * np.pi / (1 << n))
    qft_err = float(np.abs(psi - np.exp(1j * phase) / np.sqrt(1 << n)).max())
    print(f"QFT n={n} of |{x}> in df64: max abs err vs closed form "
          f"{qft_err:.3e} (f32 path {qft_f32_err:.3e})")
    check(qft_err <= DF64_QFT_ATOL, f"df64 QFT error {qft_err}")
    del circ, psi, k, phase
    rq.set_precision("single")
    torch.cuda.empty_cache()

    # ---- df64 times -----------------------------------------------------
    full = ansatz_ir(n, ANSATZ_LAYERS)
    total_passes = sum(interpreter.block_pass_count(item, n, fused_df64)
                       for item in interpreter.plan_items(full.ops, n)
                       if isinstance(item, PallasBlock))
    print(f"df64 passes: one layer {len(passes)}, {ANSATZ_LAYERS} layers "
          f"{total_passes} ({total_passes / ANSATZ_LAYERS:.3f} per layer)")
    print(f"df64 per pass at n={n}, real carry (ms, kernel/plain in turns): "
          f"plain {turns[0]:.4f}, kernel {turns[1]:.4f}, kernel "
          f"{turns[2]:.4f}, plain {turns[3]:.4f}; bound {bound:.4f} "
          f"({bound_by}; FP32 instructions at {FP32_INSTR_PER_S:.3g}/s), "
          f"{bound_before:.4f} as counted before (40 operations a real "
          f"gate at {FP32_OPS_PER_S:.3g}/s)")
    best = min(t for _, _, t in answers)
    print(f"df64 ansatz: {gates} gates per request, best flush "
          f"{best * 1e3:.2f} ms = {gates / best:.1f} gates/s")
    print(f"df64 launches in the main-path run: {launches}")
    print(f"df64 phases: {time.perf_counter() - t_phases:.1f} s")
    return {"launches": launches, "max_abs_err": worst,
            "ms": min(turns[1], turns[2]), "plain_ms": min(turns[0], turns[3]),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}, e0


def df64_qft_pass(interpreter, PallasBlock, qft_ir, df64, fused_df64,
                  promoted_err, gen, dev):
    """The df64 kernel on the complex carry at the QFT's n = 26 shapes: its
    kernel block planned on the complex carry, the widest pass held against
    the plain version, every pass timed (CUDA events) beside its bound.
    Returns the error."""
    import numpy as np
    import torch

    n = DF64_N
    (block,) = [item for item in interpreter.plan_items(qft_ir(n).ops, n)
                if isinstance(item, PallasBlock)]
    kinds, supports, gm, flags = interpreter.pallas_block_specs_df64(
        block, None)
    plan = interpreter.kernel_plan(n, kinds, supports, fused_df64)
    v = torch.randn(2, 1 << n, generator=gen, dtype=torch.float64,
                    device=dev)
    v /= torch.linalg.vector_norm(v)
    state = df64.state_from_pair_f64(v[0], v[1])
    del v
    rows = []
    for item in plan:
        idx = list(item.gate_idx)
        specs = tuple((kinds[i],) + tuple(p)
                      for i, p in zip(idx, item.positions))
        fl = [flags[i] for i in idx]
        rows.append((specs, gm[idx], item.pair_bits, fl))
    specs, g, pb, fl = max(rows, key=lambda r: len(r[0]))
    want = fused_df64.apply_fused_layer_df64_reference(*state, specs, g,
                                                       real_flags=fl)
    got = fused_df64.apply_fused_layer_df64(
        *(p.clone() for p in state), specs, g, pair_bits=pb, real_flags=fl)
    torch.cuda.synchronize()
    err = promoted_err(got, want)
    del want, got
    print(f"df64 kernel vs plain n={n}, complex carry, the QFT's widest "
          f"pass ({len(specs)} gates, pairs {pb}): max abs err {err:.3e}")
    check(err <= DF64_KERNEL_TOL, f"df64 QFT pass: {err}")
    for specs, g, pb, fl in rows:
        ms = timed(repeat(lambda: fused_df64.apply_fused_layer_df64(
            *state, specs, g, pair_bits=pb, real_flags=fl)), 10)
        (launch, *more) = fused_df64.pass_schedule(
            n, fused_df64._normalize_specs(specs), True)
        bound, by = bound_ms(n, [(specs, fl)], 4, complex_state=True,
                             df=True)
        print(f"df64 QFT pass at n={n}, complex carry: {len(specs)} gates "
              f"({sum(not f for f in fl)} complex), tile 2^"
              f"{launch.tile_bits}, {launch.swaps} exchanges, "
              f"{len(more) + 1} launch(es): {ms:.4f} ms; bound {bound:.4f} "
              f"({by})")
    check(all(bool(torch.isfinite(p).all()) for p in state),
          "the QFT passes stay finite")
    del state
    torch.cuda.empty_cache()
    return err


def init_timing(fused_sv, n, dev):
    """The |0...0> fill kernel (the JAX package's init_zero_state_tiled) on
    its own at n = 29: bitwise against its plain version, timed beside it,
    beside one torch.zeros call and beside its bound (one plane written
    once)."""
    import torch

    def kernel():
        return fused_sv.init_zero(n, dev)

    def plain():
        return fused_sv._zero_plane(n, dev)

    check(torch.equal(kernel(), plain()), "fill kernel == plain |0...0>")
    turns = time_turns(repeat(kernel), repeat(plain), 10, 10)
    library = min(timed(repeat(lambda: torch.zeros(1 << n, device=dev)), 10)
                  for _ in range(2))
    bound = (1 << n) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"init |0...0> at n={n} (ms, in turns): plain {turns[0]:.4f}, "
          f"kernel {turns[1]:.4f}, kernel {turns[2]:.4f}, plain "
          f"{turns[3]:.4f}; torch.zeros {library:.4f}; bound {bound:.4f} "
          f"(bytes)")
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": min(turns[1], turns[2]),
            "plain_ms": min(turns[0], turns[3]), "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library}


def gen_zero_timing(fused_sv, first_pass, n, dev):
    """The fused kernel's start-from-|0...0> mode (the JAX package's
    _gen_zero_input) on the first ansatz pass at n = 29, timed beside the
    same pass reading a state, each beside its own bound: the plane written
    once (from |0...0>) or read and written once (reading), against the
    pass's FP32 instructions (:func:`gate_ops`)."""
    import torch

    specs, g, pb, fl = first_pass
    state = torch.full((1 << n,), 2.0 ** (-n / 2), device=dev)

    def zero():
        return fused_sv.apply_fused_layer(None, None, specs, g, pair_bits=pb,
                                          real_flags=fl, num_qubits=n,
                                          device=dev)

    def loading():
        return fused_sv.apply_fused_layer(state, None, specs, g, pair_bits=pb,
                                          real_flags=fl)

    def plain():
        return fused_sv.apply_fused_layer_reference(
            None, None, specs, g, real_flags=fl, num_qubits=n, device=dev)

    turns = time_turns(repeat(zero), repeat(loading), 10, 10)
    plain_ms = min(timed(repeat(plain), 1) for _ in range(2))
    op_ms = (1 << n) * sum(gate_ops(sp[0], f, False, False)
                           for sp, f in zip(specs, fl)) / FP32_INSTR_PER_S * 1e3
    write_ms = (1 << n) * 4 / HBM_BYTES_PER_S * 1e3
    zero_bound = max(write_ms, op_ms)
    load_bound, load_by = bound_ms(n, [(specs, fl)], 1, complex_state=False,
                                   df=False)
    print(f"first ansatz pass at n={n} from |0...0> (ms, in turns): reading "
          f"{turns[0]:.4f}, from |0...0> {turns[1]:.4f}, from |0...0> "
          f"{turns[2]:.4f}, reading {turns[3]:.4f}; plain version from "
          f"|0...0> {plain_ms:.4f}; bound from |0...0> {zero_bound:.4f} "
          f"({'bytes' if write_ms >= op_ms else 'operations'}: writes "
          f"{write_ms:.4f}, {len(specs)} gates {op_ms:.4f}), bound reading "
          f"{load_bound:.4f} ({load_by})")
    del state
    torch.cuda.empty_cache()


def rotation_plan(relabel, n, qubits, reach):
    """One gate per qubit of ``qubits``, scheduled without pair bits: a
    window-only pass takes every gate whose qubit currently sits below
    ``reach``; a Rotation then brings the lowest pending qubit to bit
    ROT_LO (and the ones above it into the window); a last Rotation
    restores the identity layout. Positions in the plan are the physical
    bits at the time of each pass."""
    size = n - relabel.ROT_LO

    def phys(q, total):
        if q < relabel.ROT_LO:
            return q
        return relabel.ROT_LO + (q - relabel.ROT_LO - total) % size

    pending = list(range(len(qubits)))
    plan, total = [], 0
    while pending:
        here = [i for i in pending if phys(qubits[i], total) < reach]
        if here:
            sub = relabel.plan_full_layer(
                n, [(phys(qubits[i], total),) for i in here], reach,
                pair_ok=False)
            plan += [relabel.KernelPass(
                gate_idx=tuple(here[j] for j in p.gate_idx),
                positions=p.positions) for p in sub]
            pending = [i for i in pending if i not in here]
        if pending:
            shift = min(phys(qubits[i], total) for i in pending) \
                - relabel.ROT_LO
            plan.append(relabel.Rotation(shift))
            total += shift
    if total % size:
        plan.append(relabel.Rotation(size - total % size))
    return plan


def rotation_phases(fused_sv, relabel, rotate, rng, gen, dev):
    """Phases 8 and 9: the rotation kernel against its plain version on the
    card, then the relabel path at n = 29. Returns the rotation kernel's
    numbers for the kernels line."""
    import numpy as np
    import torch

    t_phases = time.perf_counter()
    # ---- 8. rotation kernel vs plain ------------------------------------
    n = RANDOM_N
    size = n - rotate.ROT_LO
    for batch in (1, 3):
        x = torch.randn(batch, 1 << n, generator=gen, device=dev)
        for shift in range(1, size):
            got = rotate.rotate_region(x, n, shift)
            torch.cuda.synchronize()
            check(torch.equal(got, rotate.rotate_bits_down(x, n, shift)),
                  f"rotation n={n} batch={batch} shift={shift} bitwise")
    print(f"rotation kernel vs plain n={n}: shifts 1..{size - 1}, batch 1 "
          f"and 3, bitwise equal")

    n = ROTATE_N
    x = torch.randn(1 << n, generator=gen, device=dev)
    bound = 2 * (1 << n) * 4 / HBM_BYTES_PER_S * 1e3
    times = {}
    for shift in ROTATE_SHIFTS:
        got = rotate.rotate_region(x, n, shift)
        torch.cuda.synchronize()
        check(torch.equal(got, rotate.rotate_bits_down(x, n, shift)),
              f"rotation n={n} shift={shift} bitwise")
        del got
        times[shift] = time_turns(
            repeat(lambda: rotate.rotate_region(x, n, shift)),
            repeat(lambda: rotate.rotate_bits_down(x, n, shift)), 10, 3)
        print(f"rotation n={n} shift={shift} (ms, in turns): plain "
              f"{times[shift][0]:.4f}, kernel {times[shift][1]:.4f}, kernel "
              f"{times[shift][2]:.4f}, plain {times[shift][3]:.4f}; bound "
              f"{bound:.4f} (bytes)")
    out = torch.empty_like(x)
    copy_ms = min(timed(repeat(lambda: out.copy_(x)), 10) for _ in range(2))
    print(f"device copy of the n={n} plane: {copy_ms:.4f} ms")
    del x, out
    torch.cuda.empty_cache()

    # ---- 9. the relabel path: one RY layer, pair bits vs rotations -------
    n = ANSATZ_N
    reach = fused_sv.window_bits(n)
    thetas = rng.normal(size=n)
    gm = pack_f32([np.array([[np.cos(t / 2), -np.sin(t / 2)],
                             [np.sin(t / 2), np.cos(t / 2)]])
                   for t in thetas])
    kinds, flags = ["U"] * n, [True] * n
    pair_plan = relabel.plan_full_layer(n, [(q,) for q in range(n)], reach)
    rot_plan = rotation_plan(relabel, n, list(range(n)), reach)
    rotations = sum(isinstance(p, relabel.Rotation) for p in rot_plan)

    def run(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        re, im = relabel.execute_plan(None, None, plan, gm, n, kinds, flags,
                                      device=dev)
        torch.cuda.synchronize()
        check(im is None, "the RY layer stays a real plane")
        return re, (time.perf_counter() - t0) * 1e3

    zero_counts(fused_sv, rotate)
    a, ms_a = run(pair_plan)
    counts_a = (fused_sv.LAUNCHES, fused_sv.INIT_LAUNCHES, rotate.LAUNCHES)
    zero_counts(fused_sv, rotate)
    b, ms_b = run(rot_plan)
    counts_b = (fused_sv.LAUNCHES, fused_sv.INIT_LAUNCHES, rotate.LAUNCHES)
    check(counts_a[0] > 0 and counts_a[1] == 1 and counts_a[2] == 0,
          f"pair plan {counts_a}")
    check(counts_b[0] > 0 and counts_b[1] == 1 and counts_b[2] > 0,
          f"the rotation plan launched both kernels: {counts_b}")
    err = max_err(a, b)
    idx = rng.integers(0, 1 << n, 4096)
    bits = (idx[:, None] >> np.arange(n)) & 1
    want = np.prod(np.where(bits == 1, np.sin(thetas / 2),
                            np.cos(thetas / 2)), axis=1)
    got = a[torch.from_numpy(idx).to(dev)].double().cpu().numpy()
    closed = float(np.abs(got - want).max())
    del a, b
    # warm (the planes come from the allocator's cache), in turns
    ms = [run(plan)[1] for plan in (pair_plan, rot_plan, rot_plan,
                                    pair_plan)]
    print(f"relabel path n={n}, one RY layer from |0...0>: pair plan "
          f"{len(pair_plan)} passes, launches (fused, from |0...0>, "
          f"rotation) "
          f"{counts_a}; rotation plan {len(rot_plan) - rotations} passes + "
          f"{rotations} rotations, launches {counts_b}; ms (first runs "
          f"{ms_a:.2f}, {ms_b:.2f}; then in turns pair {ms[0]:.2f}, "
          f"rotation {ms[1]:.2f}, rotation {ms[2]:.2f}, pair {ms[3]:.2f})")
    print(f"relabel path: max abs diff between the plans {err:.3e}, vs the "
          f"closed form at 4096 amplitudes {closed:.3e}")
    check(err <= KERNEL_TOL, f"pair plan vs rotation plan: {err}")
    check(closed <= KERNEL_TOL, f"RY layer vs closed form: {closed}")
    torch.cuda.empty_cache()
    print(f"rotation phases: {time.perf_counter() - t_phases:.1f} s")
    main_shift = 3  # the relabel path's rotations are (almost all) by 3
    check(all(isinstance(p, relabel.KernelPass) or p.shift == main_shift
              for p in rot_plan[:-1]), "the path rotates by 3")
    turns = times[main_shift]
    return {"launches": counts_b[2], "max_abs_err": 0.0,
            "ms": min(turns[1], turns[2]), "plain_ms": min(turns[0], turns[3]),
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": min(turns[0], turns[3])}


def composed_layer(region_dot, fused_sv, x, gen, dev):
    """Seven RY gates on qubits 0-6 of one n = 29 plane (``x``, viewed
    flat), as one composed 128x128 lane dot and as one pass of the fused
    kernel: the two results against each other, then each timed in turns
    (the tensor-core question of PERF.md section 7)."""
    import numpy as np
    import torch

    thetas = np.random.default_rng(29).normal(size=7)
    rot = [np.array([[np.cos(t / 2), -np.sin(t / 2)],
                     [np.sin(t / 2), np.cos(t / 2)]]) for t in thetas]
    composed = np.eye(1)
    for r in rot:  # the later (higher) qubit is the more significant
        composed = np.kron(r, composed)
    m = torch.tensor(np.ascontiguousarray(composed.T), dtype=torch.float32,
                     device=dev)
    specs = [("U", q) for q in range(7)]
    gm = pack_f32(rot)
    flags = [True] * 7
    x.copy_(torch.randn(x.shape, generator=gen, device=dev))
    x /= torch.linalg.vector_norm(x)
    state = x.view(-1)
    want, _ = fused_sv.apply_fused_layer(state.clone(), None, specs, gm,
                                         real_flags=flags)
    got = region_dot.lane_dot(x.clone(), m).view(-1)
    torch.cuda.synchronize()
    err = max_err(got, want)
    top = float(want.abs().max())
    del got, want
    print(f"seven RY gates on qubits 0-6, n=29: composed lane dot vs the "
          f"fused kernel, max abs err {err:.3e} ({err / top:.2e} of max|y|)")
    check(err <= PROBE_TOL * top, f"composed layer: {err}")
    turns = time_turns(
        repeat(lambda: region_dot.lane_dot(x, m)),
        repeat(lambda: fused_sv.apply_fused_layer(state, None, specs, gm,
                                                  real_flags=flags)),
        10, 10)
    print(f"seven RY gates on qubits 0-6, n=29 (ms, in turns): fused kernel "
          f"{turns[0]:.4f}, composed lane dot {turns[1]:.4f}, composed lane "
          f"dot {turns[2]:.4f}, fused kernel {turns[3]:.4f}")


def lane_wrapper_parts(region_dot, x, m):
    """The lane wrapper's two parts timed apart, in turns: the packing of
    m's B image alone, and the kernel launched on an image packed once
    (straight through the library, so it counts no launch)."""
    import torch

    lib = region_dot.build()
    image = region_dot.lane_operands(m)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch():
        err = lib.rocq_lane_dot(x.data_ptr(), image.data_ptr(), x.shape[0],
                                stream)
        check(err == 0, f"lane dot launch: cudaError_t {err}")

    turns = time_turns(repeat(launch),
                       repeat(lambda: region_dot.lane_operands(m)), 10, 10)
    print(f"lane dot R={x.shape[0]}, the wrapper's parts (ms, in turns): B "
          f"packing {turns[0]:.4f}, launch alone {turns[1]:.4f}, launch "
          f"alone {turns[2]:.4f}, B packing {turns[3]:.4f}")


def probe_phase(region_dot, fused_sv, gen, dev):
    """Phase 10: the tensor-core probe. Both 3xTF32 region dots against
    float64 on the card at the probe's R = 128 and at R = 2^17 (one n = 29
    plane), then timed beside torch.matmul in full float32 and the bound.
    The probe is on no path of the package: its run is the one call of each
    dot at R = 2^17, with the counts set to 0 just before it."""
    import torch

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the float32 yardstick runs without TF32")
    results = {}
    for rows in (PROBE_ROWS_SMALL, PROBE_ROWS):
        x = torch.randn(rows, region_dot.COLS, generator=gen, device=dev)
        m = torch.randn(region_dot.LANE, region_dot.LANE, generator=gen,
                        device=dev)
        a = torch.randn(region_dot.TILE, region_dot.TILE, generator=gen,
                        device=dev)
        if rows == PROBE_ROWS:
            zero_counts(region_dot)
        got_lane = region_dot.lane_dot(x.clone(), m)
        got_row = region_dot.row_dot(a, x.clone())
        torch.cuda.synchronize()
        if rows == PROBE_ROWS:
            launches = {"lane": region_dot.LANE_LAUNCHES,
                        "row": region_dot.ROW_LAUNCHES}
        for name, got, want in (
                ("lane", got_lane,
                 region_dot.lane_dot_reference(x.double(), m.double())),
                ("row", got_row,
                 region_dot.row_dot_reference(a.double(), x.double()))):
            err = float((got.double() - want).abs().max())
            top = float(want.abs().max())
            s_got = float((got.double() ** 2).sum())
            s_want = float((want ** 2).sum())
            rel = abs(s_got - s_want) / s_want
            print(f"{name} dot R={rows} vs float64: max abs err {err:.3e} "
                  f"({err / top:.2e} of max|y| {top:.2f}), rel err of "
                  f"sum(y^2) {rel:.2e}")
            check(err <= PROBE_TOL * top, f"{name} dot R={rows}: {err}")
            results[name] = max(results.get(name, 0.0), err)
            del want
        del x, got_lane, got_row
        torch.cuda.empty_cache()
    check(launches == {"lane": 1, "row": 1}, f"probe launches {launches}")

    # timing on orthogonal matrices: repeated in-place products stay finite
    rows = PROBE_ROWS
    x = torch.randn(rows, region_dot.COLS, generator=gen, device=dev)
    m = torch.linalg.qr(torch.randn(region_dot.LANE, region_dot.LANE,
                                    generator=gen, device=dev))[0].contiguous()
    a = torch.linalg.qr(torch.randn(region_dot.TILE, region_dot.TILE,
                                    generator=gen, device=dev))[0].contiguous()
    xl = x.view(-1, region_dot.LANE)
    xr = x.view(-1, region_dot.TILE, region_dot.COLS)
    flops = {"lane": 2 * x.numel() * region_dot.LANE,
             "row": 2 * x.numel() * region_dot.TILE}
    calls = {
        "lane": (lambda: region_dot.lane_dot(x, m),
                 lambda: region_dot.lane_dot_reference(x, m),
                 lambda: torch.matmul(xl, m)),
        "row": (lambda: region_dot.row_dot(a, x),
                lambda: region_dot.row_dot_reference(a, x),
                lambda: torch.matmul(a, xr)),
    }
    out = {}
    byte_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    for name, (kernel, plain, library) in calls.items():
        turns = time_turns(repeat(kernel), repeat(plain), 10, 10)
        lib = min(timed(repeat(library), 10) for _ in range(2))
        check(bool(torch.isfinite(x).all()), f"{name} dot stays finite")
        op_ms = 3 * flops[name] / TF32_OPS_PER_S * 1e3
        fp32_ms = flops[name] / FP32_OPS_PER_S * 1e3
        bound = max(byte_ms, op_ms)
        print(f"{name} dot R={rows} (ms, in turns): plain {turns[0]:.4f}, "
              f"kernel {turns[1]:.4f}, kernel {turns[2]:.4f}, plain "
              f"{turns[3]:.4f}; torch.matmul float32 {lib:.4f}; bound "
              f"{bound:.4f} (bytes {byte_ms:.4f}, 3xTF32 {op_ms:.4f}; the "
              f"FP32 cores would need {fp32_ms:.4f})")
        if name == "lane":
            lane_wrapper_parts(region_dot, x, m)
        out[name] = {"launches": launches[name], "max_abs_err": results[name],
                     "ms": min(turns[1], turns[2]),
                     "plain_ms": min(turns[0], turns[3]), "bound_ms": bound,
                     "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                     "library_ms": lib}
    del xl, xr
    composed_layer(region_dot, fused_sv, x, gen, dev)
    del x
    torch.cuda.empty_cache()
    print(f"probe phase: {time.perf_counter() - t_phase:.1f} s")
    return out["lane"], out["row"]


def ring_kernel(q, *theta):
    """The ansatz of phases 4 and 7 as a kernel body: per layer an RY
    column, then a CNOT ring."""
    n = q.num_qubits
    for layer in range(len(theta) // n):
        for qq in range(n):
            q.ry(theta[layer * n + qq], qq)
        for qq in range(n):
            q.cx(qq, (qq + 1) % n)


def tfim(rq, n):
    zz = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    return rq.PauliOperator(zz) + rq.PauliOperator(
        {f"X{q}": -0.5 for q in range(n)})


def shift_gradient(rq, prog, theta, ks):
    """Parameter-shift components ``ks`` of ``prog``'s energy, each side
    one compile_program replay."""
    import numpy as np
    out = []
    for k in ks:
        d = np.zeros_like(theta)
        d[k] = np.pi / 2
        out.append(0.5 * (prog.run(theta + d) - prog.run(theta - d)))
    return np.asarray(out)


def wall(fn):
    """(result, seconds) of ``fn()``, synchronized on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def gradient_phase(rq, qft_ir, fused_sv, fused_df64, rotate, region_dot,
                   requests, phase4_energies, df64_energy, dev):
    """Phase 11: the kernel front end, compiled programs and adjoint
    gradients at the main path's widths."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    gib = 1 << 30
    ring = rq.kernel(ring_kernel)
    sim = rq.Simulator(seed=7, device=dev)

    # ---- 11.1 f32 gradient, n = 29, 8 layers -----------------------------
    n = ANSATZ_N
    hamiltonian = tfim(rq, n)
    theta = np.asarray(requests[0], np.float64)
    params = len(theta)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_deep = torch.cuda.memory_allocated()
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    (value, grads), t_first = wall(lambda: rq.adjoint_grad(
        ring, n, sim, theta, hamiltonian, return_value=True))
    launches = (fused_sv.LAUNCHES, fused_sv.ZERO_LAUNCHES,
                fused_sv.INIT_LAUNCHES, fused_df64.LAUNCHES)
    peak_deep = torch.cuda.max_memory_allocated()
    print(f"gradient n={n}, {ANSATZ_LAYERS} layers, {params} angles: "
          f"launches (fused, fill, from |0...0>, df64) {launches}, first "
          f"adjoint_grad {t_first * 1e3:.1f} ms (plans made)")
    check(launches[0] > 0, "the gradient launched the fused kernel")
    check(launches[3] == 0, "the f32 gradient launched no df64 pass")
    rel = abs(value - phase4_energies[0]) / abs(phase4_energies[0])
    print(f"gradient value {value:.7f} vs phase 4 request 0 "
          f"{phase4_energies[0]:.7f}: rel diff {rel:.2e}")
    check(np.isfinite(value) and rel <= ENERGY_RTOL, f"value {value}")
    check(bool(np.isfinite(grads).all()), "finite gradient")
    (again_v, again_g), t_again = wall(lambda: rq.adjoint_grad(
        ring, n, sim, theta, hamiltonian, return_value=True))
    check(again_v == value and np.array_equal(again_g, grads),
          "a repeated gradient gives the same numbers")
    energy = rq.make_energy_fn(ring, n, hamiltonian, params, device=dev)
    p = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    e, t_fwd = wall(lambda: energy(p))
    _, t_bwd = wall(lambda: e.backward())
    check(np.array_equal(p.grad.numpy(), grads), "energy fn == adjoint_grad")
    print(f"repeated adjoint_grad {t_again * 1e3:.1f} ms (plans cached); "
          f"forward + energy {t_fwd * 1e3:.1f} ms, backward "
          f"{t_bwd * 1e3:.1f} ms = {t_bwd * 1e3 / params:.2f} ms per "
          f"parameterized gate")
    del e, p, energy

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_shallow = torch.cuda.memory_allocated()
    rq.adjoint_grad(ring, n, sim, theta[:2 * n], hamiltonian)
    peak_shallow = torch.cuda.max_memory_allocated()
    ratio = peak_deep / peak_shallow
    print(f"gradient peak memory: {ANSATZ_LAYERS} layers "
          f"{peak_deep / gib:.3f} GiB, 2 layers {peak_shallow / gib:.3f} "
          f"GiB, ratio {ratio:.4f} (allocated before each: "
          f"{base_deep / gib:.3f}, {base_shallow / gib:.3f} GiB)")
    check(ratio <= GRAD_MEMORY_RATIO, f"memory ratio {ratio}")

    prog = rq.compile_program(rq.trace_kernel(ring, n, *requests[0]), sim,
                              observable=hamiltonian)
    ks = np.random.default_rng(11).choice(params, 4, replace=False)
    shifted = shift_gradient(rq, prog, np.asarray(requests[0], np.float32),
                             ks)
    worst = float(np.abs(grads[ks] - shifted).max())
    print(f"gradient vs parameter shift at angles {ks.tolist()}: "
          f"{[round(float(g), 7) for g in grads[ks]]} vs "
          f"{[round(float(g), 7) for g in shifted]}, worst abs diff "
          f"{worst:.2e}")
    check(worst <= GRAD_SHIFT_ATOL, f"parameter shift: {worst}")

    with plain_layers(fused_sv, "apply_fused_layer",
                      fused_sv.apply_fused_layer_reference):
        before = fused_sv.LAUNCHES
        (plain_v, plain_g), t_plain = wall(lambda: rq.adjoint_grad(
            ring, n, sim, theta, hamiltonian, return_value=True))
        check(fused_sv.LAUNCHES == before, "plain sweep launched no pass")
    diff = float(np.abs(plain_g - grads).max())
    rel = abs(plain_v - value) / abs(plain_v)
    print(f"gradient n={n} vs the same sweep with plain layers "
          f"({t_plain:.1f} s): max abs diff {diff:.2e}, value rel diff "
          f"{rel:.2e}")
    check(diff <= GRAD_PLAIN_ATOL and rel <= ENERGY_RTOL,
          f"plain layers: {diff}, {rel}")


    # ---- 11.3 compile_program replays -------------------------------------
    replayed = [prog.run(r) for r in requests]
    for r, (got, want) in enumerate(zip(replayed, phase4_energies)):
        rel = abs(got - want) / abs(want)
        print(f"compile_program n={n} request {r}: {got:.7f} vs phase 4 "
              f"{want:.7f}, rel diff {rel:.2e}")
        check(rel <= REPLAY_RTOL, f"replay {r}: {got} vs {want}")
    del prog
    torch.cuda.empty_cache()

    nq = QFT_N
    x = 0x2A5F3C1 % (1 << nq)
    qft = rq.CircuitIR(nq, name="qft_basis")
    for q in range(nq):
        if (x >> q) & 1:
            qft.add("X", [q])
    qft.ops.extend(qft_ir(nq).ops)
    obs = rq.PauliOperator({"X0": 1.0, "Z0": 0.5, "Y1 X2": 0.25})
    handle = rq.compile_program(qft, sim)
    replay_s, circuit_s = [], []
    for _ in range(QFT_REPLAYS):
        c, t = wall(handle.run)
        replay_s.append(t)
        got = c.expval(obs)
        circ = rq.Circuit(nq, sim)

        def enqueue_and_flush():
            for op in qft.ops:
                circ._enqueue(op.name, op.targets, op.controls, op.params)
            circ.flush()

        _, t = wall(enqueue_and_flush)
        circuit_s.append(t)
        want = circ.expval(obs)
        check(abs(got - want) <= 1e-6, f"QFT replay {got} vs {want}")
        del circ
    print(f"compile_program QFT n={nq}: {QFT_REPLAYS} replays equal the "
          f"Circuit runs (last {got:.7f}); replay ms "
          f"{[round(t * 1e3, 2) for t in replay_s]}, Circuit enqueue + "
          f"flush ms {[round(t * 1e3, 2) for t in circuit_s]}")
    del handle, c
    torch.cuda.empty_cache()

    # ---- 11.2 double gradient, df64 mode, n = 26 ---------------------------
    nd = DF64_N
    h26 = tfim(rq, nd)
    rq.set_precision("df64")
    try:
        theta = np.random.default_rng(300).normal(size=nd * DF64_GRAD_LAYERS)
        zero_counts(fused_sv, fused_df64)
        (value, grads), t_grad = wall(lambda: rq.adjoint_grad(
            ring, nd, sim, theta, h26, return_value=True))
        print(f"double gradient n={nd}, {DF64_GRAD_LAYERS} layers, "
              f"{len(theta)} angles (df64 mode, the exact engine): "
              f"{t_grad * 1e3:.1f} ms, launches (fused, df64) "
              f"{(fused_sv.LAUNCHES, fused_df64.LAUNCHES)}")
        prog = rq.compile_program(rq.trace_kernel(ring, nd, *theta), sim,
                                  observable=h26)
        ks = np.random.default_rng(12).choice(len(theta), 4, replace=False)
        shifted = shift_gradient(rq, prog, theta, ks)
        worst = float(np.abs(grads[ks] - shifted).max())
        print(f"double gradient vs parameter shift (df64 replays) at angles "
              f"{ks.tolist()}: worst abs diff {worst:.2e}")
        check(worst <= DF64_GRAD_ATOL, f"double parameter shift: {worst}")
        del prog
        rq.set_precision("double")
        circ = rq.Circuit(nd, sim)
        for op in rq.trace_kernel(ring, nd, *theta).ops:
            circ._enqueue(op.name, op.targets, op.controls, op.params)
        exact = circ.expval(h26)
        del circ
        rel = abs(value - exact) / abs(exact)
        print(f"double gradient value {value:.15f} vs exact double Circuit "
              f"{exact:.15f}: rel diff {rel:.2e}")
        check(rel <= DOUBLE_ENERGY_RTOL, f"double value {value} vs {exact}")

        # one df64 replay of phase 7's first request
        rq.set_precision("df64")
        theta7 = np.random.default_rng(200).normal(size=nd * ANSATZ_LAYERS)
        prog = rq.compile_program(rq.trace_kernel(ring, nd, *theta7), sim,
                                  observable=h26)
        got = prog.run()
        rel = abs(got - df64_energy) / abs(df64_energy)
        print(f"compile_program df64 n={nd}: {got:.15f} vs phase 7 "
              f"{df64_energy:.15f}, rel diff {rel:.2e}")
        check(rel <= DF64_REPLAY_RTOL, f"df64 replay {got}")
        del prog
    finally:
        rq.set_precision("single")
    torch.cuda.empty_cache()

    # ---- 11.4 VQE-H2 on the card ------------------------------------------
    from scipy.optimize import minimize

    def ansatz(q, t0, t1, t2, t3):
        q.ry(t0, 0)
        q.ry(t1, 1)
        q.cx(0, 1)
        q.ry(t2, 0)
        q.ry(t3, 1)

    h2 = rq.PauliOperator({"I": -0.4804 + 0.7137, "Z0": 0.3435,
                           "Z1": -0.4347, "Z0 Z1": 0.5716, "X0 X1": 0.0910,
                           "Y0 Y1": 0.0910})
    h2_sim = rq.Simulator(seed=0, device=dev)
    x0 = np.random.default_rng(0).uniform(0, 2 * np.pi, 4)
    result, t_vqe = wall(lambda: minimize(
        fun=lambda x: rq.adjoint_grad(rq.kernel(ansatz), 2, h2_sim, x, h2,
                                      return_value=True),
        x0=x0, method="L-BFGS-B", jac=True, options={"maxiter": 200}))
    err = abs(result.fun - VQE_H2_ENERGY)
    print(f"VQE-H2 on {dev}: {result.fun:.6f} Ha (target {VQE_H2_ENERGY}, "
          f"error {err:.2e}), {result.nfev} energy+gradient evaluations in "
          f"{t_vqe:.2f} s")
    check(err <= VQE_H2_ATOL, f"VQE-H2 energy {result.fun}")
    print(f"gradient phase: {time.perf_counter() - t_phase:.1f} s")


def density_bench(c, base):
    """bench.py:485's workload: per layer RY(base + 0.01 q) on every
    qubit, then depolarizing on every qubit."""
    n = c.num_qubits
    for _ in range(DENSITY_LAYERS):
        for q in range(n):
            c.ry(base + 0.01 * q, q)
        c.apply_channel("depolarizing", DENSITY_P, list(range(n)))


def density_closed_form(n, base):
    """(<Z_q>, purity, TFIM energy) of density_bench from |0><0|: a
    product state whose Bloch vectors turn by the RY angles in the x-z
    plane and shrink by 1 - 4p/3 per depolarizing layer."""
    import numpy as np
    shrink = (1 - 4 * DENSITY_P / 3) ** DENSITY_LAYERS
    theta = DENSITY_LAYERS * (base + 0.01 * np.arange(n))
    z, x = shrink * np.cos(theta), shrink * np.sin(theta)
    purity = float(np.prod((1 + z * z + x * x) / 2))
    energy = float(-np.sum(z * np.roll(z, -1)) - 0.5 * np.sum(x))
    return z, purity, energy


def density_complex(c):
    """The complex carry: H and RZ on every qubit, a CNOT ring, a CRZ,
    amplitude damping and phase flip on every qubit (kinds U, CNOT, CU and
    D2 on both halves of the 2n-bit view)."""
    n = c.num_qubits
    for q in range(n):
        c.h(q)
        c.rz(0.1 + 0.05 * q, q)
    for q in range(n):
        c.cx(q, (q + 1) % n)
    c.crz(0.7, 0, n - 1)
    c.apply_channel("amplitude_damping", 0.05, list(range(n)))
    c.apply_channel("phase_flip", 0.03, list(range(n)))


def density_plan(interpreter, PallasBlock, ir, kernel, df):
    """(passes, names of ops outside a kernel block) of a density flush's
    2n-view IR: ``passes`` as [(specs, gate table, pair bits,
    real_flags)], planned on the carry each block needs (complex once a
    gate is complex); the angles are 0, which changes no plan."""
    import numpy as np
    n2 = ir.num_qubits
    params = np.zeros(max(ir.num_params, 1))
    specs_of = interpreter.pallas_block_specs_df64 if df \
        else interpreter.pallas_block_specs
    passes, outside, complex_carry = [], [], False
    for item in interpreter.plan_items(ir.ops, n2):
        if not isinstance(item, PallasBlock):
            members = getattr(item, "ops", [item])
            outside.append(f"{type(item).__name__}("
                           + ", ".join(op.name for op in members) + ")")
            complex_carry = True
            continue
        kinds, supports, gm, flags = specs_of(item, params)
        complex_carry = complex_carry or not all(flags)
        for p in interpreter.kernel_plan(n2, kinds, supports, kernel,
                                         complex_carry=complex_carry):
            passes.append((tuple((kinds[i],) + tuple(pos) for i, pos in
                                 zip(p.gate_idx, p.positions)),
                           gm[list(p.gate_idx)], p.pair_bits,
                           [flags[i] for i in p.gate_idx]))
    return passes, outside


def density_pass_turns(layer, plain, planes, passes, err_of):
    """Every pass of a density plan through the kernel wrapper against its
    plain version on ``planes`` (the worst error, as ``err_of(got,
    want)``), then the passes timed in turns: (worst, [plain, kernel,
    kernel, plain] ms per pass)."""
    import torch
    worst = 0.0
    for specs, g, pb, fl in passes:
        want = plain(*planes, specs, g, real_flags=fl)
        got = layer(*[None if p is None else p.clone() for p in planes],
                    specs, g, pair_bits=pb, real_flags=fl)
        torch.cuda.synchronize()
        worst = max(worst, err_of(got, want))
        del want, got

    def chain(fn):
        x = [tuple(None if p is None else p.clone() for p in planes)]

        def run(reps):
            for _ in range(reps):
                for specs, g, pb, fl in passes:
                    x[0] = fn(*x[0], specs, g, pair_bits=pb, real_flags=fl)
            return reps * len(passes)
        return run

    return worst, time_turns(chain(layer), chain(plain), 10)


def hermitian_err(re, im, n):
    """max|rho - rho†| on the card, from the planes and their transposed
    (2^n, 2^n) views."""
    dim = 1 << n
    err = float((re.view(dim, dim) - re.view(dim, dim).T).abs().max())
    if im is not None:
        err = max(err, float((im.view(dim, dim)
                              + im.view(dim, dim).T).abs().max()))
    return err


def max_abs(re, im):
    return max(float(re.abs().max()),
               0.0 if im is None else float(im.abs().max()))


def density_phase(rq, interpreter, PallasBlock, fused_sv, fused_df64, df64,
                  rotate, region_dot, dev):
    """Phase 12: the density engine at n = 14 (a 28-bit view) in single
    precision and df64. Returns the density path's launches by kernel and
    the kernels' ms per pass of its plans."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.ops import pairdm

    t_phase = time.perf_counter()
    gib = 1 << 30
    n = DENSITY_N
    n2 = 2 * n
    ops = DENSITY_LAYERS * 2 * n  # the bench's count: a gate or a channel
    sim = rq.Simulator(seed=12, device=dev)
    hamiltonian = tfim(rq, n)

    def request(c, base):
        """One request: reset, queue, flush (timed), read <Z_q>, the TFIM
        energy, the trace and the purity."""
        c.reset()
        density_bench(c, base)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        c.flush()
        stop.record()
        torch.cuda.synchronize()
        t_flush = time.perf_counter() - t0
        re, im = c.state
        z = np.array([c.expval(rq.PauliOperator(f"Z{q}"))
                      for q in range(n)])
        return {"wall": t_flush, "event_ms": start.elapsed_time(stop),
                "z": z, "energy": c.expval(hamiltonian),
                "trace": float(pairdm.trace_pair_dm(re, n)),
                "purity": c.purity(), "real": im is None}

    def report(label, answers, tol, launches):
        for base, a in zip(DENSITY_ANGLES, answers):
            z, purity, energy = density_closed_form(n, base)
            z_err = float(np.abs(a["z"] - z).max())
            p_rel = abs(a["purity"] - purity) / purity
            e_rel = abs(a["energy"] - energy) / abs(energy)
            print(f"density {label} n={n} request RY({base} + 0.01 q): "
                  f"flush {a['wall'] * 1e3:.3f} ms (events "
                  f"{a['event_ms']:.3f} ms) = {ops / a['wall']:.1f} ops/s; "
                  f"max |<Z_q> - closed form| {z_err:.2e}, trace - 1 "
                  f"{a['trace'] - 1:.2e}, purity rel {p_rel:.2e}, TFIM "
                  f"{a['energy']:.9f} (rel {e_rel:.2e}), im None "
                  f"{a['real']}")
            check(a["real"], f"{label} bench rho stays real")
            check(z_err <= tol, f"{label} <Z_q> error {z_err}")
            check(abs(a["trace"] - 1) <= tol, f"{label} trace {a['trace']}")
            check(p_rel <= DENSITY_PURITY_RTOL, f"{label} purity {p_rel}")
            check(e_rel <= DENSITY_PURITY_RTOL, f"{label} TFIM {e_rel}")
        best = min(a["event_ms"] for a in answers)
        per_request = launches / len(answers)
        print(f"density {label}: {per_request:.0f} launches a request, best "
              f"flush {best:.3f} ms (events) = {best / per_request:.4f} ms "
              f"a launch")
        return best, per_request

    # ---- 12.1 f32, n = 14: three requests, closed form, plain layers -----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    circ = rq.DensityCircuit(n, sim)
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    answers = [request(circ, base) for base in DENSITY_ANGLES]
    launches = {"fused_layer": fused_sv.LAUNCHES,
                "fused_layer_init": fused_sv.ZERO_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    check(fused_df64.LAUNCHES == 0, "the f32 density path launched no df64")
    check(launches["fused_layer"] > 0, "the f32 density path launched "
          "rocq_fused_pass")
    check(launches["fused_layer_init"] == len(DENSITY_ANGLES),
          "each density request started from the fill kernel")
    best, per_request = report("f32", answers, DENSITY_TOL,
                               launches["fused_layer"])
    passes, outside = density_plan(interpreter, PallasBlock, circ.last_ir,
                                   fused_sv, df=False)
    bound, bound_by = bound_ms(n2, [(sp, fl) for sp, _, _, fl in passes], 1,
                               complex_state=False, df=False)
    print(f"density f32 plan: {len(passes)} planned passes, ops outside a "
          f"kernel block: {outside or 'none'}; bound per pass {bound:.4f} "
          f"ms ({bound_by}), {bound * len(passes):.3f} ms a flush; "
          f"{best / per_request:.4f} ms a launch; the flush bound is "
          f"{bound * len(passes) / best:.1%} of the flush; peak "
          f"memory {peak / gib:.3f} GiB; launches {launches}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    x = torch.randn(1 << n2, generator=gen, device=dev)
    x /= torch.linalg.vector_norm(x)
    worst, turns = density_pass_turns(
        fused_sv.apply_fused_layer, fused_sv.apply_fused_layer_reference,
        (x, None), passes,
        lambda got, want: max_err(got[0], want[0]) / float(
            want[0].abs().max()))
    del x
    timings = {"fused_layer": min(turns[1], turns[2]),
               "fused_layer_df64": None}
    print(f"density f32 passes, kernel vs plain: worst {worst:.2e} of "
          f"max|x|; ms per pass (plain, kernel, kernel, plain) "
          f"{[round(t, 4) for t in turns]} beside the bound {bound:.4f}")
    check(worst <= DENSITY_TOL, f"density f32 passes: {worst}")
    re, im = circ.state
    with plain_layers(fused_sv, "apply_fused_layer",
                      fused_sv.apply_fused_layer_reference):
        plain = rq.DensityCircuit(n, sim)
        (_, t_plain) = wall(lambda: request(plain, DENSITY_ANGLES[-1]))
        pre, pim = plain.state
    top = max_abs(pre, pim)
    err = max(max_err(re, pre), max_err(im, pim))
    print(f"density f32 vs the plain layers on the card (request "
          f"{DENSITY_ANGLES[-1]}, {t_plain:.2f} s): max abs err {err:.3e} "
          f"= {err / top:.2e} of max|rho|")
    check(pim is None and err <= DENSITY_TOL * top, f"f32 plain: {err}")
    del circ, plain, re, im, pre, pim
    torch.cuda.empty_cache()

    # ---- 12.2 the complex carry ------------------------------------------
    circ = rq.DensityCircuit(n, sim)
    density_complex(circ)
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    _, t_cold = wall(circ.flush)
    complex_launches = fused_sv.LAUNCHES
    circ.reset()
    density_complex(circ)
    _, t_flush = wall(circ.flush)
    re, im = circ.state
    check(im is not None, "the complex workload carries im")
    passes_c, outside_c = density_plan(interpreter, PallasBlock,
                                       circ.last_ir, fused_sv, df=False)
    top = max_abs(re, im)
    herm = hermitian_err(re, im, n)
    trace = float(pairdm.trace_pair_dm(re, n))
    with plain_layers(fused_sv, "apply_fused_layer",
                      fused_sv.apply_fused_layer_reference):
        plain = rq.DensityCircuit(n, sim)
        density_complex(plain)
        pre, pim = plain.state
    err = max(max_err(re, pre), max_err(im, pim))
    del plain, pre, pim
    print(f"density complex carry n={n}: flush {t_flush * 1e3:.3f} ms "
          f"(first, planning included: {t_cold * 1e3:.3f} ms), "
          f"{complex_launches} launches, {len(passes_c)} planned passes, "
          f"outside a kernel block: {outside_c or 'none'}; vs plain layers "
          f"{err / top:.2e} of max|rho|, trace - 1 {trace - 1:.2e}, "
          f"Hermitian to {herm / top:.2e} of max|rho|")
    check(err <= DENSITY_TOL * top, f"complex carry vs plain: {err}")
    check(abs(trace - 1) <= DENSITY_TOL, f"complex carry trace {trace}")
    check(herm <= DENSITY_HERMITIAN_TOL * top, f"Hermitian: {herm}")
    outcome, prob = circ.measure(3)
    for q in range(n):
        circ.ry(0.2 + 0.03 * q, q)
    circ.apply_channel("depolarizing", DENSITY_P, [0, n - 1])
    circ.flush()
    re, im = circ.state
    trace = float(pairdm.trace_pair_dm(re, n))
    herm = hermitian_err(re, im, n) / max_abs(re, im)
    qubits = [0, n // 3, 2 * n // 3, n - 1]
    shots = circ.sample(qubits, DENSITY_SHOTS)
    marg = pairdm.marginal_probs_pair_dm(re, qubits, n).cpu().numpy()
    frac = np.bincount(shots, minlength=1 << len(qubits)) / DENSITY_SHOTS
    worst = float(np.abs(frac - marg).max())
    print(f"density measure(3) -> {outcome} (p {prob:.6f}), then a flush: "
          f"trace - 1 {trace - 1:.2e}, Hermitian to {herm:.2e}; "
          f"{DENSITY_SHOTS} shots on {qubits}: {shots.dtype}, worst "
          f"fraction error {worst:.4f}")
    check(abs(trace - 1) <= DENSITY_TOL, f"trace after measure {trace}")
    check(herm <= DENSITY_HERMITIAN_TOL, f"Hermitian after measure {herm}")
    check(shots.dtype == np.int32 and shots.shape == (DENSITY_SHOTS,),
          f"samples {shots.dtype} {shots.shape}")
    check(worst <= DENSITY_FRACTION_TOL, f"sample fractions {worst}")
    del circ, re, im
    torch.cuda.empty_cache()

    # ---- 12.3 df64, n = 14, and n = 12 against the exact engine ------------
    rq.set_precision("df64")
    try:
        circ = rq.DensityCircuit(n, sim)
        zero_counts(fused_sv, fused_df64, rotate, region_dot)
        answers = [request(circ, base) for base in DENSITY_ANGLES]
        launches["fused_layer_df64"] = fused_df64.LAUNCHES
        check(fused_sv.LAUNCHES == 0, "the df64 density path launched no "
              "f32 pass")
        check(fused_df64.LAUNCHES > 0, "the df64 density path launched "
              "rocq_fused_pass_df64")
        best, per_request = report("df64", answers, DENSITY_DF64_TOL,
                                   fused_df64.LAUNCHES)
        passes_d, outside_d = density_plan(interpreter, PallasBlock,
                                           circ.last_ir, fused_df64,
                                           df=True)
        bound, bound_by = bound_ms(n2, [(sp, fl) for sp, _, _, fl in
                                        passes_d], 2, complex_state=False,
                                   df=True)
        print(f"density df64 plan: {len(passes_d)} planned passes, outside "
              f"a kernel block: {outside_d or 'none'}; bound per pass "
              f"{bound:.4f} ms ({bound_by}); {best / per_request:.4f} ms a "
              f"launch")
        del circ
        torch.cuda.empty_cache()
        x = torch.randn(1 << n2, generator=gen, dtype=torch.float64,
                        device=dev)
        planes = df64.state_from_pair_f64(x / torch.linalg.vector_norm(x),
                                          None)
        del x

        def promoted(planes):
            return planes[0].double() + planes[1].double()

        worst, turns = density_pass_turns(
            fused_df64.apply_fused_layer_df64,
            fused_df64.apply_fused_layer_df64_reference, planes, passes_d,
            lambda got, want: max_err(promoted(got), promoted(want))
            / float(promoted(want).abs().max()))
        del planes
        timings["fused_layer_df64"] = min(turns[1], turns[2])
        print(f"density df64 passes, kernel vs plain: worst {worst:.2e} of "
              f"max|x|; ms per pass (plain, kernel, kernel, plain) "
              f"{[round(t, 4) for t in turns]} beside the bound "
              f"{bound:.4f}")
        check(worst <= DF64_KERNEL_TOL, f"density df64 passes: {worst}")
        torch.cuda.empty_cache()
        nx = DENSITY_EXACT_N
        df_circ = rq.DensityCircuit(nx, sim)
        density_bench(df_circ, DENSITY_ANGLES[0])
        df_re, df_im = df_circ.state
        rq.set_precision("double")
        exact = rq.DensityCircuit(nx, sim)
        density_bench(exact, DENSITY_ANGLES[0])
        (ex_re, ex_im), t_exact = wall(lambda: exact.state)
        err = max(max_err(df_re, ex_re),
                  float(ex_im.abs().max()) if df_im is None
                  else max_err(df_im, ex_im))
        print(f"density df64 n={nx} vs the exact double engine "
              f"({t_exact * 1e3:.1f} ms): max abs err {err:.3e}")
        check(err <= DENSITY_EXACT_TOL, f"df64 vs exact: {err}")
        del df_circ, exact, df_re, df_im, ex_re, ex_im
    finally:
        rq.set_precision("single")
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    print(f"density phase: {elapsed:.1f} s; density launches {launches}")
    return launches, timings


def df64_twins(rq, interpreter, ansatz_ir, df64, pairsim, circ,
               hamiltonian, energy, sim, dev):
    """Phase 13, the df64 readout twins, on phase 7's n = 26 state (the
    last request's, which the df64 kernel produced): the Circuit's float64
    state split into hi/lo planes, read by the twins against the Circuit's
    own readout; then compile_df64_ir of a 2-layer ansatz at n = 22 against
    the fused flush."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    n = circ.num_qubits
    re, im = circ.state
    check(im is None, "phase 7's state is a real carry")
    planes = df64.state_from_pair_f64(re, None)
    terms = [tuple((p, circ._phys(q)) for p, q in ops)
             for ops, _ in hamiltonian.terms]
    coeffs = [float(c) for _, c in hamiltonian.terms]
    got = float(df64.expval_terms_df64(planes, terms, coeffs))
    rel = abs(got - energy) / abs(energy)
    print(f"df64 twins n={n}: expval_terms_df64 {got:.15f} vs the Circuit's "
          f"{energy:.15f}, rel diff {rel:.3e} (limit {TWIN_TOL:.0e})")
    check(rel <= TWIN_TOL, f"expval_terms_df64 {got} vs {energy}")
    norm = float(df64.norm2_df64(planes))
    q = circ._phys(0)
    p1 = float(df64.prob_one_df64(planes, q))
    p1_pair = float(pairsim.prob_one_pair(re, None, q))
    collapsed = df64.collapse_df64(planes, q, 1)
    norm_c = float(df64.norm2_df64(collapsed))
    p1_c = float(df64.prob_one_df64(collapsed, q))
    print(f"df64 twins: norm2 - 1 = {norm - 1:.3e}; prob_one(q0) {p1:.15f} "
          f"(pair readout {p1_pair:.15f}); collapsed to 1: norm2 - 1 = "
          f"{norm_c - 1:.3e}, prob_one - 1 = {p1_c - 1:.3e}")
    check(abs(norm - 1) <= TWIN_TOL and abs(p1 - p1_pair) <= TWIN_TOL
          and abs(norm_c - 1) <= TWIN_TOL and abs(p1_c - 1) <= TWIN_TOL
          and collapsed[2] is None, "df64 norm / prob_one / collapse")
    del collapsed
    qubits = [circ._phys(0), circ._phys(1)]
    draws = df64.sample_df64(planes, qubits, TWIN_SHOTS, sim.generator(dev))
    marg = pairsim.marginal_probs_pair(re, None, qubits).cpu().numpy()
    freq = np.bincount(draws.cpu().numpy(), minlength=4) / TWIN_SHOTS
    gap = float(np.abs(freq - marg).max())
    print(f"df64 twins: sample_df64 {draws.dtype}, {TWIN_SHOTS} shots, "
          f"max |freq - marginal| {gap:.4f} (limit {TWIN_FREQ_TOL})")
    check(draws.dtype == torch.int32 and gap <= TWIN_FREQ_TOL,
          f"sample_df64 dtype {draws.dtype}, gap {gap}")
    del planes, draws

    n = TWIN_IR_N
    ir = ansatz_ir(n, TWIN_IR_LAYERS)
    theta = np.random.default_rng(300).normal(size=ir.num_params)
    fused = interpreter.compile_df64_fused_ir(ir)(
        (interpreter.init_real64(n, dev), None), theta)
    fn = df64.compile_df64_ir(ir)
    start = df64.init_df64(n, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(start[0], start[1], None, None, theta)
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t0
    got_re, got_im = df64.state_to_pair_f64(out)
    err = max_err(got_re, fused[0])
    if fused[1] is not None:
        err = max(err, float(fused[1].abs().max()) if got_im is None
                  else max_err(got_im, fused[1]))
    print(f"compile_df64_ir n={n}, {TWIN_IR_LAYERS} layers "
          f"({len(ir.ops)} ops, op by op) vs the fused flush: max abs err "
          f"{err:.3e} (limit {TWIN_TOL:.0e}), {t_ops * 1e3:.1f} ms; real "
          f"carry kept: {out[2] is None}")
    check(err <= TWIN_TOL and out[2] is None,
          f"compile_df64_ir error {err}")
    print(f"df64 twins: {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def matmul_precision(precision):
    """torch's float32 matmul precision inside the block, "highest" (no
    TF32, the script's setting) after it."""
    import torch
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision("highest")


def best_ms(call, reps=3):
    """Best of ``reps`` single calls after a warm one, CUDA events."""
    import torch
    call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)


def rel_err(got, want):
    """max |got - want| / max |want|, both moved to complex128."""
    import torch
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float((got - want).abs().max() / want.abs().max())


def tensornet_phase(rq, dev):
    """Phase 13: the tensor-network engine on the card (module docstring)."""
    import torch
    from rocquantum_tpu_torch.tensornet import (Tensor, TensorNetwork,
                                                tensor_svd)
    from rocquantum_tpu_torch.tensornet._native_pathfinder import \
        pathfinder_name

    t_phase = time.perf_counter()
    try:
        import opt_einsum
        planners = f"greedy, and opt_einsum {opt_einsum.__version__}"
    except ImportError:
        planners = "greedy only (no opt_einsum: OPTIMAL and AUTO raise)"
    print(f"tensornet: pathfinder {pathfinder_name()}; planners {planners}")
    gen = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape, dtype=torch.complex64):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    # ---- 13.1 the bench ring A(a,b) B(b,c) C(c,a) -> scalar ---------------
    d = TN_DIM
    mats = [rand(d, d) / d for _ in range(3)]

    def ring(tensors):
        tn = TensorNetwork(device=dev)
        for t, labels in zip(tensors, ("ab", "bc", "ca")):
            tn.add_tensor(Tensor(t, tuple(labels)))
        return tn

    tn = ring(mats)
    cfg = {"num_slices": TN_SLICES}
    value = tn.contract(cfg).data
    check(tn.last_num_slices >= TN_SLICES and value.shape == (),
          f"ring slices {tn.last_num_slices}, shape {tuple(value.shape)}")
    ms = best_ms(lambda: tn.contract(cfg))
    one_ms = best_ms(lambda: torch.einsum("ab,bc,ca->", *mats))
    wide = [m.to(torch.complex128) for m in mats]
    ab = wide[0] @ wide[1]
    exact = torch.sum(ab * wide[2].T)
    scale = float(torch.linalg.norm(ab) * torch.linalg.norm(wide[2]))
    err = abs(complex(value) - complex(exact)) / scale
    flops = 8.0 * d ** 3 + 8.0 * d ** 2
    bound = 4.0 * d ** 3 / FP32_INSTR_PER_S * 1e3
    bytes_ms = 3 * d * d * 8 / HBM_BYTES_PER_S * 1e3
    print(f"ring d={d} complex64, {tn.last_num_slices} slices: {ms:.3f} ms "
          f"= {flops / ms / 1e6:.1f} GFLOP/s (8 FLOPs a complex MAC); bound "
          f"{bound:.1f} ms (4 d^3 FP32 FMA instructions at "
          f"{FP32_INSTR_PER_S:.3g}/s; bytes {bytes_ms:.2f} ms); one "
          f"torch.einsum {one_ms:.3f} ms")
    print(f"ring vs complex128 on the card: |diff| / (|AB| |C|) {err:.3e} "
          f"(limit {TN_RING_TOL:.0e})")
    check(err <= TN_RING_TOL, f"ring error {err}")
    tn = None

    # ---- 13.2 precision guard: A(a,b) B(b,c) against complex128 -----------
    guard, plain = {}, {}
    for precision in ("highest", "high"):
        with matmul_precision(precision):
            net = TensorNetwork(device=dev)
            net.add_tensor(Tensor(mats[0], ("a", "b")))
            net.add_tensor(Tensor(mats[1], ("b", "c")))
            guard[precision] = rel_err(net.contract().data, ab)
            plain[precision] = rel_err(mats[0] @ mats[1], ab)
        print(f"precision guard, float32 matmul precision {precision!r}: "
              f"executor {guard[precision]:.3e}, plain torch.matmul "
              f"{plain[precision]:.3e} of max|out| (limit "
              f"{TN_GUARD_TOL:.0e})")
    # the plain product under "high" shows that TF32 was on
    check(max(guard.values()) <= TN_GUARD_TOL < plain["high"],
          f"precision guard {guard}, plain {plain}")
    del ab, exact, net

    # ---- 13.3 the ring under set_precision("double") ----------------------
    rq.set_precision("double")
    try:
        tn = ring(wide)
        value64 = tn.contract(cfg).data
        ms64 = best_ms(lambda: tn.contract(cfg))
    finally:
        rq.set_precision("single")
    bound64 = 8.0 * d ** 3 / FP64_TC_FLOPS * 1e3
    print(f"ring d={d} complex128 (set_precision('double')): {ms64:.3f} ms "
          f"= {flops / ms64 / 1e6:.1f} GFLOP/s; bound {bound64:.1f} ms "
          f"(FP64 tensor cores {FP64_TC_FLOPS:.3g} FLOP/s); value "
          f"{complex(value64):.6e}")
    check(value64.dtype == torch.complex128 and tn.last_num_slices
          >= TN_SLICES, "double ring")
    del tn, wide, mats, value64

    # ---- 13.4 memory-limited slicing, a 512 MiB output --------------------
    a, b = rand(TN_SLICE_DIM, TN_SLICE_K), rand(TN_SLICE_K, TN_SLICE_DIM)
    tn = TensorNetwork(device=dev)
    tn.add_tensor(Tensor(a, ("a", "k")))
    tn.add_tensor(Tensor(b, ("k", "b")))
    full = tn.contract().data
    out_bytes = full.numel() * full.element_size()
    slab = out_bytes // 64
    limit = {"memory_limit": slab}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = tn.compiled_memory_stats(limit)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    slices = tn.last_num_slices
    sliced = tn.contract(limit).data
    err = float((sliced - full).abs().max() / full.abs().max())
    ms_sliced = best_ms(lambda: tn.contract(limit))
    ms_full = best_ms(lambda: tn.contract())
    mib = 1 << 20
    print(f"slicing {TN_SLICE_DIM}x{TN_SLICE_K} . {TN_SLICE_K}x"
          f"{TN_SLICE_DIM}: {slices} slices under {slab / mib:.0f} MiB, "
          f"peak rise {rise / mib:.2f} MiB (output {out_bytes / mib:.0f} MiB "
          f"+ 4 slabs = {(out_bytes + 4 * slab) / mib:.0f}), tally "
          f"{stats.temp_size_in_bytes / mib:.2f} MiB; err vs unsliced "
          f"{err:.3e} of max|out|; sliced {ms_sliced:.3f} ms, unsliced "
          f"{ms_full:.3f} ms")
    check(slices >= 64 and rise <= out_bytes + 4 * slab
          and abs(stats.temp_size_in_bytes - rise) <= slab
          and err <= TN_SLICE_TOL, "memory-limited slicing")
    del tn, full, sliced, a, b

    # contracted-index slicing: x(i,j) y(j,i) -> scalar
    x, y = rand(TN_DIM, TN_DIM), rand(TN_DIM, TN_DIM)
    tn = TensorNetwork(device=dev)
    tn.add_tensor(Tensor(x, ("i", "j")))
    tn.add_tensor(Tensor(y, ("j", "i")))
    limit = {"memory_limit": TN_DIM * TN_DIM * 8 // 8}
    got = tn.contract(limit).data
    slices = tn.last_num_slices
    want = torch.sum(x.to(torch.complex128) * y.to(torch.complex128).T)
    scale = float(torch.linalg.norm(x.to(torch.complex128))
                  * torch.linalg.norm(y.to(torch.complex128)))
    err = abs(complex(got) - complex(want)) / scale
    ms_c = best_ms(lambda: tn.contract(limit))
    print(f"contracted-index slicing x(i,j) y(j,i), d={TN_DIM}: {slices} "
          f"slices, |diff| / (|x| |y|) vs complex128 {err:.3e} (limit "
          f"{TN_RING_TOL:.0e}), {ms_c:.3f} ms")
    check(slices > 1 and got.shape == () and err <= TN_RING_TOL,
          "contracted-index slicing")
    del tn, x, y

    # ---- 13.5 tensor_svd of a (64, 64, 64, 64) tensor ----------------------
    t = Tensor(rand(*TN_SVD_SHAPE), ("a", "b", "c", "d"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, s, v = tensor_svd(t, ["a", "c"], ["b", "d"])
    torch.cuda.synchronize()
    t_svd = time.perf_counter() - t0
    recon = torch.einsum("acs,s,sbd->abcd", u.data, s.data.to(u.data.dtype),
                         v.data)
    err = float((recon - t.data).abs().max() / t.data.abs().max())
    rows = TN_SVD_SHAPE[0] * TN_SVD_SHAPE[2]
    m = t.data.permute(0, 2, 1, 3).reshape(rows, -1)
    s_exact = torch.linalg.svdvals(m.to(torch.complex128), driver="gesvd")
    s_err = float((s.data.double() - s_exact).abs().max() / s_exact.max())
    print(f"tensor_svd {TN_SVD_SHAPE} as {rows}^2: {t_svd:.2f} s; "
          f"reconstruction {err:.3e} of max|T| (limit {TN_SVD_TOL:.0e}); "
          f"singular values vs complex128 {s_err:.3e} of s_max")
    check(err <= TN_SVD_TOL and s_err <= TN_SVD_TOL, "tensor_svd")
    print(f"tensornet phase: {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
