#!/usr/bin/env python3
"""Drive the PyTorch port (rocquantum_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with one CUDA device visible:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions
     and which gate-pass planner runs;
  2. build the six kernels (csrc/fused_sv.cu, fused_df64.cu,
     rotate_bits.cu, region_dot.cu, pauli_readout.cu, adjoint_step.cu)
     from the checkout, one nvcc per source, all started together;
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
     compile_program and the same sweep with the plain layer function
     and the plain adjoint step,
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
  14. the flat-state engine and the program front ends (since their
     port): the n = 29 ring ansatz (phase 4's three angle vectors) through
     compile_ir on a complex64 state, the TFIM energy from the flat state
     against phase 4's, the request cut into split, kernel blocks and join
     (CUDA events), peak memory, and the plan's complex-carry passes
     against the plain version (the first 8), timed beside their bound;
     the QFT's OpenQASM at n = 26 through Compiler against the closed
     form; GHZ n = 29 as OpenQASM through set_target("local"), 4096
     shots; a random circuit at n = 26 with four ops the kernel does not
     take through QuantumSimulator against the per-op engine; Trotter
     evolve of the TFIM at n = 26 (10 steps, order 2) against the plain
     layers; the dsl's QAOA MaxCut at n = 26 against Circuit.expval and
     its density backend with a NoiseModel at n = 14 against
     DensityCircuit; a QuantumSimulator QFT at n = 20 in double against
     the closed form. First (planning) and warm calls are timed apart.
  15. batched and dynamic circuits (since their port):
     Circuit(26, sim, batch_size=8), 2^29 amplitudes, on the ring ansatz
     (8 layers, 43 complex-carry passes, each one launch for the whole
     batch), measure(0) per element, one more RY layer, the TFIM energy
     per element and the marginal over qubits 0-2, twice (first and warm
     calls); each element against an unbatched compile_ir run collapsed
     to its outcome; the flush beside eight unbatched flat flushes; the
     first 4 batched passes against the plain version and every pass
     timed beside its bound; a QFT at n = 20 with b = 4 under "double"
     and a measure against an unbatched exact run; GHZ n = 20 with a
     measured correction (1024 shots, chunks of 128) and teleportation
     (4096 shots) through set_target("local"); both QEC codes for every
     single-qubit error on the card; a checkpoint round trip of a batch
     of 8 at n = 20; PhaseTimer over the parts.
  16. the sharded engine (since its port), on virtual shards of the card
     (make_mesh(k, devices=[cuda:0] * k); over default_mesh() too where
     there are two cards or more): the 8-layer ring at n = 30 over 8
     shards through Circuit(mesh=...) (18 relabels, each one all-to-all
     round, and 108 complex passes, each one launch over the 8 shard
     rows), its rounds timed with CUDA events beside their copy bound,
     the TFIM energy from per-shard partials, one merged restore and one
     gather, against the unsharded flat flush; the sharded fill at its
     (8, 2^27) shape against torch.zeros with [0, 0] set, and the first
     pass on the 8 shard rows against its plain version, within
     SHARD_PASS_RTOL of max|amp|; df64 at n = 26 and exact double (QFT)
     at n = 20 over 4 shards; density n = 14 over 4 (f32 and df64);
     bench.py's ring over a 4-shard mesh; the pinned exchange budget at
     n = 30. In 16.2 and 16.4 a run of its own before the counted one
     holds the path's own kernel calls numbered 0, 1, 3, 7, ... (a df64
     shard's 2^24 planes; the density's 4 rows of 2^26 in f32, a shard's
     2^26 planes in df64) against the plain version on copies of their
     inputs, within SHARD_PASS_RTOL or SHARD_DF64_PASS_RTOL of max|amp|.
  17. the Qiskit, Cirq and PennyLane plugins (since their port) on the
     card, their device defaulting to it, with tests/_stubs on the path
     where a framework is not installed: the n = 29 ring ansatz (phase 4's
     first angle vector) plus a random complex two-qubit unitary as a
     QuantumCircuit, every qubit measured, 4096 shots through
     RocQuantumProvider().get_backend("rocq_simulator"), once with the
     run's own kernel calls 0, 1, 3, 7, ... held to the plain version and
     once counted and timed; get_statevector() against a Circuit(29) of
     the same gates (timed beside its flush) and the counts' marginal over
     qubits 0-2 against the Circuit's; Cirq at n = 26: GHZ plus an RX
     column through the cirq.unitary fallback, simulate_sweep against the
     per-op engine, _run of GHZ with 1024 repetitions (every row
     all-equal); PennyLane at n = 26: RX/RY columns, a CNOT chain and a
     QubitUnitary, analytic_probability(wires=[0, 1, 2]) against the
     Circuit's marginal in the base class's wire order, generate_samples
     at 4096 shots (shape, per-wire means); the flat complex-rho API at
     n = 14 (init_density, apply_gate_dm, apply_channel on bench.py:485's
     workload) against the closed form and DensityCircuit, its trace,
     purity and 4096 int32 sample_dm draws, timed beside the
     DensityCircuit flush; compile_pair_ir of a QFT of a basis state at
     n = 20 against the closed form.
  18. the Pauli readout kernel (csrc/pauli_readout.cu; it replaces no TPU
     kernel) on the TFIM ring at n = 29 on a float32 plane and on a
     float64 plane, and on one shard's 2^30 complex64 amplitudes (the
     .real / .imag views): against the plain per-term readout within
     READOUT_RTOL / DF64_READOUT_RTOL of sum |c|, the same bits on a
     second launch, timed in turns (plain, kernel, kernel, plain) beside
     its byte bound (one read of the planes, fixed by the function and
     the card, not by the kernel's sweeps); ``python3 -c "import
     chip_smoke; chip_smoke.readout_phase()"`` runs it alone.
 19. The f32 kernel's dense two-qubit case (U4, compiled only into
     fused_pass_dense_kernel) at n = 30: the passes of a Quantum Volume
     circuit's plan (30 layers of Haar SU(4)s), the first three against
     the plain version within 1e-5 of max|amp|, the plan timed per pass
     beside a complex pass's byte bound; ``python3 -c "import chip_smoke;
     chip_smoke.dense2q_phase()"`` runs it alone.
 20. the adjoint step kernel (csrc/adjoint_step.cu; it replaces no TPU
     kernel) at n = 26 on the gates the gradient's users send (RY, RX,
     RZ, CRY, RZZ, U3; real and complex planes, controls above and below
     the targets, both target orders): against its plain version (planes
     within ADJOINT_TOL of max|amp|, M within ADJOINT_M_TOL of sum|M|),
     the same bits on a second launch; one step timed in turns beside its
     byte bound (both planes read and written once) and beside the plain
     sequence it replaces (a one-gate fused pass on the ket, the
     plain-torch M sums, a one-gate pass on the bra); ``python3 -c
     "import chip_smoke; chip_smoke.adjoint_step_phase()"`` runs it alone.
 21. A diagonal on global bits of a complex64 state over 4 virtual shards
     of the card, scaled in place a cell (the sharded runner's path) and
     as a diagonal matrix a shard through the flat engine (its path
     before: an upload, a GEMM and a copy back), held to each other at
     n = 26, then timed in turns at the four-card cell's shard size (n =
     32, 2^30 amplitudes a shard) beside the byte bound of one read and
     write of a shard; not part of the run above: ``python3 -c "import
     chip_smoke; chip_smoke.shard_diagonal_phase()"`` runs it.

Each path (phases 4, 7, 9, 11's gradient, 12's f32 and df64 requests,
14's ansatz requests, 15.1's batched requests, 16.1's and 16.2's sharded
flushes, 17's plugin runs, and the probe's R = 2^17 call of each dot) runs
with the launch counts of its engine kernels set to 0 just before it and
read just after. The Pauli readout kernel's count is set to 0 and read
likewise around phase 4's and phase 7's requests, 11.1's first gradient,
11.3's n = 29 replays and 16.1's energy, and checked to be one launch a
readout (a cell a launch on 16.1's shards); the adjoint step kernel's
around 11.1's first gradient, checked to be one launch a parameterized
gate (the adjoint_step row's "gradient_launches"); the kernels line gives these
as the pauli_readout row's "launches", "df64_launches",
"gradient_launches", "replay_launches" and "sharded_launches". The
kernels line gives phase 12's counts as "density_launches" and its ms per
pass of the density plans as "density_ms", phase 14's as
"flat_launches" and its complex pass's times and bound as "flat_ms",
"flat_plain_ms", "flat_bound_ms" and "flat_max_abs_err", and phase
15.1's as "batched_launches", "batched_ms", "batched_plain_ms",
"batched_bound_ms" and "batched_max_abs_err", and phase 16's (16.1 f32
and fill, 16.2 df64) as "sharded_launches" and the largest error of
its checks against the plain version (16.1's fill and pass, 16.2's and
16.4's held calls) as "sharded_max_abs_err", and phase 17's plugin runs'
(17.1-17.3, each with the counts set to 0 just before it) as
"integration_launches" and the largest error of 17.1's held calls as
"integration_max_abs_err".
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
FLAT_CHECKED_PASSES = 8   # flat n = 29 complex passes held to the plain one
FLAT_PLAIN_PASSES = 3     # of them timed on the plain layers
TROTTER_STEPS = 10
FLAT_DOUBLE_N = 20
FLAT_DOUBLE_TOL = 1e-12   # complex128 QFT vs its closed form
BATCH_N = 26          # the JAX package's fp64/df64 width
BATCH = 8             # 8 x 2^26 = 2^29 amplitudes, the flagship's count
BATCH_CHECKED_PASSES = 4  # batched passes held to the plain version
BATCH_PLAIN_PASSES = 2    # of them timed on the plain layers
BATCH_DOUBLE_N = 20
BATCH_DOUBLE = 4
BATCH_DOUBLE_TOL = 1e-12  # batched exact double vs an unbatched run
DYN_GHZ_N = 20
DYN_GHZ_SHOTS = 1024      # 8 chunks of 128 shots at the 2^27 cap
DYN_FRACTION = (0.45, 0.55)
TELEPORT_SHOTS = 4096
TELEPORT_TOL = 0.03       # <Z> of the teleported qubit vs cos(pi/3)
CKPT_N = 20
SHARD_N = 30          # the JAX package's sharded north star, cut to 8 GiB
SHARDS = 8            # virtual shards of one card: 2^27 amplitudes each
SHARD_DF64_N = 26
SHARD_DOUBLE_N = 20
SMALL_SHARDS = 4
SHARD_TOL = 1e-5      # f32 amplitudes: max abs error / max|amp|
SHARD_DOUBLE_TOL = 1e-12
SHARD_PASS_RTOL = 1e-5        # a sharded f32 pass, kernel vs plain, of
SHARD_DF64_PASS_RTOL = 1e-12  # max|amp|; the df64 pass, promoted to f64
INTEGRATION_SHOTS = 4096
INTEGRATION_REPS = 1024       # Cirq _run repetitions
INTEGRATION_TOL = 1e-5        # plugin amplitudes (of max|amp|), probabilities
INTEGRATION_FRACTION_TOL = 0.03  # count and sample marginals
ADJOINT_N = 26            # the benchmark's gradient cell
ADJOINT_TOL = 1e-6        # adjoint step planes, kernel vs plain, of max|amp|
ADJOINT_M_TOL = 1e-9      # its M, kernel vs plain, of sum |M|
READOUT_N = 29            # the benchmark's one-card energy cells
READOUT_SHARD_N = 30      # one card's shard of the four-card cell
READOUT_RTOL = 1e-7       # kernel vs plain readout, of sum |c| (float32)
DF64_READOUT_RTOL = 1e-13  # the same on float64 planes

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
    from rocquantum_tpu_torch.ops import (_build, _native_planner,
                                          adjoint_step, df64, fused_df64,
                                          fused_sv, pairsim, pauli_readout,
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
    kernel_modules = (fused_sv, fused_df64, rotate, region_dot,
                      pauli_readout, adjoint_step)
    with ThreadPoolExecutor(len(kernel_modules)) as pool:
        for job in [pool.submit(m.build) for m in kernel_modules]:
            job.result()
    print(f"build: fused_sv.cu, fused_df64.cu, rotate_bits.cu, "
          f"region_dot.cu, pauli_readout.cu and adjoint_step.cu in parallel "
          f"in {time.perf_counter() - t0:.2f} s")
    for name in ("fused_sv", "fused_df64", "rotate_bits", "region_dot",
                 "pauli_readout", "adjoint_step"):
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

    zero_counts(fused_sv, fused_df64, rotate, region_dot, pauli_readout)
    answers = [answer(theta) for theta in requests]
    launches = fused_sv.LAUNCHES
    init_launches = fused_sv.ZERO_LAUNCHES
    readout_paths = {"launches": pauli_readout.LAUNCHES}
    check(fused_df64.LAUNCHES == 0, "the f32 slice launched no df64 pass")
    check(init_launches > 0, "each request started from the fill launch")
    check(readout_paths["launches"] == REQUESTS,
          f"one readout launch a request: {readout_paths['launches']}")
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
    print(f"fill launches in the main-path run: {init_launches}; readout "
          f"launches {readout_paths['launches']}")

    phase4_energies = [e for e, _, _ in answers]
    df, df64_energy, readout_paths["df64_launches"] = df64_phases(
        rq, interpreter, PallasBlock, hardware_efficient_ansatz_ir, qft_ir,
        df64, fused_df64, fused_sv, pairsim, rng, gen, dev, sim, qft_f32_err)
    rot = rotation_phases(fused_sv, relabel, rotate, rng, gen, dev)
    lane, row = probe_phase(region_dot, fused_sv, gen, dev)
    readout_paths.update(gradient_phase(
        rq, qft_ir, fused_sv, fused_df64, rotate, region_dot, requests,
        phase4_energies, df64_energy, dev))
    density, density_ms = density_phase(rq, interpreter, PallasBlock,
                                        fused_sv, fused_df64, df64, rotate,
                                        region_dot, dev)
    tensornet_phase(rq, dev)
    flat = flat_phase(rq, interpreter, PallasBlock, fused_sv, fused_df64,
                      rotate, region_dot, requests, phase4_energies, dev)
    batched = batched_phase(rq, interpreter, fused_sv, fused_df64, rotate,
                            region_dot, dev)
    shard = sharded_phase(rq, interpreter, fused_sv, fused_df64, rotate,
                          region_dot, dev)
    plugins = integration_phase(rq, interpreter, fused_sv, fused_df64, rotate,
                                region_dot, requests, dev)
    readout_paths["sharded_launches"] = shard["pauli_readout"]
    adjoint_paths = {"gradient_launches":
                     readout_paths.pop("adjoint_step_launches")}
    readout = {**readout_phase(), **readout_paths}
    dense2q = dense2q_phase()
    adjoint = {**adjoint_step_phase(), **adjoint_paths}

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
        "flat_launches": flat["launches"],
        "flat_ms": flat["ms"],
        "flat_plain_ms": flat["plain_ms"],
        "flat_bound_ms": flat["bound_ms"],
        "flat_max_abs_err": flat["max_abs_err"],
        **batched,
        "sharded_launches": shard["fused_layer"],
        "sharded_max_abs_err": shard["errors"]["fused_layer"],
        **plugins,
        **dense2q,
    }, {
        "name": "fused_layer_init",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/fused_sv.cu",
        "replaces": "rocquantum_tpu/ops/pallas_sv.py:1667",
        **init,
        "density_launches": density["fused_layer_init"],
        "sharded_launches": shard["fused_layer_init"],
        "sharded_max_abs_err": shard["errors"]["fused_layer_init"],
    }, {
        "name": "fused_layer_df64",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/fused_df64.cu",
        "replaces": "rocquantum_tpu/ops/pallas_df64.py:240",
        **df,
        "density_launches": density["fused_layer_df64"],
        "density_ms": density_ms["fused_layer_df64"],
        "sharded_launches": shard["fused_layer_df64"],
        "sharded_max_abs_err": shard["errors"]["fused_layer_df64"],
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
    }, {
        "name": "pauli_readout",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/pauli_readout.cu",
        "replaces": None,
        **readout,
    }, {
        "name": "adjoint_step",
        "route": "cuda",
        "source": "rocquantum_tpu_torch/csrc/adjoint_step.cu",
        "replaces": None,
        **adjoint,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def flat_request_parts(interpreter, sv, fused_sv, fn, plan, theta, n, dev):
    """One n-qubit request of the flat path cut into its parts, each timed
    with CUDA events on its own: the split of a complex64 state into
    planes, the plan's kernel blocks on the planes, the join; and the whole
    ``fn(state, theta)`` call. Returns ms by part."""
    import torch
    params = interpreter._host_params(theta)
    state = sv.init_state(n, device=dev)
    out = {"request": best_ms(lambda: fn(state, theta), reps=2),
           "split": best_ms(lambda: sv.state_to_parts(state), reps=2)}
    planes = sv.state_to_parts(state)
    out["join"] = best_ms(lambda: sv.parts_to_state(*planes), reps=2)

    def blocks():
        re, im = planes
        for item in plan:
            re, im = interpreter._run_block((re, im), item, params, n)

    out["kernel"] = best_ms(blocks, reps=2)
    del state, planes
    torch.cuda.empty_cache()
    return out


def flat_phase(rq, interpreter, PallasBlock, fused_sv, fused_df64, rotate,
               region_dot, requests, phase4_energies, dev):
    """Phase 14: the flat-state engine and the program front ends at the
    main path's widths. Returns the flat path's launches and its complex
    pass's times and bound at n = 29."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch import core, dsl
    from rocquantum_tpu_torch.compiler import Compiler
    from rocquantum_tpu_torch.compiler.ir import GateOp
    from rocquantum_tpu_torch.compiler.qasm import to_qasm3
    from rocquantum_tpu_torch.models import (evolve, ghz_ir,
                                             hardware_efficient_ansatz_ir,
                                             qft_ir, random_circuit_ir)
    from rocquantum_tpu_torch.ops import statevec as sv
    from rocquantum_tpu_torch.simulator import QuantumSimulator

    t_phase = time.perf_counter()
    gib = 1 << 30

    # ---- 14.1 the ring ansatz through compile_ir, n = 29 -----------------
    n = ANSATZ_N
    ir = hardware_efficient_ansatz_ir(n, ANSATZ_LAYERS)
    fn = interpreter.compile_ir(ir)
    low, high = interpreter.default_widths(n)
    plan = interpreter.plan_items(ir.ops, n, low_width=low, high_width=high)
    check(all(isinstance(item, PallasBlock) for item in plan),
          "the ansatz plans kernel blocks only")
    passes, specs_of = [], []
    theta0 = interpreter._host_params(requests[0])
    for item in plan:
        kinds, supports, gm, flags = interpreter.pallas_block_specs(item,
                                                                    theta0)
        for kp in interpreter.kernel_plan(n, kinds, supports,
                                          complex_carry=True):
            idx = list(kp.gate_idx)
            specs = tuple((kinds[i],) + tuple(p)
                          for i, p in zip(idx, kp.positions))
            specs_of.append((specs, gm[idx], kp.pair_bits,
                             [flags[i] for i in idx]))
            passes.append((specs, [flags[i] for i in idx]))
    hamiltonian = tfim(rq, n)
    terms = [tuple(ops) for ops, _ in hamiltonian.terms]
    coeffs = [c for _, c in hamiltonian.terms]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    answers = []
    for theta in requests:
        state = sv.init_state(n, device=dev)
        out, t = wall(lambda: fn(state, theta))
        del state
        energy = sum(c * float(sv.expval_pauli_string(out, list(ops)))
                     for ops, c in zip(terms, coeffs))
        norm = float(torch.sum(out.real.square() + out.imag.square(),
                               dtype=torch.float64))
        answers.append((energy, norm, t))
        del out
    launches = fused_sv.LAUNCHES
    check(launches > 0, "the flat path launched the fused kernel")
    check(fused_df64.LAUNCHES == 0 and rotate.LAUNCHES == 0,
          "the flat path launched only the f32 kernel")
    peak = (torch.cuda.max_memory_allocated() - base) / gib
    torch.cuda.empty_cache()
    for r, ((e, nrm, t), ref) in enumerate(zip(answers, phase4_energies)):
        rel = abs(e - ref) / abs(ref)
        print(f"flat request {r}: energy {e:.7f} (phase 4 Circuit {ref:.7f},"
              f" rel diff {rel:.2e}), norm {nrm:.7f}, compile_ir call "
              f"{t * 1e3:.2f} ms")
        check(np.isfinite(e) and rel <= ENERGY_RTOL, f"flat energy {e}")
        check(abs(nrm - 1.0) <= NORM_TOL, f"flat norm {nrm}")
    print(f"flat n={n}: plan {len(plan)} kernel block(s), {len(passes)} "
          f"planned complex-carry passes, {launches} fused launches for "
          f"{len(requests)} requests, peak {peak:.2f} GiB over the "
          f"{base / gib:.2f} GiB held before")
    parts = flat_request_parts(interpreter, sv, fused_sv, fn, plan,
                               requests[0], n, dev)
    print("flat request parts (ms, CUDA events, best of 2): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))

    # every complex-carry pass of the flat plan, kernel against plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    re = torch.randn(1 << n, generator=gen, device=dev)
    im = torch.randn(1 << n, generator=gen, device=dev)
    scale = float(torch.sqrt(torch.sum(re.square() + im.square(),
                                       dtype=torch.float64))) ** -1
    re *= scale
    im *= scale
    worst = 0.0
    for specs, g, pb, fl in specs_of[:FLAT_CHECKED_PASSES]:
        ref = fused_sv.apply_fused_layer_reference(re, im, specs, g,
                                                   real_flags=fl)
        got = fused_sv.apply_fused_layer(re.clone(), im.clone(), specs, g,
                                         pair_bits=pb, real_flags=fl)
        torch.cuda.synchronize()
        err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        worst = max(worst, err)
        check(err <= KERNEL_TOL, f"flat pass {pb}: {err}")
        del ref, got
    checked = min(len(specs_of), FLAT_CHECKED_PASSES)
    print(f"flat kernel vs plain n={n}: {checked} of {len(specs_of)} complex "
          f"passes, max abs err {worst:.3e}")

    def run_passes(fn_layer, limit):
        def run(reps):
            x, y = re.clone(), im.clone()
            for _ in range(reps):
                for specs, g, pb, fl in specs_of[:limit]:
                    x, y = fn_layer(x, y, specs, g, pair_bits=pb,
                                    real_flags=fl)
            return reps * min(limit, len(specs_of))
        return run

    kernel_run = run_passes(fused_sv.apply_fused_layer, len(specs_of))
    plain_run = run_passes(fused_sv.apply_fused_layer_reference,
                           FLAT_PLAIN_PASSES)
    turns = time_turns(kernel_run, plain_run, 2)
    bound, bound_by = bound_ms(n, passes, 2, complex_state=True, df=False)
    print(f"flat complex pass at n={n} (ms, in turns): plain {turns[0]:.4f},"
          f" kernel {turns[1]:.4f}, kernel {turns[2]:.4f}, plain "
          f"{turns[3]:.4f}; bound {bound:.4f} ({bound_by})")
    del re, im
    torch.cuda.empty_cache()
    flat = {"launches": launches, "ms": min(turns[1], turns[2]),
            "plain_ms": min(turns[0], turns[3]), "bound_ms": bound,
            "max_abs_err": worst}

    # ---- 14.2 QFT through Compiler, n = 26 --------------------------------
    n = QFT_N
    x = 0x2A5F3C1 % (1 << n)
    comp = Compiler()
    check(comp.load_module_from_string(to_qasm3(qft_ir(n))),
          "the QFT's OpenQASM loads")
    program = comp.compile()
    out, t_cold = wall(lambda: program(sv.basis_state(n, x, device=dev),
                                       None))
    del out
    out, t = wall(lambda: program(sv.basis_state(n, x, device=dev), None))
    k = torch.arange(1 << n, dtype=torch.int64, device=dev)
    phase = ((x * k) % (1 << n)).to(torch.float64) * (2 * np.pi / (1 << n))
    expected = torch.polar(torch.full_like(phase, (1 << n) ** -0.5), phase)
    err = float((out.to(torch.complex128) - expected).abs().max())
    print(f"Compiler QFT n={n} of |{x}>: first call (plans) "
          f"{t_cold * 1e3:.2f} ms, warm {t * 1e3:.2f} ms, max abs err vs "
          f"closed form {err:.3e}")
    check(err <= QFT_ATOL, f"Compiler QFT error {err}")
    del out, k, phase, expected
    torch.cuda.empty_cache()

    # ---- 14.3 GHZ through the local backend, n = 29 -----------------------
    n = GHZ_N
    core.set_target("local")
    backend = core.get_active_backend()
    job, t = wall(lambda: backend.submit_job(to_qasm3(ghz_ir(n)), GHZ_SHOTS))
    hist = backend.get_job_result(job)
    ones = hist.get("1" * n, 0)
    zeros = hist.get("0" * n, 0)
    print(f"local backend GHZ n={n}: {GHZ_SHOTS} shots in {t * 1e3:.1f} ms, "
          f"all-0 {zeros}, all-1 {ones}")
    check(zeros + ones == GHZ_SHOTS, f"GHZ histogram {sorted(hist)[:4]}")
    check(0.45 <= ones / GHZ_SHOTS <= 0.55, f"GHZ all-1 fraction {ones}")
    check(0.45 <= zeros / GHZ_SHOTS <= 0.55, f"GHZ all-0 fraction {zeros}")
    torch.cuda.empty_cache()

    # ---- 14.4 a random circuit through QuantumSimulator, n = 26 -----------
    n = QFT_N
    circuit = random_circuit_ir(n, 20, 14).ops
    u, _ = np.linalg.qr(np.random.default_rng(14).normal(size=(4, 4))
                        + 1j * np.random.default_rng(15).normal(size=(4, 4)))
    # ops the kernel does not take: a dense two-qubit unitary, a Toffoli,
    # a doubly controlled Z (a diagonal block) and a SWAP
    extra = [GateOp("UNITARY", (2, 5), (), (), u),
             GateOp("UNITARY", (2, n - 6), (), (), u),
             GateOp("MCX", (n - 1,), (1, 7)), GateOp("Z", (12,), (3, n - 2)),
             GateOp("SWAP", (0, n - 1))]
    circuit = circuit + extra + random_circuit_ir(n, 2, 15).ops
    times = []
    for _ in range(2):  # the first call plans, the second finds the plan
        qsim = QuantumSimulator(n)
        for op in circuit:
            qsim._queue.append(op)
        times.append(wall(qsim._flush)[1])
    got = qsim._state
    kinds = interpreter.plan_items(
        interpreter.parametrize(circuit)[0], n,
        low_width=interpreter.default_widths(n)[0],
        high_width=interpreter.default_widths(n)[1])
    counts = {}
    for item in kinds:
        counts[type(item).__name__] = counts.get(type(item).__name__, 0) + 1
    want = interpreter.run_ops_exact(sv.init_state(n, device=dev), circuit)
    err = float((got - want).abs().max()) / float(want.abs().max())
    print(f"QuantumSimulator random n={n}: {len(circuit)} gates, plan "
          f"{counts}, first flush {times[0] * 1e3:.1f} ms, warm "
          f"{times[1] * 1e3:.1f} ms; max abs err vs the plain per-op engine "
          f"{err:.3e} of max|amp|")
    check(err <= KERNEL_TOL, f"QuantumSimulator random error {err}")
    del qsim, got, want
    torch.cuda.empty_cache()

    # ---- 14.5 Trotter evolution of the TFIM, n = 26 -----------------------
    n = QFT_N
    ham = tfim(rq, n)
    out, t_cold = wall(lambda: evolve(sv.init_state(n, device=dev), ham,
                                      0.5, TROTTER_STEPS, 2))
    del out
    out, t = wall(lambda: evolve(sv.init_state(n, device=dev), ham, 0.5,
                                 TROTTER_STEPS, 2))
    with plain_layers(fused_sv, "apply_fused_layer",
                      fused_sv.apply_fused_layer_reference):
        ref, t_ref = wall(lambda: evolve(sv.init_state(n, device=dev), ham,
                                         0.5, TROTTER_STEPS, 2))
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    print(f"evolve TFIM n={n}, {TROTTER_STEPS} steps, order 2: first call "
          f"(plans) {t_cold * 1e3:.1f} ms, warm {t * 1e3:.1f} ms (plain "
          f"layers {t_ref * 1e3:.1f} ms), max abs err {err:.3e} of "
          f"max|amp|")
    check(err <= KERNEL_TOL, f"evolve error {err}")
    del out, ref
    torch.cuda.empty_cache()

    # ---- 14.6 the dsl backends ---------------------------------------------
    n = QFT_N
    gammas, betas = (0.4, 0.7), (0.3, 0.2)

    @dsl.kernel
    def qaoa(g0, b0, g1, b1):
        q = dsl.qvec(QFT_N)
        for i in range(QFT_N):
            dsl.h(q[i])
        for g, b in ((g0, b0), (g1, b1)):
            for i in range(QFT_N):
                j = (i + 1) % QFT_N
                dsl.cnot(q[i], q[j])
                dsl.rz(g, q[j])
                dsl.cnot(q[i], q[j])
            for i in range(QFT_N):
                dsl.rx(b, q[i])

    edges = [f"Z{i} Z{(i + 1) % n}" for i in range(n)]
    cost = dsl.PauliOperator(edges[0])
    for e in edges[1:]:
        cost = cost + dsl.PauliOperator(e)
    binds = {"g0": gammas[0], "b0": betas[0], "g1": gammas[1],
             "b1": betas[1]}
    zero_counts(fused_sv)
    _, t_cold = wall(lambda: dsl.get_expectation_value(
        qaoa, cost, "state_vector", **binds))
    check(fused_sv.LAUNCHES > 0, "the dsl state vector launched the kernel")
    value, t = wall(lambda: dsl.get_expectation_value(
        qaoa, cost, "state_vector", **binds))
    circ = rq.Circuit(n, rq.Simulator(device=dev))
    for i in range(n):
        circ.h(i)
    for g, b in zip(gammas, betas):
        for i in range(n):
            j = (i + 1) % n
            circ.cx(i, j)
            circ.rz(g, j)
            circ.cx(i, j)
        for i in range(n):
            circ.rx(b, i)
    want = circ.expval(rq.PauliOperator({e: 1.0 for e in edges}))
    rel = abs(value - want) / abs(want)
    print(f"dsl QAOA MaxCut n={n} p=2: <sum ZZ> {value:.7f} (Circuit "
          f"{want:.7f}, rel diff {rel:.2e}), first call {t_cold * 1e3:.1f}"
          f" ms, warm {t * 1e3:.1f} ms")
    check(rel <= ENERGY_RTOL, f"dsl QAOA {value} vs {want}")
    del circ
    torch.cuda.empty_cache()

    n = DENSITY_N
    noise = rq.NoiseModel()
    noise.add_channel("depolarizing", 0.01)
    noise.add_channel("amplitude_damping", 0.02, after_op="cnot")

    @dsl.kernel
    def layered(a):
        q = dsl.qvec(DENSITY_N)
        for i in range(DENSITY_N):
            dsl.ry(a + 0.01 * i, q[i])
        for i in range(DENSITY_N - 1):
            dsl.cnot(q[i], q[i + 1])

    ham = tfim(rq, n)
    dham = dsl.PauliOperator("Z0")
    for ops, c in ham.terms:
        dham = dham + dsl.PauliOperator(
            " ".join(f"{p}{q}" for p, q in ops), c)
    zero_counts(fused_sv)
    _, t_cold = wall(lambda: dsl.get_expectation_value(
        layered, dham, "density_matrix", noise_model=noise, a=0.3))
    check(fused_sv.LAUNCHES > 0, "the dsl density backend launched the "
          "kernel")
    value, t = wall(lambda: dsl.get_expectation_value(
        layered, dham, "density_matrix", noise_model=noise, a=0.3))
    dc = rq.DensityCircuit(n, rq.Simulator(device=dev), noise_model=noise)
    for i in range(n):
        dc.ry(0.3 + 0.01 * i, i)
    for i in range(n - 1):
        dc.cx(i, i + 1)
    want = dc.expval(ham) + dc.expval(rq.PauliOperator("Z0"))
    print(f"dsl density n={n} with a NoiseModel: <H> {value:.7f} "
          f"(DensityCircuit {want:.7f}, diff {abs(value - want):.2e}), "
          f"first call {t_cold * 1e3:.1f} ms, warm {t * 1e3:.1f} ms")
    check(abs(value - want) <= DENSITY_TOL, f"dsl density {value} vs {want}")
    del dc
    torch.cuda.empty_cache()

    # ---- 14.7 QuantumSimulator in double precision: QFT, n = 20 -----------
    n = FLAT_DOUBLE_N
    x = 0x5A3C1 % (1 << n)
    rq.set_precision("double")
    try:
        qsim = QuantumSimulator(n)
        for q in range(n):
            if (x >> q) & 1:
                qsim.apply_gate("X", [q])
        for op in qft_ir(n).ops:
            qsim._queue.append(op)
        psi, t = wall(qsim.get_statevector)
    finally:
        rq.set_precision("single")
    kk = np.arange(1 << n, dtype=np.int64)
    closed = np.exp(1j * ((x * kk) % (1 << n)) * (2 * np.pi / (1 << n))) \
        / np.sqrt(1 << n)
    err = float(np.abs(psi - closed).max())
    print(f"QuantumSimulator double QFT n={n}: {t * 1e3:.1f} ms, max abs err "
          f"vs closed form {err:.3e}")
    check(err <= FLAT_DOUBLE_TOL, f"double QFT error {err}")
    print(f"flat phase: {time.perf_counter() - t_phase:.1f} s")
    return flat


def df64_phases(rq, interpreter, PallasBlock, ansatz_ir, qft_ir, df64,
                fused_df64, fused_sv, pairsim, rng, gen, dev, sim,
                qft_f32_err):
    """Phases 6 and 7: the df64 kernel against its plain version on the
    card, then the double-precision slice at n = 26. Returns the df64
    kernel's numbers for the kernels line, the first request's energy and
    the slice's Pauli readout launches."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.ops import pauli_readout

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
    fused_sv.LAUNCHES = fused_df64.LAUNCHES = pauli_readout.LAUNCHES = 0
    answers = [answer(circ, theta, True) for theta in requests]
    launches = fused_df64.LAUNCHES
    readout_launches = pauli_readout.LAUNCHES
    check(launches > 0, "the df64 slice launched the df64 kernel")
    check(fused_sv.LAUNCHES == 0, "the df64 slice launched no f32 pass")
    check(readout_launches == REQUESTS,
          f"one df64 readout launch a request: {readout_launches}")
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
    print(f"df64 launches in the main-path run: {launches}; readout "
          f"launches {readout_launches}")
    print(f"df64 phases: {time.perf_counter() - t_phases:.1f} s")
    return {"launches": launches, "max_abs_err": worst,
            "ms": min(turns[1], turns[2]), "plain_ms": min(turns[0], turns[3]),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}, \
        e0, readout_launches


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


def sync_all():
    """Wait for every CUDA device."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall(fn):
    """(result, seconds) of ``fn()``, every device synchronized on both
    ends."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def gradient_phase(rq, qft_ir, fused_sv, fused_df64, rotate, region_dot,
                   requests, phase4_energies, df64_energy, dev):
    """Phase 11: the kernel front end, compiled programs and adjoint
    gradients at the main path's widths. Returns the Pauli readout
    launches of 11.1's first gradient and 11.3's n = 29 replays."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.ops import adjoint_step, pauli_readout

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
    zero_counts(fused_sv, fused_df64, rotate, region_dot, pauli_readout,
                adjoint_step)
    (value, grads), t_first = wall(lambda: rq.adjoint_grad(
        ring, n, sim, theta, hamiltonian, return_value=True))
    launches = (fused_sv.LAUNCHES, fused_sv.ZERO_LAUNCHES,
                fused_sv.INIT_LAUNCHES, fused_df64.LAUNCHES)
    readouts = {"gradient_launches": pauli_readout.LAUNCHES,
                "adjoint_step_launches": adjoint_step.LAUNCHES}
    check(readouts["gradient_launches"] == 1,
          f"the gradient's forward energy is one readout launch: {readouts}")
    check(readouts["adjoint_step_launches"] == params,
          f"one adjoint step launch a parameterized gate ({params}): "
          f"{readouts}")
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
                      fused_sv.apply_fused_layer_reference), \
            plain_layers(adjoint_step, "apply",
                         lambda *a: adjoint_step.apply_reference(*a[:5])):
        before = (fused_sv.LAUNCHES, adjoint_step.LAUNCHES)
        (plain_v, plain_g), t_plain = wall(lambda: rq.adjoint_grad(
            ring, n, sim, theta, hamiltonian, return_value=True))
        check((fused_sv.LAUNCHES, adjoint_step.LAUNCHES) == before,
              "plain sweep launched no pass and no adjoint step")
    diff = float(np.abs(plain_g - grads).max())
    rel = abs(plain_v - value) / abs(plain_v)
    print(f"gradient n={n} vs the same sweep with plain layers "
          f"({t_plain:.1f} s): max abs diff {diff:.2e}, value rel diff "
          f"{rel:.2e}")
    check(diff <= GRAD_PLAIN_ATOL and rel <= ENERGY_RTOL,
          f"plain layers: {diff}, {rel}")


    # ---- 11.3 compile_program replays -------------------------------------
    zero_counts(pauli_readout)
    replayed = [prog.run(r) for r in requests]
    readouts["replay_launches"] = pauli_readout.LAUNCHES
    check(readouts["replay_launches"] == len(requests),
          f"one readout launch a replay: {readouts}")
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
    print(f"gradient phase: {time.perf_counter() - t_phase:.1f} s; readout "
          f"launches {readouts}")
    return readouts


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


def batched_pass_parts(interpreter, ir, theta, n, b):
    """(specs_of, passes) of the complex-carry passes that a batched flush
    of ``ir`` plans: the kernel's arguments for each pass and, for the
    bound, its specs and real flags."""
    low, high = interpreter.default_widths(n)
    plan = interpreter.plan_items(ir.ops, n, low_width=low, high_width=high)
    params = interpreter._host_params(theta)
    specs_of, passes = [], []
    for item in plan:
        kinds, supports, gm, flags = interpreter.pallas_block_specs(item,
                                                                    params)
        for kp in interpreter.kernel_plan(n, kinds, supports,
                                          complex_carry=True):
            idx = list(kp.gate_idx)
            specs = tuple((kinds[i],) + tuple(p)
                          for i, p in zip(idx, kp.positions))
            fl = [flags[i] for i in idx]
            specs_of.append((specs, gm[idx], kp.pair_bits, fl))
            passes.append((specs, fl))
    return plan, specs_of, passes


@contextlib.contextmanager
def recording_batches(fused_sv, seen):
    """Record the batch of every fused-layer call (the wrapper still
    launches the kernel)."""
    kernel_fn = fused_sv.apply_fused_layer

    def recording(re, im, *args, **kwargs):
        seen.append(1 if re is None or re.dim() == 1 else re.shape[0])
        return kernel_fn(re, im, *args, **kwargs)

    fused_sv.apply_fused_layer = recording
    try:
        yield
    finally:
        fused_sv.apply_fused_layer = kernel_fn


def batched_phase(rq, interpreter, fused_sv, fused_df64, rotate, region_dot,
                  dev):
    """Phase 15: batched circuits (Circuit(n, sim, batch_size=b)) on the
    batched fused kernel, batched exact double, dynamic circuits through
    the local backend, QEC, checkpoints and phase timers. Returns the
    batched path's launches and its pass's times, bound and error."""
    import os

    import numpy as np
    import torch
    from rocquantum_tpu_torch import core, qec
    from rocquantum_tpu_torch.compiler.dynamic import expval_z_dynamic
    from rocquantum_tpu_torch.compiler.ir import CircuitIR
    from rocquantum_tpu_torch.compiler.qasm_parser import parse_qasm3_program
    from rocquantum_tpu_torch.models import (hardware_efficient_ansatz_ir,
                                             qft_ir)
    from rocquantum_tpu_torch.ops import pairsim
    from rocquantum_tpu_torch.ops import statevec as sv
    from rocquantum_tpu_torch.utils import checkpoint
    from rocquantum_tpu_torch.utils.profiling import PhaseTimer

    t_phase = time.perf_counter()
    timer = PhaseTimer(device=dev)
    gib = 1 << 30

    # ---- 15.1 the batched f32 path at full width -------------------------
    n, b = BATCH_N, BATCH
    rng = np.random.default_rng(15)
    theta = rng.normal(size=n * ANSATZ_LAYERS).astype(np.float32)
    tail = rng.normal(size=n).astype(np.float32)
    hamiltonian = tfim(rq, n)
    terms = [tuple(ops) for ops, _ in hamiltonian.terms]
    coeffs = [c for _, c in hamiltonian.terms]
    ir = hardware_efficient_ansatz_ir(n, ANSATZ_LAYERS)
    plan, specs_of, passes = batched_pass_parts(interpreter, ir, theta, n,
                                                b)
    sim = rq.Simulator(seed=15, device=dev)
    circ = rq.Circuit(n, sim, batch_size=b)

    def ansatz():
        k = 0
        for _ in range(ANSATZ_LAYERS):
            for q in range(n):
                circ.ry(float(theta[k]), q)
                k += 1
            for q in range(n):
                circ.cx(q, (q + 1) % n)

    def request():
        """flush (timed), measure(0), an RY layer, energies, marginal."""
        circ.reset()
        ansatz()
        before = fused_sv.BATCHED_LAUNCHES
        _, t = wall(circ.flush)
        flush_launches = fused_sv.BATCHED_LAUNCHES - before
        outcomes, probs = circ.measure(0)
        for q in range(n):
            circ.ry(float(tail[q]), q)
        energies, t_e = wall(lambda: circ.expval(hamiltonian))
        marg = circ.get_probabilities([0, 1, 2])
        return t, flush_launches, outcomes, probs, energies, t_e, marg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    with timer.phase("15.1 batched f32"):
        t_first, first_launches, *_ = request()
        (t_warm, warm_launches, outcomes, probs, energies, t_e,
         marg) = request()
    launches = fused_sv.LAUNCHES
    batched_launches = fused_sv.BATCHED_LAUNCHES
    peak = (torch.cuda.max_memory_allocated() - base) / gib
    check(first_launches == warm_launches == len(specs_of),
          f"the batched flush launched {first_launches} times for "
          f"{len(specs_of)} planned passes")
    check(launches == batched_launches and launches > 2 * len(specs_of),
          "every launch of the batched path covered the batch")
    check(fused_df64.LAUNCHES == 0 and rotate.LAUNCHES == 0,
          "the batched path launched only the f32 kernel")
    check(marg.shape == (b, 8) and energies.shape == (b,),
          "batched readouts are per element")
    state = circ.state
    check(state.shape == (b, 1 << n) and state.dtype == torch.complex64,
          "the batched f32 state is complex64 (b, 2^n)")
    # each element against an unbatched compile_ir run, collapsed to its
    # outcome, then the same RY layer
    fn = interpreter.compile_ir(ir)
    layer = CircuitIR(n)
    for q in range(n):
        layer.add("RY", [q], params=[float(tail[q])])
    tail_fn = interpreter.compile_ir(layer)
    ref = fn(sv.init_state(n, device=dev), theta)
    worst, worst_rel = 0.0, 0.0
    for o in sorted(set(int(x) for x in outcomes)):
        ref_o = tail_fn(sv.collapse(ref, 0, o))
        e_ref = float(pairsim.expval_terms_pair(ref_o.real, ref_o.imag,
                                                terms, coeffs))
        top = float(ref_o.abs().max())
        for k in np.flatnonzero(outcomes == o):
            err = float((state[k] - ref_o).abs().max()) / top
            rel = abs(float(energies[k]) - e_ref) / abs(e_ref)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        del ref_o
    del ref
    check(worst <= KERNEL_TOL, f"batched element error {worst}")
    check(worst_rel <= ENERGY_RTOL, f"batched energy rel error {worst_rel}")
    print(f"batched n={n} b={b}: plan {len(plan)} kernel block(s), "
          f"{len(specs_of)} complex passes, the flush launched "
          f"{first_launches} (not {b} x), {launches} launches in the run "
          f"(2 requests), all batched; outcomes {outcomes.tolist()}, probs "
          f"{np.round(probs, 6).tolist()}; elements within {worst:.3e} of "
          f"max|amp| of unbatched compile_ir runs, energies within "
          f"{worst_rel:.2e} relative; peak {peak:.2f} GiB over the "
          f"{base / gib:.2f} GiB held before")
    print(f"batched flush: first (plans) {t_first * 1e3:.2f} ms, warm "
          f"{t_warm * 1e3:.2f} ms; energies {t_e * 1e3:.2f} ms; marginal "
          f"row 0 {np.round(marg[0], 4).tolist()}")
    del state, circ
    torch.cuda.empty_cache()
    # eight unbatched flat flushes of the same circuit
    flat_start = sv.init_state(n, device=dev)

    def eight():
        for _ in range(b):
            out = fn(flat_start, theta)
            del out

    _, t_eight = wall(eight)
    _, t_eight_2 = wall(eight)
    del flat_start
    torch.cuda.empty_cache()
    print(f"8 unbatched flat flushes at n={n}: {t_eight * 1e3:.2f}, "
          f"{t_eight_2 * 1e3:.2f} ms (batched warm flush "
          f"{t_warm * 1e3:.2f} ms, ratio "
          f"{t_warm / min(t_eight, t_eight_2):.3f})")

    # the batched passes, kernel against plain, timed in turns
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    re = torch.randn((b, 1 << n), generator=gen, device=dev)
    im = torch.randn((b, 1 << n), generator=gen, device=dev)
    scale = torch.rsqrt(pairsim.norm2_pair(re, im)).to(torch.float32)
    re *= scale[:, None]
    im *= scale[:, None]
    err_max = 0.0
    for specs, g, pb, fl in specs_of[:BATCH_CHECKED_PASSES]:
        ref = fused_sv.apply_fused_layer_reference(re, im, specs, g,
                                                   real_flags=fl)
        got = fused_sv.apply_fused_layer(re.clone(), im.clone(), specs, g,
                                         pair_bits=pb, real_flags=fl)
        torch.cuda.synchronize()
        err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        err_max = max(err_max, err)
        check(err <= KERNEL_TOL, f"batched pass {pb}: {err}")
        del ref, got
    print(f"batched kernel vs plain n={n} b={b}: {BATCH_CHECKED_PASSES} of "
          f"{len(specs_of)} passes, max abs err {err_max:.3e}")

    def run_passes(fn_layer, limit):
        def run(reps):
            x, y = re.clone(), im.clone()
            for _ in range(reps):
                for specs, g, pb, fl in specs_of[:limit]:
                    x, y = fn_layer(x, y, specs, g, pair_bits=pb,
                                    real_flags=fl)
            return reps * min(limit, len(specs_of))
        return run

    turns = time_turns(run_passes(fused_sv.apply_fused_layer, len(specs_of)),
                       run_passes(fused_sv.apply_fused_layer_reference,
                                  BATCH_PLAIN_PASSES), 2)
    # b elements: b times one state's bytes and operations
    bound, bound_by = bound_ms(n, passes, 2, complex_state=True, df=False)
    bound *= b
    print(f"batched complex pass n={n} b={b} (ms, in turns): plain "
          f"{turns[0]:.4f}, kernel {turns[1]:.4f}, kernel {turns[2]:.4f}, "
          f"plain {turns[3]:.4f}; bound {bound:.4f} ({bound_by})")
    del re, im
    torch.cuda.empty_cache()
    batched = {"batched_launches": batched_launches,
               "batched_ms": min(turns[1], turns[2]),
               "batched_plain_ms": min(turns[0], turns[3]),
               "batched_bound_ms": bound,
               "batched_max_abs_err": err_max}

    # ---- 15.2 batched exact double ---------------------------------------
    n, b = BATCH_DOUBLE_N, BATCH_DOUBLE
    x = 0x5A3C7 % (1 << n)
    with timer.phase("15.2 batched double"):
        rq.set_precision("double")
        try:
            circs = (rq.Circuit(n, rq.Simulator(seed=16, device=dev),
                                batch_size=b),
                     rq.Circuit(n, rq.Simulator(device=dev)))
            for c in circs:
                for q in range(n):
                    if (x >> q) & 1:
                        c.x(q)
                for op in qft_ir(n).ops:
                    c._enqueue(op.name, op.targets, op.controls, op.params)
            (got_out, _), t_double = wall(lambda: circs[0].measure(0))
            check(isinstance(circs[0].state, tuple)
                  and circs[0].state[0].dtype == torch.float64,
                  "the batched double state is a float64 pair")
            got = circs[0].get_statevector()
            want = circs[1].get_statevector()
        finally:
            rq.set_precision("single")
    err = 0.0
    for k in range(b):
        o = int(got_out[k])
        ref = want.reshape(-1, 2).copy()  # (rest, qubit 0)
        ref[:, 1 - o] = 0
        ref = ref.reshape(-1) / np.linalg.norm(ref)
        err = max(err, float(np.abs(got[k] - ref).max()))
    check(err <= BATCH_DOUBLE_TOL, f"batched double error {err}")
    print(f"batched double QFT n={n} b={b} then measure(0): outcomes "
          f"{got_out.tolist()}, {t_double * 1e3:.1f} ms, every element within"
          f" {err:.3e} of an unbatched exact-double run collapsed the same "
          f"way")
    del circs, got, want
    torch.cuda.empty_cache()

    # ---- 15.3 dynamic circuits through the local backend -----------------
    n = DYN_GHZ_N
    text = (f"OPENQASM 3.0;\nqubit[{n}] q;\nbit[1] c;\nh q[0];\n"
            + "".join(f"cx q[{q}], q[{q + 1}];\n" for q in range(n - 1))
            + "c[0] = measure q[0];\nif (c[0] == 1) {\n"
            + "".join(f"x q[{q}];\n" for q in range(1, n)) + "}\n")
    core.set_target("local")
    backend = core.get_active_backend()
    seen = []
    with timer.phase("15.3 dynamic"), recording_batches(fused_sv, seen):
        job, t_ghz = wall(lambda: backend.submit_job(text, DYN_GHZ_SHOTS))
        hist = backend.get_job_result(job)
        teleport = parse_qasm3_program(TELEPORT_QASM)
        ez, t_tel = wall(lambda: expval_z_dynamic(teleport, 2, TELEPORT_SHOTS,
                                                  seed=15, device=dev))
    zeros, ones = hist.get("0" * n, 0), hist.get("0" * (n - 1) + "1", 0)
    check(zeros + ones == DYN_GHZ_SHOTS, f"GHZ keys {sorted(hist)[:4]}")
    for count in (zeros, ones):
        check(DYN_FRACTION[0] <= count / DYN_GHZ_SHOTS <= DYN_FRACTION[1],
              f"corrected GHZ fraction {count}")
    check(max(seen) == 128, f"the dynamic GHZ ran batches {sorted(set(seen))}")
    check(abs(ez - np.cos(np.pi / 3)) <= TELEPORT_TOL,
          f"teleportation <Z> {ez}")
    print(f"dynamic GHZ n={n} with correction, {DYN_GHZ_SHOTS} shots in "
          f"chunks of {max(seen)}: {t_ghz * 1e3:.1f} ms, 0...0 {zeros}, "
          f"0...01 {ones}; teleportation {TELEPORT_SHOTS} shots: <Z> "
          f"{ez:.4f} (cos(pi/3) = 0.5) in {t_tel * 1e3:.1f} ms")
    torch.cuda.empty_cache()

    # ---- 15.4 QEC, checkpoint, phase timers -------------------------------
    with timer.phase("15.4 qec"):
        qec_cases = qec_on_the_card(rq, qec, dev)
    print(f"QEC on the card: {qec_cases} single-error cases, every syndrome "
          f"as the decoders' tables")
    n, b = CKPT_N, BATCH
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "batch.npz")
    with timer.phase("15.4 checkpoint"):
        c = rq.Circuit(n, rq.Simulator(seed=17, device=dev), batch_size=b)
        for q in range(n):
            c.ry(0.1 * (q + 1), q)
            c.rz(0.05 * q, q)
        c.measure(3)
        c.flush()
        checkpoint.save_circuit_checkpoint(path, c)
        c2 = rq.Circuit(n, rq.Simulator(device=dev), batch_size=b)
        checkpoint.restore_circuit_checkpoint(path, c2)
        check(torch.equal(c2.state, c.state),
              "the batched checkpoint round trip is bit-exact")
    os.remove(path)
    print(f"checkpoint of a batch of {b} at n={n}: round trip bit-exact")
    for name, row in timer.summary().items():
        print(f"phase timer {name}: {row['total_s'] * 1e3:.1f} ms")
    print(f"batched phase: {time.perf_counter() - t_phase:.1f} s")
    return batched


TELEPORT_QASM = """
OPENQASM 3.0;
include "stdgates.inc";
gate prep(theta) a {
    ry(theta) a;
}
gate bellpair a, b {
    h a;
    cx a, b;
}
qubit[3] q;
bit[2] c;
prep(1.0471975511965976) q[0];
bellpair q[1], q[2];
cx q[0], q[1];
h q[0];
c[0] = measure q[0];
c[1] = measure q[1];
if (c[1] == 1) {
    x q[2];
}
if (c[0] == 1) {
    z q[2];
}
"""


def qec_on_the_card(rq, qec, dev):
    """Both codes, no error and every single-qubit X, Z and Y error on a
    data qubit: the measured syndrome equals the decoder's table (the
    repetition code reads X parity only: a Z error reads [0, 0]; the
    Steane code's two triples read the X and the Z part's position).
    Returns the number of cases."""
    sim = rq.Simulator(seed=1, device=dev)
    exp = qec.QEC_Experiment(sim)

    def steane_zero(q):
        for piv, rest in ((0, (2, 4, 6)), (1, (2, 5, 6)), (3, (4, 5, 6))):
            q.h(piv)
            for d in rest:
                q.cx(piv, d)

    rep_x = {0: [1, 0], 1: [1, 1], 2: [0, 1]}
    cases = 0
    for code, decoder, data, n, ancillas, prep in (
            (qec.ThreeQubitRepetitionCode(), qec.RepetitionCodeDecoder(), 3,
             5, [3, 4], None),
            (qec.SteaneCode(), qec.SteaneDecoder(), 7, 13,
             list(range(7, 13)), steane_zero)):
        for kind, q in [(None, None)] + [(k, q) for k in "xzy"
                                         for q in range(data)]:
            def kern(c, _k=kind, _q=q, _p=prep):
                if _p is not None:
                    _p(c)
                if _k is not None:
                    getattr(c, _k)(_q)
            result = exp.run_single_round(code, decoder, rq.kernel(kern), n,
                                          ancillas)
            if data == 3:
                want = [0, 0] if kind in (None, "z") else rep_x[q]
            else:
                pos = [0, 0, 0] if kind is None else \
                    [((q + 1) >> j) & 1 for j in range(3)]
                zero = [0, 0, 0]
                want = (pos if kind in ("x", "y") else zero) + \
                    (pos if kind in ("z", "y") else zero)
            check(result["syndrome"] == want,
                  f"{type(code).__name__} {kind}{q}: {result['syndrome']}")
            if kind is not None and (data == 7 or kind != "z"):
                check(f"{kind.upper()}{q}" in result["correction_applied"]
                      or (data == 3 and kind == "y"),
                      f"{type(code).__name__} {kind}{q} correction")
            cases += 1
    return cases


class _HostTimer:
    """The start or stop of a round timed on the host after a
    synchronization of every device (``elapsed_time`` as an event's)."""

    def record(self):
        sync_all()
        self.t = time.perf_counter()

    def elapsed_time(self, stop):
        return (stop.t - self.t) * 1e3


@contextlib.contextmanager
def timed_exchanges(sharded, log, host=False):
    """Record the time and moved bytes of every relabel of a sharded state
    (``log`` gets (start, stop, bytes) per round): CUDA events on the
    current device, which do not synchronize, or (``host``, for shards on
    several cards) host time between synchronizations of every device."""
    import torch
    inner = sharded.permute_bits

    def timed(*args, **kwargs):
        start, stop = (_HostTimer(), _HostTimer()) if host else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
        before = sharded.BYTES_MOVED
        start.record()
        out = inner(*args, **kwargs)
        stop.record()
        log.append((start, stop, sharded.BYTES_MOVED - before))
        return out

    sharded.permute_bits = timed
    try:
        yield
    finally:
        sharded.permute_bits = inner


@contextlib.contextmanager
def held_to_plain(module, name, plain, promote, errs):
    """Hold the calls of ``module.name`` numbered 2^j - 1 in the block (0,
    1, 3, 7, ...: early and late passes, several shards) against ``plain``
    on copies of the same inputs. These are the path's own launches; the
    plain version launches nothing. ``errs`` gets (call, shape, max abs
    error, max|plain output|) per held call, the planes read through
    ``promote``."""
    import torch
    kernel_fn = getattr(module, name)
    calls = [0]

    def held(*args, **kwargs):
        k = calls[0]
        calls[0] += 1
        if k & (k + 1):
            return kernel_fn(*args, **kwargs)
        ins = [a.clone() if torch.is_tensor(a) else a for a in args]
        got = kernel_fn(*args, **kwargs)
        want = plain(*ins, **kwargs)
        del ins
        err = top = 0.0
        for a, b in zip(promote(got), promote(want)):
            if b is not None:
                err = max(err, float((a - b).abs().max()))
                top = max(top, float(b.abs().max()))
        errs.append((k, None if args[0] is None else tuple(args[0].shape),
                     err, top))
        return got

    setattr(module, name, held)
    try:
        yield calls
    finally:
        setattr(module, name, kernel_fn)


def held_report(what, errs, calls, rtol):
    """Check every held call of :func:`held_to_plain` within ``rtol`` of
    max|amp| and print them; returns the largest absolute error."""
    check(errs, f"{what}: no call held to the plain version")
    for k, shape, err, top in errs:
        check(err <= rtol * top, f"{what}: call {k} on {shape}: {err} "
              f"of max|amp| {top}")
    worst = max(err / top if top else err for _, _, err, top in errs)
    print(f"{what}: calls {[k for k, *_ in errs]} of {calls[0]} (shapes "
          f"{sorted({str(shape) for _, shape, _, _ in errs})}) held to the plain "
          f"version: max abs err {max(e for *_, e, _ in errs):.3e}, at most "
          f"{worst:.3e} of max|amp| (limit {rtol:g})")
    return max(e for *_, e, _ in errs)


def sharded_plan(interpreter, PallasBlock, kernel, ir, n, n_global):
    """(relabels, planned passes, their launches, plan) of a sharded flush
    of ``ir`` from the identity layout on ``kernel`` (ops/fused_sv.py: the
    complex carry of the f32 flush, with its low block; ops/fused_df64.py:
    the df64 real carry): the relabel ops the scheduler emits, the kernel
    passes the local plan makes and the launches they take."""
    from rocquantum_tpu_torch.compiler.sharded_schedule import \
        schedule_for_sharding
    ops, _ = interpreter.parametrize(ir.ops)
    sched, _ = schedule_for_sharding(ops, n, n_global)
    L = n - n_global
    f32 = kernel.__name__.endswith("fused_sv")
    low = min(interpreter.default_widths(n, sharded=True)[0], L) if f32 \
        else 0
    plan = interpreter.plan_items(sched, L, low_width=low)
    passes = launches = 0
    for item in plan:
        if not isinstance(item, PallasBlock):
            continue
        kinds, supports = zip(*(interpreter._classify_spec(op)
                                for op in item.ops))
        for kp in interpreter.kernel_plan(L, kinds, supports, kernel,
                                          complex_carry=f32):
            specs = tuple((kinds[i],) + tuple(p)
                          for i, p in zip(kp.gate_idx, kp.positions))
            passes += 1
            launches += len(
                kernel.pass_schedule(L, specs, True, kernel.F32_RULE)
                if f32 else kernel.pass_schedule(L, specs, False))
    relabels = sum(op.name in ("SWAP_BITS", "PERMUTE_BITS") for op in sched)
    return relabels, passes, launches, plan


def sharded_phase(rq, interpreter, fused_sv, fused_df64, rotate, region_dot,
                  dev):
    """Phase 16: the sharded engine on virtual shards of the card
    (``make_mesh(k, devices=[cuda:0] * k)``): an f32 Circuit at n = 30 over
    8 shards against the unsharded flat path, df64 at n = 26 and exact
    double at n = 20 over 4, density at n = 14 over 4 (f32 and df64), a
    mesh-spread tensor-network ring and the pinned exchange budget at n =
    30. Returns the launches of the sharded f32, fill and df64 paths and
    of 16.1's Pauli readout."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.compiler.passes import PallasBlock
    from rocquantum_tpu_torch.models import qft_ir
    from rocquantum_tpu_torch.ops import df64, pairsim, pauli_readout
    from rocquantum_tpu_torch.ops import statevec as sv
    from rocquantum_tpu_torch.parallel import (default_mesh, make_mesh,
                                               sharded)
    from rocquantum_tpu_torch.tensornet import Tensor, TensorNetwork

    t_phase = time.perf_counter()
    gib = 1 << 30
    rq.set_precision("single")

    # ---- 16.1 f32 Circuit, n = 30 over 8 shards ---------------------------
    n, k = SHARD_N, SHARDS
    mesh = make_mesh(k, devices=[dev] * k)
    rng = np.random.default_rng(16)
    theta = rng.normal(size=n * ANSATZ_LAYERS)
    ir = rq.trace_kernel(ring_kernel, n, *theta)
    hamiltonian = tfim(rq, n)
    terms = [tuple(ops) for ops, _ in hamiltonian.terms]
    coeffs = [c for _, c in hamiltonian.terms]
    n_global = sharded.num_global_qubits(mesh)
    relabels, passes, planned_launches, plan = sharded_plan(
        interpreter, PallasBlock, fused_sv, ir, n, n_global)

    def request(circ, log, seen, host=False):
        circ.reset()
        ring_kernel(circ, *theta)
        with timed_exchanges(sharded, log, host), \
                recording_batches(fused_sv, seen):
            _, t = wall(circ.flush)
        return t

    # the sharded fill at its (8, 2^27) shape against its plain version
    filled = sharded.init_state(n, sharded.state_sharding(mesh),
                                torch.complex64, "complex").parts[0][0]
    plain = torch.zeros((k, 1 << (n - n_global)), dtype=torch.complex64,
                        device=dev)
    plain[0, 0] = 1
    torch.cuda.synchronize()
    fill_err = float((filled - plain).abs().max())
    check(fill_err == 0.0 and filled.shape == plain.shape,
          f"sharded fill vs plain: {fill_err}, {tuple(filled.shape)}")
    print(f"sharded fill {tuple(filled.shape)} complex64 vs torch.zeros "
          f"with [0, 0] set: max abs err {fill_err}")
    del filled, plain
    torch.cuda.empty_cache()

    circ = rq.Circuit(n, rq.Simulator(seed=16, device=dev), mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_first = request(circ, [], [])
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    sharded.reset_collectives()
    log, seen = [], []
    t_warm = request(circ, log, seen)
    launches = fused_sv.LAUNCHES
    batched_launches = fused_sv.BATCHED_LAUNCHES
    fills = fused_sv.ZERO_LAUNCHES
    flush_counts = sharded.count_collectives()
    flush_bytes = sharded.BYTES_MOVED
    zero_counts(pauli_readout)
    energy, t_energy = wall(lambda: circ.expval(hamiltonian))
    readout_launches = pauli_readout.LAUNCHES
    cells = sum(1 for _ in circ.state.cells())
    check(readout_launches == cells,
          f"one readout launch a cell: {readout_launches} for {cells}")
    norm = float(sharded.norm2(circ.state))
    check(len(seen) == passes and set(seen) == {k},
          f"sharded flush: {len(seen)} layer calls for {passes} planned "
          f"passes, batches {sorted(set(seen))}")
    check(launches == planned_launches == batched_launches,
          f"sharded flush: {launches} launches ({batched_launches} batched) "
          f"for {planned_launches} planned")
    check(fused_df64.LAUNCHES == 0 and rotate.LAUNCHES == 0 and fills == 1,
          "the sharded f32 path launched the f32 kernel and one fill")
    check(flush_counts["all-to-all"] == relabels == len(log)
          and flush_counts["all-gather"] == 0,
          f"exchange rounds {flush_counts} for {relabels} relabels")
    torch.cuda.synchronize()
    rounds = [(s.elapsed_time(e), b) for s, e, b in log]
    exch_ms = sum(ms for ms, _ in rounds)
    exch_bound = sum(2 * b for _, b in rounds) / HBM_BYTES_PER_S * 1e3
    log_restore = []
    with timed_exchanges(sharded, log_restore):
        circ._restore_identity_layout()
    torch.cuda.synchronize()
    restore = [(s.elapsed_time(e), b) for s, e, b in log_restore]
    got = sharded.gather(circ.state)[0]
    counts = sharded.count_collectives()
    check(counts["all-gather"] == 1 and len(restore) == 1
          and counts["all-to-all"] == relabels + 1,
          f"one merged restore and one gather at the read-back: {counts}")
    peak = (torch.cuda.max_memory_allocated() - base) / gib
    print(f"sharded n={n} over {k} shards of one card ({1 << (n - n_global)}"
          f" amplitudes a shard): {relabels} relabels scheduled, "
          f"{passes} planned complex passes, each one call over the {k} "
          f"rows: {launches} launches ({planned_launches} planned, all "
          f"batched), {fills} fill")
    print(f"sharded flush: first (schedules, plans) {t_first * 1e3:.2f} ms, "
          f"warm {t_warm * 1e3:.2f} ms; {len(rounds)} all-to-all rounds, "
          f"{flush_bytes / gib:.3f} GiB moved between shards, "
          f"{exch_ms:.2f} ms of rounds (each with its two local permutes) "
          f"beside a copy bound of {exch_bound:.2f} ms (2 x bytes / 3.35 "
          f"TB/s); per round ms {[round(ms, 3) for ms, _ in rounds]}")
    print(f"sharded restore: one merged relabel, "
          f"{[round(ms, 3) for ms, _ in restore]} ms, "
          f"{sum(b for _, b in restore) / gib:.3f} GiB; collectives "
          f"{counts}; energy {energy:.7f} in {t_energy * 1e3:.2f} ms, norm "
          f"{norm:.7f}; peak {peak:.2f} GiB over {base / gib:.2f} GiB")
    # the first planned pass, kernel against plain, on the shard rows
    first = next(item for item in plan if isinstance(item, PallasBlock))
    kinds, supports, gm, flags = interpreter.pallas_block_specs(
        first, interpreter._host_params(theta))
    kp = interpreter.kernel_plan(n - n_global, kinds, supports,
                                 complex_carry=True)[0]
    idx = list(kp.gate_idx)
    specs = tuple((kinds[i],) + tuple(p) for i, p in zip(idx, kp.positions))
    fl = [flags[i] for i in idx]
    re, im = sv.state_to_parts(circ.state.parts[0][0])
    del circ
    torch.cuda.empty_cache()
    ref = fused_sv.apply_fused_layer_reference(re, im, specs, gm[idx],
                                               real_flags=fl)
    out = fused_sv.apply_fused_layer(re.clone(), im.clone(), specs, gm[idx],
                                     pair_bits=kp.pair_bits, real_flags=fl)
    torch.cuda.synchronize()
    pass_err = max(max_err(out[0], ref[0]), max_err(out[1], ref[1]))
    pass_top = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
    check(pass_err <= SHARD_PASS_RTOL * pass_top,
          f"sharded pass vs plain: {pass_err} of max|amp| {pass_top}")
    del ref, out

    def one_pass(fn_layer):
        def run(reps):
            x, y = re.clone(), im.clone()
            for _ in range(reps):
                x, y = fn_layer(x, y, specs, gm[idx], pair_bits=kp.pair_bits,
                                real_flags=fl)
            return reps
        return run

    turns = time_turns(one_pass(fused_sv.apply_fused_layer),
                       one_pass(fused_sv.apply_fused_layer_reference), 4)
    pass_bound, pass_bound_by = bound_ms(n, [(specs, fl)], 2,
                                         complex_state=True, df=False)
    print(f"sharded pass ({k} rows of 2^{n - n_global}), kernel vs plain "
          f"{pass_err:.3e} ({pass_err / pass_top:.3e} of max|amp| "
          f"{pass_top:.3e}, limit {SHARD_PASS_RTOL:g}); ms in turns: plain {turns[0]:.3f}, kernel "
          f"{turns[1]:.4f}, kernel {turns[2]:.4f}, plain {turns[3]:.3f}; "
          f"bound {pass_bound:.4f} ({pass_bound_by})")
    del re, im
    torch.cuda.empty_cache()
    # the unsharded flat path, after the sharded state is freed
    fn = interpreter.compile_ir(ir)
    start = sv.init_state(n, device=dev)
    ref, t_ref_first = wall(lambda: fn(start))
    del ref
    ref, t_ref = wall(lambda: fn(start))
    del start
    top = float(ref.abs().max())
    err = float((got - ref).abs().max()) / top
    e_ref = float(pairsim.expval_terms_pair(ref.real, ref.imag, terms,
                                            coeffs))
    rel = abs(energy - e_ref) / abs(e_ref)
    del got, ref
    torch.cuda.empty_cache()
    check(err <= SHARD_TOL, f"sharded amplitudes: {err} of max|amp|")
    check(rel <= ENERGY_RTOL, f"sharded energy rel error {rel}")
    check(abs(norm - 1.0) <= NORM_TOL, f"sharded norm {norm}")
    print(f"unsharded flat flush n={n}: first {t_ref_first * 1e3:.2f} ms, "
          f"warm {t_ref * 1e3:.2f} ms (sharded warm {t_warm * 1e3:.2f}, "
          f"ratio {t_warm / t_ref:.3f}); amplitudes within {err:.3e} of "
          f"max|amp|, energy {e_ref:.7f} ({rel:.2e} relative)")
    ndev = torch.cuda.device_count()
    if ndev >= 2 and not ndev & (ndev - 1):
        cards = [torch.device("cuda", i) for i in range(ndev)]
        for name, real in (("default_mesh()", default_mesh()),
                           (f"{k} shards on {ndev} cards",
                            make_mesh(k, devices=cards * (k // ndev)))):
            c2 = rq.Circuit(n, rq.Simulator(seed=16, device=dev), mesh=real)
            request(c2, [], [])  # schedules and plans
            t_real = request(c2, [], [])
            rounds_r = []
            request(c2, rounds_r, [], host=True)
            e2 = c2.expval(hamiltonian)
            check(abs(e2 - e_ref) / abs(e_ref) <= ENERGY_RTOL,
                  f"{name} energy {e2}")
            ms_r = [a.elapsed_time(b) for a, b, _ in rounds_r]
            moved_r = sum(b for _, _, b in rounds_r)
            print(f"{name}: warm flush {t_real * 1e3:.2f} ms, energy "
                  f"{e2:.7f} ({abs(e2 - e_ref) / abs(e_ref):.2e} relative); "
                  f"{len(rounds_r)} rounds moving {moved_r / gib:.3f} GiB "
                  f"between shards in {sum(ms_r):.2f} ms (each timed "
                  f"between synchronizations of every card, "
                  f"{moved_r / max(sum(ms_r), 1e-9) / 1e6:.1f} GB/s); per "
                  f"round ms {[round(v, 3) for v in ms_r]}")
            del c2
            torch.cuda.empty_cache()

    # ---- 16.2 df64 ring, n = 26 over 4 shards -----------------------------
    nd, kd = SHARD_DF64_N, SMALL_SHARDS
    mesh4 = make_mesh(kd, devices=[dev] * kd)
    theta_d = rng.normal(size=nd * ANSATZ_LAYERS)
    ham_d = tfim(rq, nd)
    rq.set_precision("df64")
    try:
        _, df_passes, df_planned, _ = sharded_plan(
            interpreter, PallasBlock, fused_df64,
            rq.trace_kernel(ring_kernel, nd, *theta_d), nd,
            sharded.num_global_qubits(mesh4))
        # the path's own df64 launches on a shard's 2^24 planes, held to
        # the plain version in a run of their own (it plans the flush)
        chk = rq.Circuit(nd, rq.Simulator(device=dev), mesh=mesh4)
        ring_kernel(chk, *theta_d)
        df_errs = []
        with held_to_plain(fused_df64, "apply_fused_layer_df64",
                           fused_df64.apply_fused_layer_df64_reference,
                           df64.state_to_pair_f64, df_errs) as calls:
            chk.flush()
        del chk
        df_err = held_report("sharded df64 pass, kernel vs plain", df_errs,
                             calls, SHARD_DF64_PASS_RTOL)
        cd = rq.Circuit(nd, rq.Simulator(device=dev), mesh=mesh4)
        ring_kernel(cd, *theta_d)
        zero_counts(fused_sv, fused_df64, rotate, region_dot)
        _, t_df = wall(cd.flush)
        df_launches = fused_df64.LAUNCHES
        check(df_launches == kd * df_planned and fused_sv.LAUNCHES == 0,
              f"sharded df64: {df_launches} launches for {df_planned} "
              f"planned a shard on {kd} shards")
        check(cd.state.parts[0][1] is None, "the df64 carry stays real")
        e_s = cd.expval(ham_d)
        del cd
        cu = rq.Circuit(nd, rq.Simulator(device=dev))
        ring_kernel(cu, *theta_d)
        _, t_du = wall(cu.flush)
        e_u = cu.expval(ham_d)
        del cu
    finally:
        rq.set_precision("single")
    torch.cuda.empty_cache()
    rel_d = abs(e_s - e_u) / abs(e_u)
    check(rel_d <= DF64_ENERGY_RTOL, f"sharded df64 energy {rel_d}")
    print(f"sharded df64 n={nd} over {kd} shards: {df_passes} passes a "
          f"shard, {df_launches} launches (one a shard a pass), warm flush "
          f"{t_df * 1e3:.2f} ms (unsharded {t_du * 1e3:.2f}); energy "
          f"{e_s:.15f} vs {e_u:.15f} ({rel_d:.2e} relative)")

    # ---- 16.3 exact double QFT, n = 20 over 4 shards ------------------------
    nq = SHARD_DOUBLE_N
    rq.set_precision("double")
    try:
        psis = []
        for mesh_arg in (mesh4, None):
            c = rq.Circuit(nq, rq.Simulator(device=dev), mesh=mesh_arg)
            for q in range(0, nq, 3):
                c.x(q)
            for op in qft_ir(nq).ops:
                c._enqueue(op.name, op.targets, op.controls, op.params,
                           op.matrix, op.is_adjoint)
            psi, t = wall(c.get_statevector)
            psis.append((psi, t))
    finally:
        rq.set_precision("single")
    err_q = float(np.abs(psis[0][0] - psis[1][0]).max())
    check(err_q <= SHARD_DOUBLE_TOL, f"sharded double QFT {err_q}")
    print(f"sharded double QFT n={nq} over {kd} shards: "
          f"{psis[0][1] * 1e3:.2f} ms (unsharded {psis[1][1] * 1e3:.2f}), "
          f"within {err_q:.2e} of the unsharded exact engine")

    # ---- 16.4 density, n = 14 over 4 shards: f32 and df64 -----------------
    nr = DENSITY_N
    dens, dens_err = {}, {}
    held = {"single": (fused_sv, "apply_fused_layer",
                       fused_sv.apply_fused_layer_reference, tuple,
                       SHARD_PASS_RTOL),
            "df64": (fused_df64, "apply_fused_layer_df64",
                     fused_df64.apply_fused_layer_df64_reference,
                     df64.state_to_pair_f64, SHARD_DF64_PASS_RTOL)}
    for mode, tol in (("single", SHARD_TOL), ("df64", SHARD_DOUBLE_TOL)):
        rq.set_precision(mode)
        try:
            # the path's own launches on the shard rows, held to the plain
            # version in a run of their own
            module, name, plain, promote, rtol = held[mode]
            chk = rq.DensityCircuit(nr, rq.Simulator(device=dev), mesh=mesh4)
            density_bench(chk, DENSITY_ANGLES[0])
            errs = []
            with held_to_plain(module, name, plain, promote, errs) as calls:
                chk.flush()
            del chk
            dens_err[mode] = held_report(
                f"sharded density {mode} pass, kernel vs plain", errs, calls,
                rtol)
            zero_counts(fused_sv, fused_df64, rotate, region_dot)
            ds = rq.DensityCircuit(nr, rq.Simulator(device=dev), mesh=mesh4)
            density_bench(ds, DENSITY_ANGLES[0])
            _, t_ds = wall(ds.flush)
            launches_s = (fused_sv.LAUNCHES, fused_sv.BATCHED_LAUNCHES,
                          fused_df64.LAUNCHES)
            rho = sharded.gather(ds.state)
            rho = rho if len(rho) == 2 else (rho[0].real, rho[0].imag)
            del ds
            du = rq.DensityCircuit(nr, rq.Simulator(device=dev))
            density_bench(du, DENSITY_ANGLES[0])
            _, t_du = wall(du.flush)
            ure, uim = du.state
            top = float(ure.abs().max())
            d_err = max(max_err(rho[0], ure),
                        0.0 if rho[1] is None else float(
                            (rho[1] - (0 if uim is None else uim)).abs()
                            .max())) / top
            del du, ure, uim, rho
        finally:
            rq.set_precision("single")
        torch.cuda.empty_cache()
        check(d_err <= tol, f"sharded density {mode}: {d_err}")
        if mode == "single":
            check(launches_s[0] == launches_s[1] > 0,
                  f"sharded f32 density launches {launches_s}")
        else:
            check(launches_s[2] > 0 and launches_s[0] == 0,
                  f"sharded df64 density launches {launches_s}")
        dens[mode] = launches_s
        print(f"sharded density {mode} n={nr} over {kd} shards: flush "
              f"{t_ds * 1e3:.2f} ms (unsharded {t_du * 1e3:.2f}), launches "
              f"f32 {launches_s[0]} (batched {launches_s[1]}), df64 "
              f"{launches_s[2]}; rho within {d_err:.2e} of max|rho|")

    # ---- 16.5 tensor network: the ring over a 4-shard mesh -----------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    d = TN_DIM
    mats = [torch.randn((d, d), generator=gen, dtype=torch.complex64,
                        device=dev) / d for _ in range(3)]

    def ring(mesh_arg):
        tn = TensorNetwork(device=dev)
        for t, labels in zip(mats, ("ab", "bc", "ca")):
            tn.add_tensor(Tensor(t, tuple(labels)))
        if mesh_arg is None:
            return tn.contract({"num_slices": TN_SLICES}).data, tn
        return tn.contract({"num_slices": TN_SLICES}, mesh=mesh_arg,
                           axis_name="sv").data, tn

    (v_mesh, tn_mesh), _ = wall(lambda: ring(mesh4))
    (v_flat, _), _ = wall(lambda: ring(None))
    # warm, in turns: sharded, unsharded, unsharded, sharded
    turns = [wall(lambda: ring(m))[1] for m in (mesh4, None, None, mesh4)]
    t_mesh, t_flat = min(turns[0], turns[3]), min(turns[1], turns[2])
    rel_tn = abs(complex(v_mesh) - complex(v_flat)) / abs(complex(v_flat))
    check(tn_mesh.last_num_slices >= kd and rel_tn <= TN_RING_TOL,
          f"mesh ring: {tn_mesh.last_num_slices} slices, {rel_tn}")
    print(f"ring d={d} over a {kd}-shard mesh: {tn_mesh.last_num_slices} "
          f"slices, {t_mesh * 1e3:.2f} ms (unsharded {t_flat * 1e3:.2f}), "
          f"within {rel_tn:.2e} relative")
    del mats, tn_mesh

    # ---- 16.6 the pinned exchange budget at n = 30 -------------------------
    def canonical(c):
        c.h(n - 1)
        c.cx(n - 1, 0)
        c.ry(0.3, n - 2)

    def diagonals(c):
        c.cz(0, n - 1)
        c.rz(0.4, n - 1)

    def one_layer(c):
        for q in range(n):
            c.ry(0.1 * (q + 1), q)
        for q in range(n):
            c.cx(q, (q + 1) % n)

    budget = []
    for build, want in ((canonical, 1), (diagonals, 0), (one_layer, 2)):
        c = rq.Circuit(n, rq.Simulator(device=dev), mesh=mesh)
        c.state  # the fill is no collective
        build(c)
        sharded.reset_collectives()
        c.flush()
        got_counts = sharded.count_collectives()
        check(got_counts["all-to-all"] == want
              and sum(got_counts.values()) == want,
              f"exchange budget {build.__name__}: {got_counts}")
        budget.append(got_counts["all-to-all"])
        del c
        torch.cuda.empty_cache()
    print(f"exchange budget n={n} on {k} shards: canonical, diagonals, one "
          f"ring layer -> {budget} all-to-all rounds (CPU test: [1, 0, 2])")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return {"fused_layer": launches, "fused_layer_init": fills,
            "fused_layer_df64": df_launches,
            "pauli_readout": readout_launches,
            "errors": {"fused_layer": max(pass_err, dens_err["single"]),
                       "fused_layer_init": fill_err,
                       "fused_layer_df64": max(df_err, dens_err["df64"])}}


def framework_stubs():
    """Put the in-repo qiskit/cirq/pennylane API stubs (tests/_stubs) on
    the path where a framework is not installed, as tests/conftest.py
    does; returns which frameworks are stubbed."""
    import importlib.util
    import os
    absent = [m for m in ("qiskit", "cirq", "pennylane")
              if importlib.util.find_spec(m) is None]
    if absent:
        sys.path.append(os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "_stubs"))
    return absent


def plugin_unitary(seed):
    """A seeded random complex two-qubit unitary."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))
    return q


def integration_phase(rq, interpreter, fused_sv, fused_df64, rotate,
                      region_dot, requests, dev):
    """Phase 17: the Qiskit, Cirq and PennyLane plugins on the card at full
    width, the flat complex-rho API at n = 14 and a float64 pair program.
    Returns the plugins' fused-kernel launches and the largest error of
    their held kernel calls."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp
    from rocquantum_tpu_torch.models import qft_ir
    from rocquantum_tpu_torch.ops import density, pairsim
    from rocquantum_tpu_torch.ops import statevec as sv

    t_phase = time.perf_counter()
    rq.set_precision("single")
    stubbed = framework_stubs()
    import cirq
    import pennylane as qml
    from qiskit import QuantumCircuit
    from rocquantum_tpu_torch.integrations import (cirq_simulator,
                                                   pennylane_device,
                                                   qiskit_provider)
    print(f"integrations: {', '.join(stubbed) or 'none'} from tests/_stubs, "
          f"{', '.join(m for m in ('qiskit', 'cirq', 'pennylane') if m not in stubbed) or 'none'} installed")
    launches = {}

    def counted(label, fn):
        """``fn()`` with every launch count set to 0 just before it and
        read just after; (result, seconds)."""
        zero_counts(fused_sv, fused_df64, rotate, region_dot)
        out, t = wall(fn)
        launches[label] = fused_sv.LAUNCHES
        check(fused_sv.LAUNCHES > 0, f"{label} launched the fused kernel")
        check(fused_df64.LAUNCHES == 0, f"{label} launched no df64 pass")
        return out, t

    # ---- 17.1 Qiskit, n = 29: the ring ansatz and a complex unitary ------
    n = ANSATZ_N
    theta = requests[0]
    u = plugin_unitary(17)
    qc = QuantumCircuit(n, n)
    k = 0
    for _ in range(ANSATZ_LAYERS):
        for q in range(n):
            qc.ry(float(theta[k]), q)
            k += 1
        for q in range(n):
            qc.cx(q, (q + 1) % n)
    pair = (3, n // 2 + 3)
    qc.unitary(u, list(pair))
    qc.measure(list(range(n)), list(range(n)))
    backend = qiskit_provider.RocQuantumProvider().get_backend(
        "rocq_simulator")
    check(backend._device.type == "cuda", "the plugins default to the card")
    errs = []
    with held_to_plain(fused_sv, "apply_fused_layer",
                       fused_sv.apply_fused_layer_reference, tuple,
                       errs) as calls:
        _, t_first = wall(lambda: backend.run(qc, shots=INTEGRATION_SHOTS))
    held_err = held_report("17.1 qiskit run, kernel vs plain", errs, calls,
                           SHARD_PASS_RTOL)
    result, t_run = counted("qiskit", lambda: backend.run(
        qc, shots=INTEGRATION_SHOTS))
    counts = result.get_counts()
    check(sum(counts.values()) == INTEGRATION_SHOTS
          and all(len(key) == n for key in counts), "qiskit counts layout")
    psi, t_read = wall(backend.get_statevector)
    circ = rq.Circuit(n, rq.Simulator(device=dev))

    def enqueue():
        circ.reset()
        k = 0
        for _ in range(ANSATZ_LAYERS):
            for q in range(n):
                circ.ry(float(theta[k]), q)
                k += 1
            for q in range(n):
                circ.cx(q, (q + 1) % n)
        circ._enqueue("UNITARY", pair, (), (), matrix=u)

    flush_s = []
    for _ in range(2):  # the first flush plans, the second finds the plan
        enqueue()
        flush_s.append(wall(circ.flush)[1])
    re, im = circ.state
    chunk = 1 << 26
    err = top = 0.0
    for start in range(0, 1 << n, chunk):
        want = (re[start:start + chunk].double()
                + 1j * im[start:start + chunk].double()).cpu().numpy()
        err = max(err, float(np.abs(psi[start:start + chunk] - want).max()))
        top = max(top, float(np.abs(want).max()))
    del psi
    marg = pairsim.marginal_probs_pair(re, im, [0, 1, 2]).cpu().numpy()
    freq = np.zeros(8)
    for key, v in counts.items():
        freq[int(key, 2) & 7] += v / INTEGRATION_SHOTS
    f_err = float(np.abs(freq - marg).max())
    print(f"17.1 qiskit n={n}: {ANSATZ_LAYERS} ring layers + a complex "
          f"unitary, {INTEGRATION_SHOTS} shots: run() first {t_first * 1e3:.1f}"
          f" ms (plans; kernel calls held to plain), warm "
          f"{t_run * 1e3:.1f} ms with {launches['qiskit']} fused launches; "
          f"Circuit flush first {flush_s[0] * 1e3:.1f} ms, warm "
          f"{flush_s[1] * 1e3:.1f} ms; get_statevector() {t_read * 1e3:.1f} "
          f"ms; max abs err vs Circuit {err:.3e} = {err / top:.3e} of "
          f"max|amp|; counts' marginal over qubits 0-2 {f_err:.4f} off")
    check(err <= INTEGRATION_TOL * top, f"qiskit state error {err}")
    check(f_err <= INTEGRATION_FRACTION_TOL, f"qiskit marginal {f_err}")
    del backend, circ, re, im, result, counts
    torch.cuda.empty_cache()

    # ---- 17.2 Cirq, n = 26: GHZ + an RX column through cirq.unitary ------
    n = QFT_N
    qs = cirq.LineQubit.range(n)
    angles = [0.2 + 0.03 * q for q in range(n)]
    ghz = [cirq.H(qs[0])] + [cirq.CNOT(a, b) for a, b in zip(qs, qs[1:])]
    circuit = cirq.Circuit(ghz + [cirq.rx(a)(q) for a, q in zip(angles, qs)])
    simulator = cirq_simulator.RocQuantumSimulator()
    (res,), t_sweep = counted("cirq", lambda: simulator.simulate_sweep(
        circuit))
    got = res.state_vector()
    check(got.dtype == np.complex64 and got.shape == (1 << n,),
          "cirq final state complex64")
    ops = [GateOp("H", (0,))] + [GateOp("CNOT", (q + 1,), (q,))
                                 for q in range(n - 1)]
    ops += [GateOp("UNITARY", (q,), (), (), cirq.unitary(cirq.rx(a)))
            for q, a in enumerate(angles)]
    want = interpreter.run_ops_exact(sv.init_state(n, device=dev),
                                     ops).cpu().numpy()
    c_err = float(np.abs(got - want).max() / np.abs(want).max())
    del got, want
    meas = cirq.Circuit(ghz + [cirq.measure(*qs, key="m")])
    rows, t_meas = counted("cirq_run", lambda: simulator._run(
        meas, cirq.ParamResolver({}), INTEGRATION_REPS)["m"])
    check(rows.shape == (INTEGRATION_REPS, n), "cirq _run shape")
    parity_ok = bool(np.all(rows == rows[:, :1]))
    ones = float(rows[:, 0].mean())
    print(f"17.2 cirq n={n}: simulate_sweep {t_sweep * 1e3:.1f} ms "
          f"({launches['cirq']} fused launches), max abs err vs the per-op "
          f"engine {c_err:.3e} of max|amp|; _run GHZ {INTEGRATION_REPS} "
          f"repetitions {t_meas * 1e3:.1f} ms ({launches['cirq_run']} "
          f"launches): every row all-equal {parity_ok}, all-1 fraction "
          f"{ones:.4f}")
    check(c_err <= INTEGRATION_TOL, f"cirq state error {c_err}")
    check(parity_ok, "cirq GHZ rows all-equal")
    check(abs(ones - 0.5) <= INTEGRATION_FRACTION_TOL, f"cirq GHZ {ones}")
    torch.cuda.empty_cache()

    # ---- 17.3 PennyLane, n = 26: RX/RY, a CNOT chain, a QubitUnitary -----
    u = plugin_unitary(18)
    a = [0.1 + 0.02 * w for w in range(n)]
    b = [0.5 - 0.01 * w for w in range(n)]
    ops = [qml.RX(a[w], wires=w) for w in range(n)] + [
        qml.RY(b[w], wires=w) for w in range(n)] + [
        qml.CNOT(wires=[w, w + 1]) for w in range(n - 1)] + [
        qml.QubitUnitary(u, wires=[0, n - 1])]
    device = pennylane_device.RocQDevice(wires=n, shots=INTEGRATION_SHOTS)
    _, t_apply = counted("pennylane", lambda: device.apply(ops))
    probs, t_prob = wall(lambda: device.analytic_probability(wires=[0, 1, 2]))
    samples, t_samp = wall(device.generate_samples)
    circ = rq.Circuit(n, rq.Simulator(device=dev))
    for w in range(n):
        circ.rx(a[w], w)
    for w in range(n):
        circ.ry(b[w], w)
    for w in range(n - 1):
        circ.cx(w, w + 1)
    circ._enqueue("UNITARY", (0, n - 1), (), (), matrix=u)
    circ.flush()
    re, im = circ.state
    # the base class's wire order: wire j is the index's bit n - 1 - j
    want = pairsim.marginal_probs_pair(re, im, [n - 3, n - 2, n - 1])
    p_err = float(np.abs(probs - want.cpu().numpy()).max())
    p_one = np.array([float(pairsim.prob_one_pair(re, im, n - 1 - j))
                      for j in range(n)])
    s_err = float(np.abs(samples.mean(axis=0) - p_one).max())
    print(f"17.3 pennylane n={n}: apply {t_apply * 1e3:.1f} ms "
          f"({launches['pennylane']} fused launches), "
          f"analytic_probability(wires=[0, 1, 2]) {t_prob * 1e3:.1f} ms, "
          f"max abs err vs Circuit {p_err:.3e}; generate_samples "
          f"{t_samp * 1e3:.1f} ms, shape {samples.shape}, mean "
          f"{samples.mean():.4f}, max per-wire mean error {s_err:.4f}")
    check(p_err <= INTEGRATION_TOL, f"pennylane probabilities {p_err}")
    check(samples.shape == (INTEGRATION_SHOTS, n), "pennylane sample shape")
    check(s_err <= INTEGRATION_FRACTION_TOL, f"pennylane samples {s_err}")
    del device, circ, re, im
    torch.cuda.empty_cache()

    # ---- 17.4 the flat complex-rho API, n = 14 ---------------------------
    n = DENSITY_N
    base = DENSITY_ANGLES[0]

    def workload():
        rho = density.init_density(n, device=dev)
        for _ in range(DENSITY_LAYERS):
            for q in range(n):
                rho = density.apply_gate_dm(rho, "RY", [q],
                                            params=(base + 0.01 * q,))
            rho = density.apply_channel(rho, "depolarizing", DENSITY_P,
                                        list(range(n)))
        return rho

    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    torch.cuda.reset_peak_memory_stats()
    rho, t_rho = wall(workload)
    rho_launches = fused_sv.LAUNCHES  # plain torch, as JAX's plain XLA
    peak = torch.cuda.max_memory_allocated() / (1 << 30)
    check(rho.dtype == torch.complex64 and rho.device.type == "cuda",
          "flat rho stays complex64 on the card")
    z_cf, purity_cf, _ = density_closed_form(n, base)
    z = np.array([float(density.expval_z_dm(rho, q)) for q in range(n)])
    trace = float(density.trace_dm(rho))
    purity = float(density.purity(rho))
    draws = density.sample_dm(rho, [0, 1, 2], DENSITY_SHOTS,
                              torch.Generator(device=dev).manual_seed(17))
    check(draws.dtype == torch.int32, "sample_dm draws int32")
    p1 = (1 - z_cf[:3]) / 2
    k = np.arange(8)
    marg = np.prod([np.where((k >> q) & 1, p1[q], 1 - p1[q])
                    for q in range(3)], axis=0)
    freq = np.bincount(draws.cpu().numpy(), minlength=8) / DENSITY_SHOTS
    d_frac = float(np.abs(freq - marg).max())
    del rho
    torch.cuda.empty_cache()
    dc = rq.DensityCircuit(n, rq.Simulator(device=dev))
    density_bench(dc, base)
    zero_counts(fused_sv, fused_df64, rotate, region_dot)
    _, t_dc = wall(dc.flush)
    dc_launches = fused_sv.LAUNCHES
    z_dc = np.array([dc.expval(rq.PauliOperator(f"Z{q}")) for q in range(n)])
    del dc
    torch.cuda.empty_cache()
    z_err = float(np.abs(z - z_cf).max())
    zd_err = float(np.abs(z - z_dc).max())
    p_rel = abs(purity - purity_cf) / purity_cf
    print(f"17.4 flat rho n={n} (complex64, {(8 << (2 * n)) / (1 << 30):.0f}"
          f" GiB): bench.py:485's workload through init_density / "
          f"apply_gate_dm / apply_channel {t_rho * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB, beside a DensityCircuit flush {t_dc * 1e3:.1f} "
          f"ms; max |<Z_q> - closed form| {z_err:.2e}, - DensityCircuit "
          f"{zd_err:.2e}; trace - 1 {trace - 1:.2e}; purity rel "
          f"{p_rel:.2e}; {DENSITY_SHOTS} sample_dm draws {d_frac:.4f} off "
          f"the marginal; fused launches: flat rho {rho_launches}, "
          f"DensityCircuit {dc_launches}")
    check(z_err <= DENSITY_TOL, f"flat rho <Z_q> {z_err}")
    check(zd_err <= DENSITY_TOL, f"flat rho vs DensityCircuit {zd_err}")
    check(abs(trace - 1) <= DENSITY_TOL, f"flat rho trace {trace}")
    check(p_rel <= DENSITY_PURITY_RTOL, f"flat rho purity {p_rel}")
    check(d_frac <= DENSITY_FRACTION_TOL, f"flat rho draws {d_frac}")

    # ---- 17.5 compile_pair_ir: QFT of a basis state, n = 20 --------------
    n = FLAT_DOUBLE_N
    x = 0x5A5A5 % (1 << n)
    ir = CircuitIR(n, [GateOp("X", (q,)) for q in range(n) if (x >> q) & 1]
                   + list(qft_ir(n).ops))
    fn = pairsim.compile_pair_ir(ir)
    (pre, pim), t_pair = wall(lambda: fn(*pairsim.init_pair(
        n, torch.float64, dev)))
    kk = np.arange(1 << n, dtype=np.int64)
    want = np.exp(1j * ((x * kk) % (1 << n)).astype(np.float64)
                  * (2 * np.pi / (1 << n))) / np.sqrt(1 << n)
    q_err = float(np.abs(pre.cpu().numpy() + 1j * pim.cpu().numpy()
                         - want).max())
    print(f"17.5 compile_pair_ir QFT n={n} of |{x}>: {len(ir.ops)} ops in "
          f"{t_pair * 1e3:.1f} ms, max abs err vs closed form {q_err:.3e}")
    check(q_err <= FLAT_DOUBLE_TOL, f"pair QFT error {q_err}")
    del pre, pim
    torch.cuda.empty_cache()
    print(f"integration phase: {time.perf_counter() - t_phase:.1f} s")
    return {"integration_launches": launches["qiskit"] + launches["cirq"]
            + launches["cirq_run"] + launches["pennylane"],
            "integration_max_abs_err": held_err}


def readout_phase():
    """Phase 18: the Pauli readout kernel against the plain per-term
    readout at the benchmark's sizes, timed beside its byte bound (one
    read of the planes, whatever the kernel's sweeps); the kernels-line
    fields of the row but its path launches."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.ops import _build, pairsim, pauli_readout
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    pauli_readout.build()
    for line in _build.BUILD_LOGS.get("pauli_readout", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas pauli_readout: {line.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1819)
    row = {"max_abs_err": 0.0, "bound_by": "bytes", "library_ms": None}
    cases = (("", READOUT_N, torch.float32, True, READOUT_RTOL),
             ("df64_", READOUT_N, torch.float64, True, DF64_READOUT_RTOL),
             ("shard_", READOUT_SHARD_N, torch.complex64, False,
              READOUT_RTOL))
    for key, n, dtype, real, rtol in cases:
        if real:
            re = torch.randn(1 << n, generator=gen, device=dev, dtype=dtype)
            psi, im = None, None
        else:
            psi = torch.randn(1 << n, generator=gen, device=dev, dtype=dtype)
            re, im = psi.real, psi.imag
        scale = float(pairsim.norm2_pair(re, im)) ** -0.5
        (re if psi is None else psi).mul_(scale)
        terms = [(("Z", q), ("Z", (q + 1) % n)) for q in range(n)] + \
            [(("X", q),) for q in range(n)]
        coeffs = [-1.0] * n + [-0.5] * n
        plain = {"on": False}

        def readout():
            if plain["on"]:
                total = torch.zeros((), dtype=torch.float64, device=dev)
                for t, c in zip(terms, coeffs):
                    total = total + c * pairsim._string_plain(re, im, t)
                return total
            return pauli_readout.expval_terms(re, im, terms, coeffs)

        def run_plain(reps):
            plain["on"] = True
            try:
                return repeat(readout)(reps)
            finally:
                plain["on"] = False

        zero_counts(pauli_readout)
        got, again = readout(), readout()
        check(pauli_readout.LAUNCHES == 2, "a launch a readout")
        plain["on"] = True
        want = readout()
        plain["on"] = False
        err = abs(float(got) - float(want)) / float(np.abs(coeffs).sum())
        check(err <= rtol, f"readout {key or 'f32_'}n={n}: {err:.3e} of "
              f"sum |c| > {rtol}")
        check(torch.equal(got, again), f"readout {key}n={n} repeat differs")
        plain_1, ms_1, ms_2, plain_2 = time_turns(repeat(readout), run_plain,
                                                  20)
        p = pauli_readout.plan(n, terms, re.dtype, 1 if real else 2)
        nbytes = (1 << n) * re.element_size() * (1 if real else 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update({f"{key}ms": min(ms_1, ms_2),
                    f"{key}plain_ms": min(plain_1, plain_2),
                    f"{key}bound_ms": bound, f"{key}sweeps": len(p.sweeps)})
        print(f"readout {key or 'f32_'}n={n}: {len(p.sweeps)} sweeps, kernel "
              f"{ms_1:.3f} / {ms_2:.3f} ms, plain {plain_1:.1f} / "
              f"{plain_2:.1f} ms, bound {bound:.3f} ms (one read), "
              f"{err:.2e} of sum |c|")
        del re, im, psi
        torch.cuda.empty_cache()
    print(f"readout phase: {time.perf_counter() - t_phase:.1f} s")
    return row


DENSE2Q_N = 30
DENSE2Q_LAYERS = 30


def dense2q_phase():
    """Phase 19: the f32 kernel's dense two-qubit case (U4 records, run by
    fused_pass_dense_kernel) on re+im planes at n = 30: the passes of a
    Quantum Volume circuit's plan (30 layers of Haar SU(4)s on permuted
    pairs), the first three each held to the plain version, then the
    whole plan timed per pass beside the byte bound of a complex pass and
    its FP32 instructions (16 an amplitude a U4); the fields of the
    kernels line's fused_layer row."""
    import numpy as np
    import torch
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.compiler.ir import GateOp
    from rocquantum_tpu_torch.ops import _build, fused_sv
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    fused_sv.build()
    for line in _build.BUILD_LOGS.get("fused_sv", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas fused_sv: {line.strip()}")
    n = DENSE2Q_N
    rng = np.random.default_rng(1811)
    ops = []
    for _ in range(DENSE2Q_LAYERS):
        perm = rng.permutation(n)
        z = rng.normal(size=(n // 2, 4, 4)) + 1j * rng.normal(
            size=(n // 2, 4, 4))
        q, r = np.linalg.qr(z)
        d = np.diagonal(r, axis1=1, axis2=2)
        for w, u in enumerate(q * (d / np.abs(d))[:, None, :]):
            ops.append(GateOp("UNITARY", (int(perm[2 * w]),
                                          int(perm[2 * w + 1])), (), (), u))
    (block,) = interpreter.plan_items(ops, n)
    kinds, supports, gm, _, dm = interpreter._block_specs(
        block, None, fused_sv)
    plan = interpreter.kernel_plan(n, kinds, supports,
                                   complex_carry=True)
    passes = []
    for item in plan:
        idx = list(item.gate_idx)
        passes.append((tuple((kinds[i],) + tuple(p)
                             for i, p in zip(idx, item.positions)),
                       gm[idx], dm[idx], item.pair_bits))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1811)
    re = torch.randn(1 << n, generator=gen, device=dev)
    im = torch.randn(1 << n, generator=gen, device=dev)
    scale = float((re.double().square().sum()
                   + im.double().square().sum()) ** -0.5)
    re.mul_(scale)
    im.mul_(scale)
    worst = 0.0
    for specs, g, d, pairs in passes[:3]:
        want = fused_sv.apply_fused_layer_reference(re, im, specs, g,
                                                    dense_mats=d)
        got = fused_sv.apply_fused_layer(re.clone(), im.clone(), specs, g,
                                         pair_bits=pairs, dense_mats=d)
        top = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst = max(worst, err / top)
        check(err <= 1e-5 * top, f"dense pass: {err:.3e} > 1e-5 of "
              f"max|amp| {top:.3e}")
        del want, got
        torch.cuda.empty_cache()
    plain = {"specs": passes[0]}

    def run_all(reps):
        for _ in range(reps):
            for specs, g, d, pairs in passes:
                fused_sv.apply_fused_layer(re, im, specs, g,
                                           pair_bits=pairs, dense_mats=d)
        return reps * len(passes)

    def run_plain(reps):
        specs, g, d, _ = plain["specs"]
        for _ in range(reps):
            out = fused_sv.apply_fused_layer_reference(re, im, specs, g,
                                                       dense_mats=d)
            del out
        return reps

    zero_counts(fused_sv)
    plain_1, ms_1, ms_2, plain_2 = time_turns(run_all, run_plain, 1)
    launches = fused_sv.LAUNCHES
    byte_ms = (1 << n) * 4 * 2 * 2 / HBM_BYTES_PER_S * 1e3
    op_ms = (1 << n) * 16 * len(ops) / len(passes) / FP32_INSTR_PER_S * 1e3
    swaps = sum(launch.swaps for specs, *_ in passes
                for launch in fused_sv.pass_schedule(
                    n, fused_sv._normalize_specs(specs), True))
    print(f"dense2q n={n}: {len(ops)} SU(4)s in {len(passes)} passes "
          f"({swaps} exchanges), kernel {ms_1:.3f} / {ms_2:.3f} ms a pass, "
          f"plain {plain_1:.1f} / {plain_2:.1f} ms a pass, bound "
          f"{byte_ms:.3f} ms (bytes; FP32 {op_ms:.3f}), {worst:.2e} of "
          f"max|amp|, {launches} launches timed")
    print(f"dense2q phase: {time.perf_counter() - t_phase:.1f} s")
    del re, im
    torch.cuda.empty_cache()
    return {"dense2q_ms": min(ms_1, ms_2),
            "dense2q_plain_ms": min(plain_1, plain_2),
            "dense2q_bound_ms": max(byte_ms, op_ms),
            "dense2q_passes": len(passes),
            "dense2q_max_abs_err": worst}


# (name, targets, controls, angles, complex planes) of phase 20's checks
ADJOINT_CASES = (
    ("RY", (0,), (), (0.7,), False), ("RY", (1,), (), (0.7,), False),
    ("RY", (13,), (), (0.7,), False), ("RY", (25,), (), (0.7,), True),
    ("RX", (5,), (), (1.3,), False), ("RZ", (0,), (), (-0.4,), True),
    ("CRY", (0,), (17,), (2.1,), False), ("CRY", (9,), (1,), (2.1,), True),
    ("RZZ", (0, 1), (), (0.9,), True), ("RZZ", (1, 0), (), (0.9,), True),
    ("RZZ", (20, 3), (), (0.9,), False), ("RZZ", (0, 24), (7,), (0.9,), True),
    ("U3", (2,), (0, 21), (0.3, -1.1, 2.5), True),
    ("U3", (1,), (), (0.3, -1.1, 2.5), False),
)


def adjoint_step_phase():
    """Phase 20: the adjoint step kernel at the gradient cell's n = 26
    against its plain version (ADJOINT_CASES), the same bits on a second
    launch, and one step on a real plane (RY) and on a complex pair (RX)
    timed in turns beside its byte bound and the plain sequence it
    replaces; the fields of the kernels line's adjoint_step row but its
    path launches."""
    import dataclasses

    import numpy as np
    import torch
    from rocquantum_tpu_torch import autodiff
    from rocquantum_tpu_torch.compiler.interpreter import compile_pair32_ir
    from rocquantum_tpu_torch.compiler.ir import CircuitIR, GateOp, ParamRef
    from rocquantum_tpu_torch.ops import _build, adjoint_step, gates
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    adjoint_step.build()
    for line in _build.BUILD_LOGS.get("adjoint_step", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas adjoint_step: {line.strip()}")
    n = ADJOINT_N
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    work = adjoint_step.scratch(dev)

    def planes(complex_):
        re = torch.randn(1 << n, generator=gen, device=dev)
        im = torch.randn(1 << n, generator=gen, device=dev) \
            if complex_ else None
        scale = float(re.double().square().sum() + (
            0 if im is None else im.double().square().sum())) ** -0.5
        return re.mul_(scale), None if im is None else im.mul_(scale)

    def copy(pair):
        return tuple(None if p is None else p.clone() for p in pair)

    def step_of(name, targets, controls, angles):
        base = {"CRY": "RY"}.get(name, name)
        u = gates.gate_matrix(base, angles)
        d = u.shape[0]
        v = np.zeros((1, 4, 4), np.complex128)
        v[0, :d, :d] = u.conj().T
        step = adjoint_step.plan(n, controls, targets)
        return adjoint_step.pack(v, np.array([step.swap]))[0], step, d

    worst = m_worst = 0.0
    for name, targets, controls, angles, complex_ in ADJOINT_CASES:
        v, step, d = step_of(name, targets, controls, angles)
        ket, bra = planes(complex_), planes(complex_)
        want_m = torch.zeros(2, 4, 4, dtype=torch.float64, device=dev)
        want = adjoint_step.apply_reference(copy(ket), copy(bra), v, step,
                                            want_m)
        got_m = torch.zeros_like(want_m)
        got = adjoint_step.apply(copy(ket), copy(bra), v, step, got_m, work)
        again_m = torch.zeros_like(want_m)
        again = adjoint_step.apply(copy(ket), copy(bra), v, step, again_m,
                                   work)
        torch.cuda.synchronize()
        top = max(float(p.abs().max()) for pair in want for p in pair
                  if p is not None)
        err = max(float((a - b).abs().max()) for gp, wp in zip(got, want)
                  for a, b in zip(gp, wp) if b is not None) / top
        m_err = float((got_m - want_m).abs().max()) / float(
            want_m.abs().sum())
        worst, m_worst = max(worst, err), max(m_worst, m_err)
        print(f"adjoint step {name} targets {targets} controls {controls} "
              f"{'complex' if complex_ else 'real'} (layout {step.lt}): "
              f"planes {err:.2e} of max|amp|, M {m_err:.2e} of sum|M|")
        check(err <= ADJOINT_TOL, f"adjoint step planes: {err:.3e}")
        check(m_err <= ADJOINT_M_TOL, f"adjoint step M: {m_err:.3e}")
        check(torch.equal(got_m, again_m) and all(
            torch.equal(a, b) for gp, ap in zip(got, again)
            for a, b in zip(gp, ap) if a is not None),
            f"adjoint step {name}: a second launch differs")
        del ket, bra, want, got, again
        torch.cuda.empty_cache()

    row = {"max_abs_err": worst, "m_err": m_worst, "bound_by": "bytes",
           "library_ms": None}
    for key, name, angles, complex_ in (("", "RY", (0.7,), False),
                                        ("complex_", "RX", (1.3,), True)):
        v, step, _ = step_of(name, (13,), (), angles)
        ket, bra = planes(complex_), planes(complex_)
        out = torch.zeros(2, 4, 4, dtype=torch.float64, device=dev)
        op = GateOp(name, (13,), (), (ParamRef(0),))
        run = compile_pair32_ir(CircuitIR(n, [dataclasses.replace(
            op, is_adjoint=True)]), every_run=True)
        values = np.asarray(angles)

        def plain_step():
            k = run(ket, values)
            autodiff._correlation(bra, k, [], [13])
            run(bra, values)

        plain_1, ms_1, ms_2, plain_2 = time_turns(
            repeat(lambda: adjoint_step.apply(ket, bra, v, step, out, work)),
            repeat(plain_step), 50, 5)
        planes_ = 2 if complex_ else 1
        bound = (1 << n) * 4 * planes_ * 2 * 2 / HBM_BYTES_PER_S * 1e3
        row.update({f"{key}ms": min(ms_1, ms_2),
                    f"{key}plain_ms": min(plain_1, plain_2),
                    f"{key}bound_ms": bound})
        print(f"adjoint step {name} n={n} {'complex' if complex_ else 'real'}"
              f": kernel {ms_1:.3f} / {ms_2:.3f} ms, bound {bound:.3f} ms "
              f"({100 * bound / min(ms_1, ms_2):.1f}%), plain sequence "
              f"{plain_1:.3f} / {plain_2:.3f} ms")
        del ket, bra
        torch.cuda.empty_cache()
    print(f"adjoint step phase: {time.perf_counter() - t_phase:.1f} s")
    return row


SHARD_DIAG_N = 32          # the four-card cell's state: 4 shards of 2^30
SHARD_DIAG_CHECK_N = 26
SHARD_DIAG_TOL = 1e-6      # in place vs the matrix path, of max|amp|


def shard_diagonal_phase():
    """Phase 21: diagonals on global bits over 4 virtual shards of the
    card, the sharded runner's in-place path against the per-shard
    diagonal matrix it replaced: a block of the four-card cell's RZ on
    both global bits (a scalar a cell) and a CZ from a global control to
    qubit 0 (a factor over one local qubit where the control is 1), held
    to each other at n = SHARD_DIAG_CHECK_N, then timed in turns at n =
    SHARD_DIAG_N; ms a cell, and a cell it scales beside the byte bound of
    one read and write of a cell's 2^30 complex64 amplitudes."""
    import torch
    from rocquantum_tpu_torch.compiler import interpreter
    from rocquantum_tpu_torch.compiler.ir import GateOp
    from rocquantum_tpu_torch.parallel import make_mesh, sharded
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    mesh = make_mesh(4, devices=[dev] * 4)

    def cases(n):
        """(name, ops, cells the in-place path scales: a CZ's factor is
        all ones where its control is 0)."""
        return (("RZ RZ", [GateOp("RZ", (n - 2,), (), (0.7,)),
                           GateOp("RZ", (n - 1,), (), (1.9,))], 4),
                ("CZ", [GateOp("CZ", (0,), (n - 1,), ())], 2))

    def in_place(state, ops):
        return interpreter._global_diagonal(state, ops, None, state.n_local)

    def per_shard(state, ops):
        for op in ops:
            state = interpreter._global_op(state, op, None,
                                           interpreter._complex_rows,
                                           state.n_local)
        return state

    n = SHARD_DIAG_CHECK_N
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    v = torch.randn(1 << n, dtype=torch.complex64, device=dev,
                    generator=gen)
    v /= float(v.abs().square().sum()) ** 0.5
    worst = 0.0
    for name, ops, _ in cases(n):
        got = sharded.gather(in_place(sharded.shard_state(v, mesh), ops))[0]
        want = sharded.gather(per_shard(sharded.shard_state(v, mesh),
                                        ops))[0]
        err = float((got - want).abs().max()) / float(want.abs().max())
        worst = max(worst, err)
        print(f"shard diagonal {name} n={n}: in place vs matrix path "
              f"{err:.2e} of max|amp|")
        check(err <= SHARD_DIAG_TOL, f"shard diagonal {name}: {err:.3e}")
    del v, got, want
    torch.cuda.empty_cache()

    n = SHARD_DIAG_N
    cell = 1 << (n - 2)
    parts = [(torch.full((4, cell), 2.0 ** (-n / 2), dtype=torch.complex64,
                         device=dev),)]
    state = sharded.ShardedState(sharded.state_sharding(mesh), n, None,
                                 parts)
    bound = cell * 8 * 2 / HBM_BYTES_PER_S * 1e3
    row = {"bound_ms": bound, "max_abs_err": worst}
    for name, ops, scaled in cases(n):
        old_1, new_1, new_2, old_2 = time_turns(
            repeat(lambda: in_place(state, ops)),
            repeat(lambda: per_shard(state, ops)), 10, 2)
        new_ms, old_ms = min(new_1, new_2) / 4, min(old_1, old_2) / 4
        row[name] = {"ms": new_ms, "before_ms": old_ms}
        print(f"shard diagonal {name} n={n}, ms a cell: in place "
              f"{new_1 / 4:.3f} / {new_2 / 4:.3f}, matrix path "
              f"{old_1 / 4:.3f} / {old_2 / 4:.3f}; in place "
              f"{4 * new_ms / scaled:.3f} a cell it scales ({scaled} of 4), "
              f"bound {bound:.3f} "
              f"({100 * bound * scaled / (4 * new_ms):.1f}%)")
    del state, parts
    torch.cuda.empty_cache()
    print(f"shard diagonal phase: {time.perf_counter() - t_phase:.1f} s")
    return row


if __name__ == "__main__":
    sys.exit(main())
