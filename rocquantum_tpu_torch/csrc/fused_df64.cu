// Fused gate-layer pass over a double-float (df64) state vector, for Hopper
// (sm_90a).
//
// What it replaces. In the JAX package two Pallas TPU kernels compute one
// function -- apply an ordered gate list to every amplitude of a state held
// as hi/lo float32 planes, in compensated arithmetic, in one in-place pass
// (rocquantum_tpu/ops/pallas_df64.py):
//   _kernel_df        (:240)  gates inside the 17-bit window
//   _kernel_multi_df  (:274)  plus up to three runs of pair bits
// Here they are one kernel, with the geometry of csrc/fused_sv.cu: a pass
// has a LOCAL SET L of index bits, the low w bits plus up to kMaxPairs pair
// bits anywhere above them. Each block owns one assignment of the bits
// outside L, loads its 2^|L| amplitudes (every plane) into shared memory,
// applies the whole gate list there and writes back in place. Blocks own
// disjoint amplitudes, so in place is safe.
//
// State planes. x = hi + lo with |lo| <= ulp(hi)/2 for each component:
//   real carry     (re_hi, re_lo)               2 planes, 64 KiB at |L| = 13
//   complex carry  (re_hi, re_lo, im_hi, im_lo) 4 planes, 128 KiB at |L| = 13
// Both exceed the 48 KiB default, so the launch raises the dynamic
// shared-memory limit. At |L| = 13 an SM (227 KiB) holds three real-carry
// blocks or one complex-carry block.
//
// Gate kinds (spec rows (kind, q0, q1); matrices [k][row][col][4] with the
// last axis (re_hi, re_lo, im_hi, im_lo)):
//   U    (q0 = target)           dense 2x2 on a bit of L
//   CNOT (q0 = control, q1 = t)  conditional swap; target in L
//   CU   (q0 = control, q1 = t)  conditional 2x2; target in L
//   D2   (q0 = a, q1 = b)        multiply by d[bit_a][bit_b]; D2(q, q) is a
//                                plain 1q diagonal
// A CNOT/CU control or a D2 bit outside L is constant over the block and is
// read from the block's base index.
//
// Arithmetic. The error-free transformations must not be contracted into
// FMAs by the compiler (nvcc contracts a*b+c by default): every operation
// is a round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which
// nvcc never contracts, and two_prod takes its error term from one explicit
// FMA, which is exact. df_add is QD's accurate "ieee_add", df_mul QD's
// product, in the order rocquantum_tpu/ops/pallas_df64.py applies them, so
// the kernel agrees with its plain-torch version to the last bit wherever
// the float64 error terms of the latter are exact.
//
// What bounds it. A pass reads and writes each plane once: 16 bytes per
// amplitude in the real carry, 32 in the complex one. A real gate costs
// each amplitude two df_mul and one df_add, ~40 float32 operations; a
// complex gate ~200. At the H100's 67 TFLOP/s (FP32) against 3.35 TB/s, a
// real-carry pass of more than ~8 gates is bound by arithmetic, not bytes.
// The design keeps the bytes at that minimum (one load and one store per
// plane, the low w bits contiguous so rows coalesce); the arithmetic runs
// from shared memory with a barrier between gates.
//
// Indices are 64-bit. C interface (ctypes): rocq_fused_layer_df64(...)
// returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 8;       // pair bits the kernel accepts
constexpr int kMaxLocalBits = 13;  // 2^13 amplitudes: 128 KiB in 4 planes
constexpr int kThreads = 512;

enum Kind : int { kU = 0, kCNOT = 1, kCU = 2, kD2 = 3 };

struct PassArgs {
  int n;                     // qubits
  int w;                     // low local bits
  int npairs;                // pair bits in use
  int pair_bits[kMaxPairs];  // ascending, each >= w
  int num_gates;
};

struct df {
  float hi, lo;
};

__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

__device__ __forceinline__ df quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ df df_add(df x, df y) {
  df s = two_sum(x.hi, y.hi);
  const df t = two_sum(x.lo, y.lo);
  s = quick_two_sum(s.hi, __fadd_rn(s.lo, t.hi));
  return quick_two_sum(s.hi, __fadd_rn(s.lo, t.lo));
}

__device__ __forceinline__ df df_neg(df x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ df df_mul(df x, df y) {
  const df p = two_prod(x.hi, y.hi);
  const float cross = __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi));
  return quick_two_sum(p.hi, __fadd_rn(p.lo, cross));
}

// Complex coefficient u = (u_re, u_im) times x = (x_re, x_im), as the JAX
// kernel orders it: re = u_re x_re - u_im x_im, im = u_re x_im + u_im x_re.
__device__ __forceinline__ df cmul_re(df ur, df ui, df xr, df xi) {
  return df_add(df_mul(ur, xr), df_neg(df_mul(ui, xi)));
}
__device__ __forceinline__ df cmul_im(df ur, df ui, df xr, df xi) {
  return df_add(df_mul(ur, xi), df_mul(ui, xr));
}

// Entry (row, col) of gate k: re part at e[0..1], im part at e[2..3].
__device__ __forceinline__ df coef(const float* m, int entry, int part) {
  return {m[entry * 4 + 2 * part], m[entry * 4 + 2 * part + 1]};
}

// Position of qubit q inside the local index, or -1 when q is outside L.
__device__ __forceinline__ int local_pos(int q, const PassArgs& a) {
  if (q < a.w) return q;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (j < a.npairs && a.pair_bits[j] == q) return a.w + j;
  }
  return -1;
}

// Insert a zero bit at position t of i.
__device__ __forceinline__ int insert_zero(int i, int t) {
  return ((i >> t) << (t + 1)) | (i & ((1 << t) - 1));
}

__device__ __forceinline__ uint64_t global_index(uint64_t base, int l,
                                                 const PassArgs& a) {
  uint64_t g = base | static_cast<uint64_t>(l & ((1 << a.w) - 1));
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (j < a.npairs) {
      g |= static_cast<uint64_t>((l >> (a.w + j)) & 1) << a.pair_bits[j];
    }
  }
  return g;
}

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
fused_layer_df64_kernel(float* __restrict__ rh, float* __restrict__ rl,
                        float* __restrict__ ih, float* __restrict__ il,
                        const int* __restrict__ specs,
                        const float* __restrict__ mats,
                        const int* __restrict__ real_flags, PassArgs a) {
  extern __shared__ float smem[];
  const int nloc = 1 << (a.w + a.npairs);
  float* s_rh = smem;
  float* s_rl = smem + nloc;
  float* s_ih = smem + 2 * nloc;  // used only when kComplex
  float* s_il = smem + 3 * nloc;

  // Base index: deposit the block index into the bits outside L (the low w
  // bits are local, then a zero is inserted at each pair bit, ascending).
  uint64_t base = static_cast<uint64_t>(blockIdx.x) << a.w;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (j < a.npairs) {
      const int p = a.pair_bits[j];
      const uint64_t low = base & ((uint64_t(1) << p) - 1);
      base = ((base >> p) << (p + 1)) | low;
    }
  }

  for (int l = threadIdx.x; l < nloc; l += blockDim.x) {
    const uint64_t g = global_index(base, l, a);
    s_rh[l] = rh[g];
    s_rl[l] = rl[g];
    if (kComplex) {
      s_ih[l] = ih[g];
      s_il[l] = il[g];
    }
  }
  __syncthreads();

  for (int k = 0; k < a.num_gates; ++k) {
    const int kind = specs[3 * k];
    const int q0 = specs[3 * k + 1];
    const int q1 = specs[3 * k + 2];
    const float* m = mats + 16 * k;
    const bool real_mat = !kComplex || real_flags[k] != 0;

    if (kind == kD2) {
      const int la = local_pos(q0, a);
      const int lb = local_pos(q1, a);
      const int fa = la < 0 ? static_cast<int>((base >> q0) & 1) : 0;
      const int fb = lb < 0 ? static_cast<int>((base >> q1) & 1) : 0;
      for (int l = threadIdx.x; l < nloc; l += blockDim.x) {
        const int ba = la < 0 ? fa : ((l >> la) & 1);
        const int bb = lb < 0 ? fb : ((l >> lb) & 1);
        const int e = ba * 2 + bb;
        const df dr = coef(m, e, 0);
        const df xr = {s_rh[l], s_rl[l]};
        if (!kComplex) {
          const df y = df_mul(xr, dr);
          s_rh[l] = y.hi;
          s_rl[l] = y.lo;
          continue;
        }
        const df xi = {s_ih[l], s_il[l]};
        df yr, yi;
        if (real_mat) {
          yr = df_mul(xr, dr);
          yi = df_mul(xi, dr);
        } else {
          const df di = coef(m, e, 1);
          yr = cmul_re(dr, di, xr, xi);
          yi = cmul_im(dr, di, xr, xi);
        }
        s_rh[l] = yr.hi;
        s_rl[l] = yr.lo;
        s_ih[l] = yi.hi;
        s_il[l] = yi.lo;
      }
    } else {
      // U, CNOT, CU: pairwise update on the target bit, gated by a control
      int lt, lc = -1;
      bool active = true;
      if (kind == kU) {
        lt = local_pos(q0, a);
      } else {
        lt = local_pos(q1, a);
        lc = local_pos(q0, a);
        if (lc < 0) active = ((base >> q0) & 1) != 0;  // free control
      }
      if (active && lt >= 0) {
        const int t_bit = 1 << lt;
        for (int i = threadIdx.x; i < (nloc >> 1); i += blockDim.x) {
          const int i0 = insert_zero(i, lt);
          if (lc >= 0 && !((i0 >> lc) & 1)) continue;
          const int i1 = i0 | t_bit;
          if (kind == kCNOT) {
            float t = s_rh[i0]; s_rh[i0] = s_rh[i1]; s_rh[i1] = t;
            t = s_rl[i0]; s_rl[i0] = s_rl[i1]; s_rl[i1] = t;
            if (kComplex) {
              t = s_ih[i0]; s_ih[i0] = s_ih[i1]; s_ih[i1] = t;
              t = s_il[i0]; s_il[i0] = s_il[i1]; s_il[i1] = t;
            }
            continue;
          }
          const df x0r = {s_rh[i0], s_rl[i0]};
          const df x1r = {s_rh[i1], s_rl[i1]};
          if (real_mat) {
            const df a00 = coef(m, 0, 0), a01 = coef(m, 1, 0);
            const df a10 = coef(m, 2, 0), a11 = coef(m, 3, 0);
            const df y0 = df_add(df_mul(a00, x0r), df_mul(a01, x1r));
            const df y1 = df_add(df_mul(a10, x0r), df_mul(a11, x1r));
            s_rh[i0] = y0.hi; s_rl[i0] = y0.lo;
            s_rh[i1] = y1.hi; s_rl[i1] = y1.lo;
            if (kComplex) {
              const df x0i = {s_ih[i0], s_il[i0]};
              const df x1i = {s_ih[i1], s_il[i1]};
              const df z0 = df_add(df_mul(a00, x0i), df_mul(a01, x1i));
              const df z1 = df_add(df_mul(a10, x0i), df_mul(a11, x1i));
              s_ih[i0] = z0.hi; s_il[i0] = z0.lo;
              s_ih[i1] = z1.hi; s_il[i1] = z1.lo;
            }
            continue;
          }
          const df x0i = {s_ih[i0], s_il[i0]};
          const df x1i = {s_ih[i1], s_il[i1]};
          df out[4];  // y0 re, y0 im, y1 re, y1 im
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const df ur = coef(m, 2 * r, 0), ui = coef(m, 2 * r, 1);
            const df vr = coef(m, 2 * r + 1, 0), vi = coef(m, 2 * r + 1, 1);
            out[2 * r] = df_add(cmul_re(ur, ui, x0r, x0i),
                                cmul_re(vr, vi, x1r, x1i));
            out[2 * r + 1] = df_add(cmul_im(ur, ui, x0r, x0i),
                                    cmul_im(vr, vi, x1r, x1i));
          }
          s_rh[i0] = out[0].hi; s_rl[i0] = out[0].lo;
          s_ih[i0] = out[1].hi; s_il[i0] = out[1].lo;
          s_rh[i1] = out[2].hi; s_rl[i1] = out[2].lo;
          s_ih[i1] = out[3].hi; s_il[i1] = out[3].lo;
        }
      }
    }
    __syncthreads();
  }

  for (int l = threadIdx.x; l < nloc; l += blockDim.x) {
    const uint64_t g = global_index(base, l, a);
    rh[g] = s_rh[l];
    rl[g] = s_rl[l];
    if (kComplex) {
      ih[g] = s_ih[l];
      il[g] = s_il[l];
    }
  }
}

template <bool kComplex>
cudaError_t launch(float* rh, float* rl, float* ih, float* il,
                   const int* specs, const float* mats, const int* real_flags,
                   const PassArgs& a, cudaStream_t stream) {
  const int nlocal_bits = a.w + a.npairs;
  const size_t smem =
      (size_t(1) << nlocal_bits) * sizeof(float) * (kComplex ? 4 : 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_layer_df64_kernel<kComplex>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks = 1u << (a.n - nlocal_bits);
  int threads = kThreads;
  while (threads > 32 && threads > (1 << nlocal_bits) / 2) threads >>= 1;
  fused_layer_df64_kernel<kComplex><<<blocks, threads, smem, stream>>>(
      rh, rl, ih, il, specs, mats, real_flags, a);
  return cudaGetLastError();
}

}  // namespace

// rh, rl (and ih, il): flat (2^n,) float32 hi/lo planes on the device;
// ih == il == nullptr selects the real carry (every gate matrix real).
// specs (K, 3) int32, mats (K, 2, 2, 4) float32, real_flags (K,) int32:
// device arrays. pair_bits: host array of npairs ascending bits, each in
// [w, n). Returns a cudaError_t.
extern "C" int rocq_fused_layer_df64(float* rh, float* rl, float* ih,
                                     float* il, const int* specs,
                                     const float* mats, const int* real_flags,
                                     int num_gates, int n, int w, int npairs,
                                     const int* pair_bits, void* stream) {
  if (n < 1 || w < 1 || w > n || npairs < 0 || npairs > kMaxPairs ||
      w + npairs > kMaxLocalBits || n - (w + npairs) > 30 || num_gates < 0 ||
      (ih == nullptr) != (il == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PassArgs a{};
  a.n = n;
  a.w = w;
  a.npairs = npairs;
  int prev = w - 1;
  for (int j = 0; j < npairs; ++j) {
    if (pair_bits[j] <= prev || pair_bits[j] >= n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.pair_bits[j] = pair_bits[j];
    prev = pair_bits[j];
  }
  a.num_gates = num_gates;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = ih == nullptr
      ? launch<false>(rh, rl, ih, il, specs, mats, real_flags, a, s)
      : launch<true>(rh, rl, ih, il, specs, mats, real_flags, a, s);
  return static_cast<int>(err);
}
