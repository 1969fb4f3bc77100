// Fused gate-layer pass over an f32 state vector, for Hopper (sm_90a).
//
// What it replaces. In the JAX package five Pallas TPU kernels compute one
// function -- apply an ordered gate list to every amplitude in one in-place
// pass, optionally starting from |0...0> -- split by what fits VMEM and
// Mosaic's reshape rules (rocquantum_tpu/ops/pallas_sv.py):
//   _kernel               (:780)   gates inside the 17-bit window
//   _kernel_merged        (:931)   plus one contiguous run of pair bits
//   _kernel_multi         (:1083)  plus two or three runs of pair bits
//   _gen_zero_input       (:1622)  |0...0> written in the first pass's view
//   init_zero_state_tiled (:1667)  |0...0> as a plane in the kernels' layout
// Here they are one kernel. A pass has a LOCAL SET L of index bits: the low
// w bits plus up to kMaxPairs "pair bits" anywhere above them. Each block
// owns one assignment of the bits outside L, loads its 2^|L| amplitudes
// into shared memory, applies every gate of the list there, and writes the
// amplitudes back in place. Blocks own disjoint amplitudes, so in place is
// safe. Gen-zero mode skips the load and starts the block from |0...0>
// (with an empty gate list it is the init kernel).
//
// Gate kinds (spec table rows (kind, q0, q1), matrices [k][row][col][re/im]):
//   U    (q0 = target)           dense 2x2 on a bit of L
//   CNOT (q0 = control, q1 = t)  conditional swap; target in L
//   CU   (q0 = control, q1 = t)  conditional 2x2; target in L
//   D2   (q0 = a, q1 = b)        multiply by d[bit_a][bit_b]; D2(q, q) is a
//                                plain 1q diagonal
// A CNOT/CU control or a D2 bit outside L is constant over the block: it is
// read from the block's base index (the counterpart of _free_bit_sel,
// pallas_sv.py:222).
//
// What bounds it. A pass reads and writes each plane once: 8 bytes per
// amplitude per plane. Per gate it does 3-14 FLOPs per amplitude from
// shared memory, so a pass of a few dozen gates stays below the H100's
// ~20 FLOP/byte balance point and is bound by device-memory bandwidth.
// The design keeps the pass at that minimum: the low w bits are contiguous,
// so loads and stores move 2^w consecutive floats (4 KiB at w = 10) per
// row; every gate of the pass runs from shared memory with no extra device
// traffic. Cutting the number of passes per layer (a larger L) is the lever
// left for later work.
//
// Indices are 64-bit: 2^31 amplitudes (n = 31) overflow int32. The grid is
// one-dimensional, so a pass takes at most 2^30 blocks (n <= 40 at w = 10).
//
// C interface (ctypes): rocq_fused_layer(...) returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 8;     // pair bits the kernel accepts
constexpr int kMaxLocalBits = 14;  // 2^14 amplitudes: 64 KiB per plane
constexpr int kThreads = 512;

enum Kind : int { kU = 0, kCNOT = 1, kCU = 2, kD2 = 3 };

struct PassArgs {
  int n;             // qubits
  int w;             // low local bits
  int npairs;        // pair bits in use
  int pair_bits[kMaxPairs];  // ascending, each >= w
  int num_gates;
  int gen_zero;      // 1: start from |0...0> instead of loading
};

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

template <bool kComplex>
__global__ void __launch_bounds__(kThreads)
fused_layer_kernel(float* __restrict__ re, float* __restrict__ im,
                   const int* __restrict__ specs,
                   const float* __restrict__ mats,
                   const int* __restrict__ real_flags, PassArgs a) {
  extern __shared__ float smem[];
  const int nlocal_bits = a.w + a.npairs;
  const int nloc = 1 << nlocal_bits;
  float* s_re = smem;
  float* s_im = smem + nloc;  // used only when kComplex

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
  const int wmask = (1 << a.w) - 1;

  // Load (or generate) the block's amplitudes. Consecutive threads take
  // consecutive local indices, so the low w bits give coalesced rows.
  for (int l = threadIdx.x; l < nloc; l += blockDim.x) {
    if (a.gen_zero) {
      s_re[l] = (base == 0 && l == 0) ? 1.0f : 0.0f;
      if (kComplex) s_im[l] = 0.0f;
    } else {
      uint64_t g = base | static_cast<uint64_t>(l & wmask);
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        if (j < a.npairs) {
          g |= static_cast<uint64_t>((l >> (a.w + j)) & 1) << a.pair_bits[j];
        }
      }
      s_re[l] = re[g];
      if (kComplex) s_im[l] = im[g];
    }
  }
  __syncthreads();

  for (int k = 0; k < a.num_gates; ++k) {
    const int kind = specs[3 * k];
    const int q0 = specs[3 * k + 1];
    const int q1 = specs[3 * k + 2];
    const float* m = mats + 8 * k;  // m[(row * 2 + col) * 2 + part]
    const bool real_mat = !kComplex || real_flags[k] != 0;

    if (kind == kD2) {
      const int la = local_pos(q0, a);
      const int lb = local_pos(q1, a);
      const int fa = la < 0 ? static_cast<int>((base >> q0) & 1) : 0;
      const int fb = lb < 0 ? static_cast<int>((base >> q1) & 1) : 0;
      for (int l = threadIdx.x; l < nloc; l += blockDim.x) {
        const int ba = la < 0 ? fa : ((l >> la) & 1);
        const int bb = lb < 0 ? fb : ((l >> lb) & 1);
        const int e = (ba * 2 + bb) * 2;
        const float dr = m[e];
        if (real_mat) {
          s_re[l] *= dr;
          if (kComplex) s_im[l] *= dr;
        } else {
          const float di = m[e + 1];
          const float xr = s_re[l];
          const float xi = s_im[l];
          s_re[l] = dr * xr - di * xi;
          s_im[l] = dr * xi + di * xr;
        }
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
          const float x0r = s_re[i0], x1r = s_re[i1];
          if (kind == kCNOT) {
            s_re[i0] = x1r;
            s_re[i1] = x0r;
            if (kComplex) {
              const float x0i = s_im[i0];
              s_im[i0] = s_im[i1];
              s_im[i1] = x0i;
            }
          } else if (real_mat) {
            s_re[i0] = m[0] * x0r + m[2] * x1r;
            s_re[i1] = m[4] * x0r + m[6] * x1r;
            if (kComplex) {
              const float x0i = s_im[i0], x1i = s_im[i1];
              s_im[i0] = m[0] * x0i + m[2] * x1i;
              s_im[i1] = m[4] * x0i + m[6] * x1i;
            }
          } else {
            const float x0i = s_im[i0], x1i = s_im[i1];
            s_re[i0] = m[0] * x0r - m[1] * x0i + m[2] * x1r - m[3] * x1i;
            s_im[i0] = m[0] * x0i + m[1] * x0r + m[2] * x1i + m[3] * x1r;
            s_re[i1] = m[4] * x0r - m[5] * x0i + m[6] * x1r - m[7] * x1i;
            s_im[i1] = m[4] * x0i + m[5] * x0r + m[6] * x1i + m[7] * x1r;
          }
        }
      }
    }
    __syncthreads();
  }

  for (int l = threadIdx.x; l < nloc; l += blockDim.x) {
    uint64_t g = base | static_cast<uint64_t>(l & wmask);
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      if (j < a.npairs) {
        g |= static_cast<uint64_t>((l >> (a.w + j)) & 1) << a.pair_bits[j];
      }
    }
    re[g] = s_re[l];
    if (kComplex) im[g] = s_im[l];
  }
}

template <bool kComplex>
cudaError_t launch(float* re, float* im, const int* specs, const float* mats,
                   const int* real_flags, const PassArgs& a,
                   cudaStream_t stream) {
  const int nlocal_bits = a.w + a.npairs;
  const size_t smem =
      (size_t(1) << nlocal_bits) * sizeof(float) * (kComplex ? 2 : 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_layer_kernel<kComplex>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks = 1u << (a.n - nlocal_bits);
  int threads = kThreads;
  while (threads > 32 && threads > (1 << nlocal_bits) / 2) threads >>= 1;
  fused_layer_kernel<kComplex><<<blocks, threads, smem, stream>>>(
      re, im, specs, mats, real_flags, a);
  return cudaGetLastError();
}

}  // namespace

// re, im: flat (2^n,) float32 planes on the device; im == nullptr selects
// the real-plane mode (every gate matrix real). specs (K, 3) int32, mats
// (K, 2, 2, 2) float32, real_flags (K,) int32: device arrays. pair_bits:
// host array of npairs ascending bits, each in [w, n). gen_zero: ignore
// the contents of re/im and start from |0...0>. Returns a cudaError_t.
extern "C" int rocq_fused_layer(float* re, float* im, const int* specs,
                                const float* mats, const int* real_flags,
                                int num_gates, int n, int w, int npairs,
                                const int* pair_bits, int gen_zero,
                                void* stream) {
  if (n < 1 || w < 1 || w > n || npairs < 0 || npairs > kMaxPairs ||
      w + npairs > kMaxLocalBits || n - (w + npairs) > 30 || num_gates < 0) {
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
  a.gen_zero = gen_zero;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = im == nullptr
      ? launch<false>(re, im, specs, mats, real_flags, a, s)
      : launch<true>(re, im, specs, mats, real_flags, a, s);
  return static_cast<int>(err);
}
