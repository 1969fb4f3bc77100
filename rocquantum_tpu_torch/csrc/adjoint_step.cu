// Adjoint step for Hopper (sm_90a): one parameterised gate's step of the
// reversible adjoint sweep (rocquantum_tpu_torch/autodiff.py) in one pass
// over the ket and the bra.
//
// What it replaces. No TPU kernel: the JAX package leaves the products
// dU/dtheta ket of its adjoint sweep to XLA (rocquantum_tpu/autodiff.py).
// The port ran each parameterised gate's step as a one-gate fused pass on
// the ket, four float64 plain-torch sums an entry of M (a float32 product,
// its cast to float64 and the sum; autodiff._correlation, kept as the path
// of CPU planes and of the exact engine), and a one-gate pass on the bra.
// Those sums set the gradient request's pace; this kernel was added for
// them.
//
// What it computes. For a gate on m <= 2 targets (sorted ascending by the
// host, which permutes V and tells the kernel to permute M back) and any
// controls, over the amplitudes where every control is 1, grouped by their
// target bits (group r, target value a):
//   ket'[r, c] = sum_d V[c, d] ket[r, d]        V = U^dagger, float32 FMAs
//   M[a, c]   += conj(bra[r, a]) ket'[r, c]     float64 products and sums
//   bra'[r, a] = sum_b V[a, b] bra[r, b]
// The planes are float32: one real plane each (then V is real), or (re, im)
// pairs of separate planes. The ket and the bra share their realness.
//
// Design. A thread takes 16-byte vectors: the 4 amplitudes of index bits
// 0-1 at one setting of the other free bits, for each setting of the
// targets above bit 1, from every plane. With no target on bits 0-1 (LT 0)
// a vector holds 4 groups; with the lowest target on bit 0 (LT 1) or on bit
// 1 (LT 2), 2 groups of adjacent (or alternate) amplitudes; with the two
// targets on bits 0 and 1 (LT 3), one. Controls on bits 0-1 mask groups
// inside a vector (their amplitudes are stored back as they were); the
// targets and controls above bit 1 are inserted into the vector index, so
// only amplitudes whose controls are 1 are read. Grid-stride blocks fill
// the SMs; each thread keeps its entries of M in float64 registers, a block
// reduces them through shared memory into its column of a scratch buffer,
// and a second launch sums each row of it in a fixed order into the output:
// no atomics, the same bits from run to run.
//
// What bounds it. Bytes: the ket and the bra are read once and written once
// (at n = 26, one real plane each: 1 GiB, 0.320 ms at 3.35 TB/s; a complex
// pair 0.641 ms). The float64 products are 4^m FMAs a group on real planes
// (4 x 4^m on complex ones), far below the card's FP64 rate at these bytes.
//
// C interface (ctypes): rocq_adjoint_step(...) returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFixed = 62;  // targets and controls above bit 1
// the geometry table of ops/adjoint_step.py (int64): m, lt, swap, nh,
// lcmask, chigh, nvec, toff[4], then nh vector-index bit positions
constexpr int kGeoHeader = 11;

struct Args {
  float* k0;  // ket re, ket im, bra re, bra im (the im planes unused on
  float* k1;  // real planes)
  float* b0;
  float* b1;
  float vr[4][4];  // V in the sorted target order, re and im
  float vi[4][4];
  long long toff[4];  // index offsets of the settings of the high targets
  long long chigh;    // the controls above bit 1, as index bits
  long long nvec;     // vectors: 2^(n - 2 - nh)
  double* partial;    // entry k of block b at partial[k * gridDim.x + b]
  int lcmask;         // the controls on bits 0-1
  int nh;             // bits inserted into the vector index
  int hpos[kMaxFixed];  // their positions in it (bit - 2), ascending
};

// the element of a vector holding target value al (its bits on 0-1) of the
// vector's group gi
__host__ __device__ constexpr int elem(int lt, int gi, int al) {
  return lt == 0 ? gi
       : lt == 1 ? ((gi << 1) | al)
       : lt == 2 ? (gi | (al << 1))
       : al;
}

__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}

// y = V x on D amplitudes, float32 FMAs (yi, xi unused on real planes)
template <int D, int NP>
__device__ __forceinline__ void apply_v(const Args& a, const float (&xr)[D],
                                        const float (&xi)[D], float (&yr)[D],
                                        float (&yi)[D]) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float r = 0.f, im = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      r = fmaf(a.vr[c][d], xr[d], r);
      if constexpr (NP == 2) {
        r = fmaf(-a.vi[c][d], xi[d], r);
        im = fmaf(a.vr[c][d], xi[d], im);
        im = fmaf(a.vi[c][d], xr[d], im);
      }
    }
    yr[c] = r;
    if constexpr (NP == 2) yi[c] = im;
  }
}

template <int M, int NP, int LT>
__global__ void __launch_bounds__(kThreads)
adjoint_step_kernel(const Args a) {
  constexpr int D = 1 << M;                            // amplitudes a group
  constexpr int NLOW = LT == 0 ? 0 : (LT == 3 ? 2 : 1);  // targets on 0-1
  constexpr int S = 1 << (M - NLOW);                   // vectors a plane
  constexpr int G = 4 >> NLOW;                         // groups a vector
  constexpr int DD = D * D;
  constexpr int K = NP * DD;                           // entries of M kept
  __shared__ double s_red[kThreads / 32][K];

  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       v < a.nvec; v += stride) {
    long long x = v;
    for (int i = 0; i < a.nh; ++i) {
      const int p = a.hpos[i];
      x = ((x >> p) << (p + 1)) | (x & ((1LL << p) - 1));
    }
    const long long base = (x << 2) | a.chigh;
    float kr[S][4], ki[S][4], br[S][4], bi[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long off = base + a.toff[s];
      load4(kr[s], a.k0 + off);
      load4(br[s], a.b0 + off);
      if constexpr (NP == 2) {
        load4(ki[s], a.k1 + off);
        load4(bi[s], a.b1 + off);
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if ((elem(LT, gi, 0) & a.lcmask) != a.lcmask) continue;
      float xr[D], xi[D], yr[D], yi[D];
#pragma unroll
      for (int t = 0; t < D; ++t) {
        const int e = elem(LT, gi, t & ((1 << NLOW) - 1));
        const int s = t >> NLOW;
        xr[t] = kr[s][e];
        yr[t] = br[s][e];
        if constexpr (NP == 2) {
          xi[t] = ki[s][e];
          yi[t] = bi[s][e];
        }
      }
      float nr[D], ni[D], mr[D], mi[D];
      apply_v<D, NP>(a, xr, xi, nr, ni);
      // M[a, c] += conj(bra[a]) ket'[c] from the bra before its update
#pragma unroll
      for (int ai = 0; ai < D; ++ai) {
        const double pr = yr[ai];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          acc[ai * D + c] = fma(pr, static_cast<double>(nr[c]),
                                acc[ai * D + c]);
          if constexpr (NP == 2) {
            const double pi = yi[ai];
            acc[ai * D + c] = fma(pi, static_cast<double>(ni[c]),
                                  acc[ai * D + c]);
            acc[DD + ai * D + c] = fma(
                pr, static_cast<double>(ni[c]),
                fma(-pi, static_cast<double>(nr[c]), acc[DD + ai * D + c]));
          }
        }
      }
      apply_v<D, NP>(a, yr, yi, mr, mi);
#pragma unroll
      for (int t = 0; t < D; ++t) {
        const int e = elem(LT, gi, t & ((1 << NLOW) - 1));
        const int s = t >> NLOW;
        kr[s][e] = nr[t];
        br[s][e] = mr[t];
        if constexpr (NP == 2) {
          ki[s][e] = ni[t];
          bi[s][e] = mi[t];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long off = base + a.toff[s];
      store4(a.k0 + off, kr[s]);
      store4(a.b0 + off, br[s]);
      if constexpr (NP == 2) {
        store4(a.k1 + off, ki[s]);
        store4(a.b1 + off, bi[s]);
      }
    }
  }

  // the block's sums, in a fixed order: warps by shuffles, then the warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double x = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) s_red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += s_red[w][threadIdx.x];
    a.partial[static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x] =
        s;
  }
}

// out[part][a][c] (a (2, 4, 4) float64 row) = the sum of entry k's
// `blocks` partials in a fixed order, k = part * D * D + a' * D + c' in
// the sorted target order (swapped back to the caller's when `swap`); 0
// for the imaginary part of real planes (entries >= `kept`)
__global__ void __launch_bounds__(kThreads)
finish_kernel(const double* __restrict__ partial, int blocks, int d, int kept,
              int swap, double* __restrict__ out) {
  __shared__ double s_red[kThreads / 32];
  const int k = blockIdx.x;
  double acc = 0.0;
  if (k < kept) {
    const double* p = partial + static_cast<long long>(k) * blocks;
    for (int b = threadIdx.x; b < blocks; b += kThreads) acc += p[b];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  }
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += s_red[w];
    const int part = k / (d * d);
    int ai = (k / d) % d, c = k % d;
    if (swap) {
      ai = ((ai & 1) << 1) | (ai >> 1);
      c = ((c & 1) << 1) | (c >> 1);
    }
    out[part * 16 + ai * 4 + c] = s;
  }
}

template <int M, int NP, int LT>
int launch(Args& a, int capacity, int swap, double* out,
           cudaStream_t stream) {
  constexpr int D = 1 << M;
  // per device: the grid that fills it (the blocks each SM holds at once)
  static int grid_of[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!grid_of[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adjoint_step_kernel<M, NP, LT>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_of[dev] = sms * per_sm;
  }
  long long grid = (a.nvec + kThreads - 1) / kThreads;
  if (grid > grid_of[dev]) grid = grid_of[dev];
  if (grid > capacity) grid = capacity;
  adjoint_step_kernel<M, NP, LT><<<static_cast<unsigned>(grid), kThreads, 0,
                                   stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  finish_kernel<<<2 * D * D, kThreads, 0, stream>>>(
      a.partial, static_cast<int>(grid), D, NP * D * D, swap, out);
  return static_cast<int>(cudaGetLastError());
}

template <int M, int NP>
int by_layout(int lt, Args& a, int capacity, int swap, double* out,
              cudaStream_t s) {
  switch (lt) {
    case 0: return launch<M, NP, 0>(a, capacity, swap, out, s);
    case 1: return launch<M, NP, 1>(a, capacity, swap, out, s);
    case 2: return launch<M, NP, 2>(a, capacity, swap, out, s);
    case 3:
      if constexpr (M == 2) return launch<M, NP, 3>(a, capacity, swap, out, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// planes: 1 (real) or 2 ((re, im) pairs). k0, k1, b0, b1: the ket's and the
// bra's float32 planes (k1, b1 unused on real planes), each 2^n amplitudes,
// 16-byte aligned, updated in place. v: the host's 32 floats of V, re then
// im, 4 x 4 row-major in the sorted target order (the top-left 2^m x 2^m
// used). geo: the host's int64 geometry table (kGeoHeader + nh entries).
// partial: capacity x 32 float64 scratch (the grid is capped at capacity).
// out: the (2, 4, 4) float64 row of M, its 2 x 2^m x 2^m entries written.
// Returns a cudaError_t.
extern "C" int rocq_adjoint_step(int planes, float* k0, float* k1, float* b0,
                                 float* b1, const float* v,
                                 const long long* geo, int geo_len,
                                 double* partial, int capacity, double* out,
                                 void* stream) {
  if ((planes != 1 && planes != 2) || !k0 || !b0 ||
      (planes == 2 && (!k1 || !b1)) || !v || !geo || !partial || !out ||
      capacity < 1 || geo_len < kGeoHeader) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m = static_cast<int>(geo[0]);
  const int lt = static_cast<int>(geo[1]);
  const int swap = static_cast<int>(geo[2]);
  const int nh = static_cast<int>(geo[3]);
  if (m < 1 || m > 2 || lt < 0 || lt > (m == 2 ? 3 : 2) || nh < 0 ||
      nh > kMaxFixed || geo_len != kGeoHeader + nh || geo[6] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.k0 = k0;
  a.k1 = planes == 2 ? k1 : k0;
  a.b0 = b0;
  a.b1 = planes == 2 ? b1 : b0;
  for (int r = 0; r < 4; ++r) {
    for (int c = 0; c < 4; ++c) {
      a.vr[r][c] = v[r * 4 + c];
      a.vi[r][c] = v[16 + r * 4 + c];
    }
  }
  a.lcmask = static_cast<int>(geo[4]);
  a.chigh = geo[5];
  a.nvec = geo[6];
  for (int s = 0; s < 4; ++s) a.toff[s] = geo[7 + s];
  a.nh = nh;
  for (int i = 0; i < kMaxFixed; ++i) {
    a.hpos[i] = i < nh ? static_cast<int>(geo[kGeoHeader + i]) : 0;
  }
  a.partial = partial;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1) {
    return planes == 1 ? by_layout<1, 1>(lt, a, capacity, swap, out, s)
                       : by_layout<1, 2>(lt, a, capacity, swap, out, s);
  }
  return planes == 1 ? by_layout<2, 1>(lt, a, capacity, swap, out, s)
                     : by_layout<2, 2>(lt, a, capacity, swap, out, s);
}
