// Pauli-sum readout for Hopper (sm_90a): sum_k c_k <psi|P_k|psi> in a few
// tiled sweeps over the state's planes.
//
// What it replaces. No TPU kernel: the JAX package's readout is jitted jnp
// (rocquantum_tpu/ops/pairsim.py:416 expval_terms_pair), which XLA fuses.
// The eager port ran it as 3 to 5 whole-plane torch operations a term
// (ops/pairsim.py, kept as the plain version), and that readout set the
// pace of an energy request; this kernel was added for it.
//
// What it computes. A term is encoded on the host (ops/pauli_readout.py) as
// i^k X^a Z^b; its value is Re(i^k S) with
//   S = sum_x conj(psi(x ^ a)) (-1)^popcount(x & b) psi(x),
// which is Re S (mode 0) or Im S (mode 1) times a sign the host folds into
// the term's coefficient. A real state (one plane) has Im S = 0, so the
// host drops its mode-1 terms. The kernel returns sum_k coef_k * value_k,
// one float64 per row of the planes.
//
// Design. A tile of 2^T amplitudes (32 KiB) sits in shared memory. The
// tile's local index l has the k1 low index bits as its low bits (rows of
// 2^k1 contiguous amplitudes: 128-byte loads) and, above them, the
// coordinates along T - k1 high vectors v_i chosen per sweep: the tile is
// the coset base ^ span(v_i) ^ [0, 2^k1), with base spread over the other
// ("outer") bits by the block index. A term whose flip mask a lies in a
// sweep's span pairs amplitudes inside one tile: local flip a_l. Its sign
// splits into par(base & b), one sign a block, and par(l & b_l) with b_l
// the mask in local coordinates. The host plans the sweeps so that every
// flip mask lies in one of them (greedy over the masks' high parts).
// Persistent blocks (3 a SM) walk the tiles of every sweep and row, each
// with two tile buffers: the next tile's cp.async copies (16-byte pieces of
// the rows where the planes allow, else one amplitude at a time) go out
// before the current tile is read.
//
// Each of the 256 threads takes local indices l = tid | (j << 8) | (c << 12)
// for j in [0, CH), CH = 16 (8 for complex float64), chunk c. The sign over
// j is a Walsh function: diagonal terms (a = 0) read the thread's chunk once
// through an in-register Walsh-Hadamard transform of its |psi|^2 in float64
// (r 2^r adds), then each term takes one coefficient of it, grouped by the
// j part of b_l (host-sorted), with one popcount a term a chunk for the rest
// of the sign. A flip term reads each amplitude's partner from shared
// memory (a complex state keeps (re, im) pairs side by side): one load at an
// immediate offset and one or two FMAs an amplitude, the term's flip of the
// j bits being a switch over compile-time register orders; the sign over j
// is a host-made bit pattern when b_l has j bits, else none.
//
// Numerics. Products round in the planes' dtype (FMA into a partial over the
// chunk's CH amplitudes, in the planes' dtype); every partial joins a
// float64 sum. Block partials go to a float64 buffer that a second launch
// reduces row by row in a fixed order, with no atomics: the answer is the
// same bit for bit from run to run.
//
// What bounds it. Each sweep reads every plane once (2 GiB a float32 plane
// at n = 29: 0.64 ms at 3.35 TB/s). Measured on an H100, the per-term work
// of the flips, not the bytes, sets its pace, and the copies of the next
// tile overlap it little: TFIM at n = 29 on a float32 plane takes about 3x
// the byte time of its 3 sweeps (PERF.md section 6).
//
// C interface (ctypes): rocq_pauli_readout(...) returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThreadBits = 8;
constexpr int kMaxTerms = 256;      // terms a sweep (the host splits above)
constexpr int kSweepHeader = 24;
constexpr int kTermFields = 6;
constexpr int kTileBytes = 32 * 1024;  // one tile buffer; a block holds two
constexpr int kBlocksPerSM = 3;

// plan layout (int64, built by ops/pauli_readout.py):
//   sweep header s at [24 s]: d[0..16] diagonal term offsets by the j
//   part w of b_l (terms d[w]..d[w+1]); [17] end of the flip terms with no
//   j bits in b_l; [18] end of the flip terms with j bits; [19] offset of
//   the sweep's 2^(T-k1) row offsets; [20] offset of its n - T outer bit
//   positions.
//   term t at [term0 + 6 t]: a_l, b_l, b (global), mode, jpat, coef index.
struct Args {
  const void* p0;
  const void* p1;
  long long es0, rs0, es1, rs1;  // element and row strides, in elements
  const long long* plan;
  const double* coef;  // a term's coefficient, the same for every row
  double* partial;    // one float64 a tile
  long long tiles;    // rows * nsweeps * 2^(n - T)
  int n, T, k1, nsweeps;
  int vec;            // 16-byte copies: unit-stride plane or (re, im) pairs
  long long term0;    // offset of the first term record in the plan
};

// a tile's element in shared memory: an amplitude, or a (re, im) pair
template <typename F, int NP> struct Amp { using T = F; };
template <> struct Amp<float, 2> { using T = float2; };
template <> struct Amp<double, 2> { using T = double2; };

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else if (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ int parity(unsigned x) { return __popc(x) & 1; }

// the tile's base: block index blk spread over the sweep's nb outer bits
// (lane i places bit i; the warp ORs them)
__device__ __forceinline__ unsigned long long block_base(
    const long long* outer, int nb, long long blk) {
  const int lane = threadIdx.x & 31;
  unsigned long long v = 0;
  if (lane < nb) v = static_cast<unsigned long long>((blk >> lane) & 1)
                     << __ldg(outer + lane);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct TileId {
  long long row, blk;
  int sweep;
};

__device__ __forceinline__ TileId tile_id(const Args& a, long long tau) {
  const int nb = a.n - a.T;
  const long long rs = tau >> nb;
  TileId id;
  id.blk = tau & ((1LL << nb) - 1);
  id.sweep = static_cast<int>(rs % a.nsweeps);
  id.row = rs / a.nsweeps;
  return id;
}

// start the copies of tile tau into buf (local index l at buf[l]) and
// commit them as one group: 16-byte pieces of the tile's rows (VEC), else
// amplitude by amplitude
template <typename F, int NP>
__device__ __forceinline__ void load_tile(const Args& a, long long tau,
                                          typename Amp<F, NP>::T* buf) {
  using A = typename Amp<F, NP>::T;
  const TileId id = tile_id(a, tau);
  const long long* hdr = a.plan + kSweepHeader * id.sweep;
  const unsigned long long base =
      block_base(a.plan + __ldg(hdr + 20), a.n - a.T, id.blk);
  const long long* rowoff = a.plan + __ldg(hdr + 19);
  const int k1 = a.k1;
  const long long tile = 1LL << a.T;
  const long long colmask = (1LL << k1) - 1;
  const F* g0 = static_cast<const F*>(a.p0) + id.row * a.rs0;
  const int tid = threadIdx.x;
  if (a.vec) {
    // pieces of E amplitudes; a piece never crosses a tile row
    constexpr int E = 16 / static_cast<int>(sizeof(A));
    const long long pieces = tile / E;
#pragma unroll
    for (int i = 0; i < kTileBytes / 16 / kThreads; ++i) {
      const long long q = tid + static_cast<long long>(i) * kThreads;
      if (q < pieces) {
        const long long l = q * E;
        const long long g = static_cast<long long>(
            (base ^ static_cast<unsigned long long>(__ldg(rowoff + (l >> k1))))
            | static_cast<unsigned long long>(l & colmask));
        cp_async<16>(buf + l, g0 + g * NP);
      }
    }
  } else {
    const F* g1 = static_cast<const F*>(a.p1) + id.row * a.rs1;
    F* out = reinterpret_cast<F*>(buf);
#pragma unroll 8
    for (int i = 0; i < kTileBytes / static_cast<int>(sizeof(A)) / kThreads;
         ++i) {
      const long long l = tid + static_cast<long long>(i) * kThreads;
      if (l < tile) {
        const long long g = static_cast<long long>(
            (base ^ static_cast<unsigned long long>(__ldg(rowoff + (l >> k1))))
            | static_cast<unsigned long long>(l & colmask));
        cp_async<sizeof(F)>(out + l * NP, g0 + g * a.es0);
        if (NP == 2) cp_async<sizeof(F)>(out + l * NP + 1, g1 + g * a.es1);
      }
    }
  }
  cp_commit();
}

template <typename F>
__device__ __forceinline__ F sq(F x) { return x * x; }
__device__ __forceinline__ float sq(float2 x) { return x.x * x.x + x.y * x.y; }
__device__ __forceinline__ double sq(double2 x) {
  return x.x * x.x + x.y * x.y;
}

// the product of partner u with own v: u v on a real plane; on (re, im)
// pairs Re(conj(u) v) = u_re v_re + u_im v_im, or, IMAG, Im(conj(u) v) =
// u_re v_im - u_im v_re; in the planes' dtype
template <bool IMAG>
__device__ __forceinline__ float prod(float u, float v, float acc) {
  return fma(u, v, acc);
}
template <bool IMAG>
__device__ __forceinline__ double prod(double u, double v, double acc) {
  return fma(u, v, acc);
}
template <bool IMAG, typename P>
__device__ __forceinline__ auto prod(P u, P v, decltype(u.x) acc) {
  return IMAG ? fma(u.x, v.y, fma(-u.y, v.x, acc))
              : fma(u.x, v.x, fma(u.y, v.y, acc));
}

// the sum over the chunk's CH own amplitudes v of their product with their
// partners, own j's partner being pu[(j ^ JQ) << 8]. The loop runs over
// m = j ^ JQ, so each partner load takes an immediate offset and each own
// amplitude a fixed register. SIGNED: negated where bit j of jp is set.
template <int JQ, typename A, int CH, bool SIGNED, bool IMAG>
__device__ __forceinline__ auto flip_sum_q(const A* pu, const A (&v)[CH],
                                           unsigned jp) {
  using F = decltype(prod<IMAG>(v[0], v[0], 0));
  F part = F(0);
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int j = m ^ JQ;
    const A u = pu[m << kThreadBits];
    if (SIGNED) {
      const F q = prod<IMAG>(u, v[j], F(0));
      part += ((jp >> j) & 1) ? -q : q;
    } else {
      part = prod<IMAG>(u, v[j], part);
    }
  }
  return part;
}

#define ROCQ_CASE(q)                                                     \
  case q:                                                                \
    if constexpr (q < CH) {                                              \
      return flip_sum_q<q, A, CH, SIGNED, IMAG>(pu, v, jp);              \
    }                                                                    \
    break;

// flip_sum_q for the runtime JQ (the flip's bits among j's)
template <typename A, int CH, bool SIGNED, bool IMAG>
__device__ __forceinline__ auto flip_sum(const A* pu, const A (&v)[CH],
                                         int jq, unsigned jp) {
  switch (jq) {
    ROCQ_CASE(0) ROCQ_CASE(1) ROCQ_CASE(2) ROCQ_CASE(3)
    ROCQ_CASE(4) ROCQ_CASE(5) ROCQ_CASE(6) ROCQ_CASE(7)
    ROCQ_CASE(8) ROCQ_CASE(9) ROCQ_CASE(10) ROCQ_CASE(11)
    ROCQ_CASE(12) ROCQ_CASE(13) ROCQ_CASE(14) ROCQ_CASE(15)
  }
  return decltype(flip_sum_q<0, A, CH, SIGNED, IMAG>(pu, v, jp))(0);
}
#undef ROCQ_CASE

template <typename F, int NP, int CHB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
pauli_sweep_kernel(Args a) {
  using A = typename Amp<F, NP>::T;
  constexpr int CH = 1 << CHB;
  constexpr int kMinTile = 1 << (kThreadBits + CHB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint4 s_t[kMaxTerms];  // a_l, b_l, jpat | mode << 31
  __shared__ double s_c[kMaxTerms], s_craw[kMaxTerms];
  __shared__ unsigned long long s_bg[kMaxTerms];
  __shared__ int s_hdr[kSweepHeader];
  __shared__ double s_red[kThreads / 32];

  const int tid = threadIdx.x;
  const long long tile = 1LL << a.T;
  const long long pad = tile > kMinTile ? tile : kMinTile;
  A* const buf0 = reinterpret_cast<A*>(smem_raw);  // buffer b: buf0 + b pad
  // past a tile smaller than a chunk's reach: zeros, in both buffers
  for (long long l = tile + tid; l < pad; l += kThreads) {
    buf0[l] = A{};
    buf0[pad + l] = A{};
  }
  const int chunks = static_cast<int>(pad >> (kThreadBits + CHB));
  int have_sweep = -1;

  long long tau = blockIdx.x;
  if (tau < a.tiles) load_tile<F, NP>(a, tau, buf0);
  for (int b = 0; tau < a.tiles; tau += gridDim.x, b ^= 1) {
    // the next tile's copies go out before this one is read
    const long long next = tau + gridDim.x;
    if (next < a.tiles) {
      load_tile<F, NP>(a, next, buf0 + (b ^ 1) * pad);
    } else {
      cp_commit();
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    const TileId id = tile_id(a, tau);
    __syncthreads();
    if (id.sweep != have_sweep) {
      // the sweep's header, terms and coefficients
      const long long* hdr = a.plan + kSweepHeader * id.sweep;
      if (tid < kSweepHeader) s_hdr[tid] = static_cast<int>(__ldg(hdr + tid));
      const int first = static_cast<int>(__ldg(hdr + 0));
      const int end = static_cast<int>(__ldg(hdr + 18));
      for (int t = first + tid; t < end; t += kThreads) {
        const long long* rec = a.plan + a.term0 + kTermFields * t;
        const int i = t - first;
        s_t[i] = make_uint4(static_cast<unsigned>(__ldg(rec + 0)),
                            static_cast<unsigned>(__ldg(rec + 1)),
                            static_cast<unsigned>(__ldg(rec + 4)) |
                                (static_cast<unsigned>(__ldg(rec + 3)) << 31),
                            0u);
        s_bg[i] = static_cast<unsigned long long>(__ldg(rec + 2));
        s_craw[i] = a.coef[__ldg(rec + 5)];
      }
      have_sweep = id.sweep;
      __syncthreads();
    }
    const int t_first = s_hdr[0];
    {
      // the coefficients signed by par(base & b), one sign a tile
      const long long* hdr = a.plan + kSweepHeader * id.sweep;
      const unsigned long long base =
          block_base(a.plan + __ldg(hdr + 20), a.n - a.T, id.blk);
      for (int i = tid; i < s_hdr[18] - t_first; i += kThreads)
        s_c[i] = (__popcll(base & s_bg[i]) & 1) ? -s_craw[i] : s_craw[i];
    }
    __syncthreads();
    const A* t = buf0 + b * pad;
    double acc = 0.0;

    // diagonal terms: a Walsh-Hadamard transform of the chunk's |psi|^2
    if (s_hdr[16] > t_first) {
      for (int c = 0; c < chunks; ++c) {
        double w[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          w[j] = static_cast<double>(
              sq(t[tid | (((c << CHB) | j) << kThreadBits)]));
        }
#pragma unroll
        for (int h = 1; h < CH; h <<= 1) {
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            if (!(j & h)) {
              const double x = w[j], y = w[j | h];
              w[j] = x + y;
              w[j | h] = x - y;
            }
          }
        }
        const unsigned lc = static_cast<unsigned>(tid) |
                            (static_cast<unsigned>(c) << (kThreadBits + CHB));
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          double d = 0.0;
          for (int k = s_hdr[j]; k < s_hdr[j + 1]; ++k) {
            const int i = k - t_first;
            d += parity(lc & s_t[i].y) ? -s_c[i] : s_c[i];
          }
          acc += w[j] * d;
        }
      }
    }

    // flip terms: each amplitude with its partner l ^ a_l; first those
    // whose sign has no j part, then those with a sign pattern over j
    if (s_hdr[18] > s_hdr[16]) {
      for (int c = 0; c < chunks; ++c) {
        A v[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j)
          v[j] = t[tid | (((c << CHB) | j) << kThreadBits)];
        const unsigned lc = static_cast<unsigned>(tid) |
                            (static_cast<unsigned>(c) << (kThreadBits + CHB));
        for (int k = s_hdr[16]; k < s_hdr[18]; ++k) {
          const int i = k - t_first;
          const uint4 rec = s_t[i];
          const unsigned jp = rec.z;
          // the partner of own j: (lc ^ a_l) with j ^ jq in the j bits
          const unsigned pl = lc ^ rec.x;
          const int jq = static_cast<int>(pl >> kThreadBits) & (CH - 1);
          const A* pu = t + (pl & ~(static_cast<unsigned>(CH - 1)
                                    << kThreadBits));
          const bool imag = NP == 2 && (jp >> 31);
          F part;
          if (k < s_hdr[17]) {
            part = imag ? flip_sum<A, CH, false, true>(pu, v, jq, jp)
                        : flip_sum<A, CH, false, false>(pu, v, jq, jp);
          } else {
            part = imag ? flip_sum<A, CH, true, true>(pu, v, jq, jp)
                        : flip_sum<A, CH, true, false>(pu, v, jq, jp);
          }
          const double cs = parity(lc & rec.y) ? -s_c[i] : s_c[i];
          acc += static_cast<double>(part) * cs;
        }
      }
    }

    // the tile's partial, reduced in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if ((tid & 31) == 0) s_red[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) s += s_red[k];
      a.partial[tau] = s;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// out[r] = sum of the `count` partials of row r, in a fixed order
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const double* __restrict__ partial, long long count,
                   double* __restrict__ out) {
  __shared__ double s_red[kThreads / 32];
  const double* p = partial + blockIdx.x * count;
  double acc = 0.0;
  for (long long i = threadIdx.x; i < count; i += kThreads) acc += p[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) s += s_red[k];
    out[blockIdx.x] = s;
  }
}

template <typename F, int NP, int CHB>
int launch(Args& a, long long rows, double* out, cudaStream_t stream) {
  using A = typename Amp<F, NP>::T;
  constexpr int kMinTile = 1 << (kThreadBits + CHB);
  const long long tile = 1LL << a.T;
  const long long pad = tile > kMinTile ? tile : kMinTile;
  if (pad * static_cast<long long>(sizeof(A)) > kTileBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 2 * kTileBytes;
  // per device: the shared-memory limit (an attribute) and the grid that
  // fills it (kBlocksPerSM blocks on each SM, where they fit)
  static int grid_of[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!grid_of[dev]) {
    e = cudaFuncSetAttribute(pauli_sweep_kernel<F, NP, CHB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pauli_sweep_kernel<F, NP, CHB>, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_of[dev] = sms * per_sm;
  }
  a.tiles = rows * a.nsweeps << (a.n - a.T);
  const long long grid = a.tiles < grid_of[dev] ? a.tiles : grid_of[dev];
  pauli_sweep_kernel<F, NP, CHB><<<static_cast<unsigned>(grid), kThreads,
                                   smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>(a.nsweeps) << (a.n - a.T);
  reduce_rows_kernel<<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      a.partial, count, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64. planes: 1 (real) or 2 (re, im). p0, p1:
// the planes' first elements; es/rs: element and row strides in elements.
// vec: 16-byte copies (a unit-stride plane, or the (re, im) pairs of a
// complex tensor's .real/.imag views, rows 16-byte aligned). rows planes
// of 2^n amplitudes each. plan: the device plan (int64) of
// ops/pauli_readout.py, with T tile bits, k1 low bits, nsweeps sweeps and
// its first term record at term0. coef: the terms' float64 coefficients.
// partial: rows * nsweeps * 2^(n - T) float64; out: rows float64. Returns
// a cudaError_t.
extern "C" int rocq_pauli_readout(int dtype, int planes, const void* p0,
                                  const void* p1, long long es0,
                                  long long rs0, long long es1, long long rs1,
                                  int vec, long long rows, int n, int T,
                                  int k1, int nsweeps, const long long* plan,
                                  long long term0, const double* coef,
                                  double* partial, double* out,
                                  void* stream) {
  if (rows < 1 || rows > 65535 || n < 0 || T < 0 || T > n || k1 < 0 ||
      k1 > T || n - T > 30 || nsweeps < 1 || nsweeps > 65535 ||
      (planes != 1 && planes != 2) || (dtype != 0 && dtype != 1) || !p0 ||
      (planes == 2 && !p1) || !plan || !coef || !partial || !out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.p0 = p0;
  a.p1 = planes == 2 ? p1 : p0;
  a.es0 = es0;
  a.rs0 = rs0;
  a.es1 = es1;
  a.rs1 = rs1;
  a.vec = vec;
  a.plan = plan;
  a.coef = coef;
  a.partial = partial;
  a.tiles = 0;
  a.n = n;
  a.T = T;
  a.k1 = k1;
  a.nsweeps = nsweeps;
  a.term0 = term0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return planes == 1 ? launch<float, 1, 4>(a, rows, out, s)
                       : launch<float, 2, 4>(a, rows, out, s);
  }
  return planes == 1 ? launch<double, 1, 4>(a, rows, out, s)
                     : launch<double, 2, 3>(a, rows, out, s);
}
