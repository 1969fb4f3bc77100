// Fused gate-layer pass over an f32 state vector, and the |0...0> fill, for
// Hopper (sm_90a).
//
// What it replaces. In the JAX package five Pallas TPU kernels compute two
// functions (rocquantum_tpu/ops/pallas_sv.py):
//   _kernel               (:780)   gates inside the 17-bit window
//   _kernel_merged        (:931)   plus one contiguous run of pair bits
//   _kernel_multi         (:1083)  plus two or three runs of pair bits
//   _gen_zero_input       (:1622)  |0...0> written in the first pass's view
//   init_zero_state_tiled (:1667)  |0...0> as a plane in the kernels' layout
// The first four are rocq_fused_pass: apply an ordered list of gates to
// every amplitude in one in-place pass, optionally starting from |0...0>
// instead of reading the state. The fifth is rocq_init_zero, a plain fill.
//
// Geometry. A launch has a LOCAL SET of T index bits (10 <= T <= 15): bits
// 0-6 (w = 7, one 512-byte row), every bit a gate of the pass targets
// above them, and padding up to 10 bits; the planner keeps T <= 12 on the
// real plane and T <= 13 on re+im. One block owns one TILE: the 2^T
// amplitudes of one assignment of the bits outside the local set. Its
// threads hold 2^R amplitudes each, in registers: on the real plane
// R = min(T - 5, 7), so a tile of up to 12 bits is one warp whose
// registers hold every bit off the lanes (a pass that still needs
// exchanges runs at R = 5: its gates' code stays short and more warps
// share the SM); on re+im R = 5. Which local bit
// is which bit of a thread's register index (a "register bit") or of its
// thread index (a "thread bit": 5 lane bits, then warp bits) is the
// LAYOUT. The host plans the layouts of a pass (ops/fused_sv.py,
// pass_schedule):
//   - the load and store layouts put local bits 0-1 on register bits 0-1
//     (one float4) and local bits 2-6 on the lanes, so every warp moves
//     512 contiguous bytes with 16-byte accesses; the other register bits
//     pick further float4s, which is where pair bits usually sit;
//   - a gate's target is always a register bit, so the gate runs in
//     registers with no barrier; its control or diagonal bits may be
//     register bits, thread bits or free bits (outside the local set, read
//     from the tile's base index: the counterpart of _free_bit_sel,
//     pallas_sv.py:222);
//   - when the next gates need targets that are thread bits, an exchange
//     op moves the tile to a new layout through shared memory: every
//     thread writes its 2^R amplitudes and reads them back, two barriers
//     per exchange, not one per gate. The word of local index l is l XOR a
//     5-bit flip of each of its bits 5 and up, which the host chooses per
//     exchange (swap_banks) so that neither side has bank conflicts.
// The gate table is decoded on the host (kinds, register bits, bit
// sources, matrices) and passed by value as a kernel parameter: no device
// table, no copy per pass.
//
// Gate ops (matrices m[(row * 2 + col) * 2 + re/im]):
//   U    dense 2x2 on register bit t
//   CNOT conditional swap on register bit t, control source a
//   CU   conditional 2x2 on register bit t, control source a
//   D2   multiply by m[bit_a][bit_b] (source b "none": bit_b = 0)
//   SWAP move the tile to layout t through shared memory (m's bytes: the
//        bank flip of each local position >= 5)
//
// What bounds it. A pass reads and writes each plane once: 8 bytes per
// amplitude and plane. A real 2x2 gate costs 3 FP32 operations per
// amplitude, so a pass of a few dozen gates is below the card's balance
// point and bound by device-memory bandwidth. Loads are 16 bytes wide and a
// block issues all of them before its first gate; the other resident
// blocks of the SM (8-25 warps) overlap one tile's gates with other tiles'
// loads and stores. A pass without exchanges runs near the speed of a
// device copy; a pass with many window gates adds their FP32 work and its
// exchanges' shared-memory traffic (PERF.md).
//
// Batches. The planes may hold b states of 2^n amplitudes each, one after
// the other ((b, 2^n), element k at offset k << n). One launch covers the
// whole batch: the grid is b * 2^(n - T) blocks, and block k owns tile
// k & (2^(n - T) - 1) of element k >> (n - T). Each block is still one tile
// of one element, so nothing inside a tile changes with the batch; only
// the |0...0> mode is unbatched.
//
// Indices are 64-bit: 2^31 amplitudes (n = 31) overflow int32. A launch
// takes at most 2^31 - 1 blocks (gridDim.x), batch included.
//
// C interface (ctypes): rocq_fused_pass(...) and rocq_init_zero(...) return
// a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBits = 5;
constexpr int kMinTileBits = 5 + kLaneBits;
constexpr int kMaxTileBits = 15;
constexpr int kMaxWarpBits = 3;         // at most 256 threads a block
constexpr int kMaxOps = 96;
constexpr int kMaxLayouts = 8;
constexpr int kSlots = 16;              // local positions per layout record

enum Kind : int { kU = 0, kCNOT = 1, kCU = 2, kD2 = 3, kSwap = 4 };
// bit source: class << 8 | index (register bit, thread bit or qubit)
enum SrcClass : int { kNone = 0, kReg = 1, kThread = 2, kFree = 3 };

struct Op {                // 40 bytes
  unsigned char kind;
  unsigned char real;      // 1: every entry of m is real
  unsigned char t;         // target register bit; layout index for kSwap
  unsigned char pad;
  short a, b;              // bit sources: the control (a), or D2's bits
  float m[8];
};

struct PassParams {
  int n, w, tile_bits, reg_bits, num_ops, gen_zero;
  int batch;                               // states in the planes, >= 1
  signed char lbits[kSlots];               // qubit of each local position
  // per layout: local position of register bits 0..R-1, then of thread bits
  signed char layouts[kMaxLayouts][kSlots];
  Op ops[kMaxOps];
};
static_assert(sizeof(Op) == 40, "Op must match ops/fused_sv.py");
static_assert(sizeof(PassParams) == 4012,
              "PassParams must match ops/fused_sv.py");

// Value of a bit source that is constant over a thread's registers (0 for
// a register source, whose value depends on the register index).
__device__ __forceinline__ int src_uniform(int s, int tid, uint64_t base) {
  const int cls = s >> 8, idx = s & 0xff;
  if (cls == kThread) return (tid >> idx) & 1;
  if (cls == kFree) return static_cast<int>((base >> idx) & 1);
  return 0;
}

// Register-index mask of a register source, else 0.
__device__ __forceinline__ int src_mask(int s) {
  return (s >> 8) == kReg ? 1 << (s & 0xff) : 0;
}

// Shared-memory word of local position p alone: a linear, invertible
// swizzle (bits 5 and up also flip the bank bits g[p - 5]).
__device__ __forceinline__ int swizzle_unit(int p, const unsigned char* g) {
  return p < 5 ? (1 << p) : ((1 << p) ^ g[p - 5]);
}

// Global offset of this thread's register 0 in layout L, tile base
// excluded.
template <int kR>
__device__ __forceinline__ uint64_t thread_offset(const PassParams& p,
                                                  int L, int tid) {
  uint64_t off = 0;
  for (int k = 0; k < p.tile_bits - kR; ++k) {
    if ((tid >> k) & 1) off |= uint64_t(1) << p.lbits[p.layouts[L][kR + k]];
  }
  return off;
}

// Move the tile between global memory and registers in IO layout L
// (registers 0-1 = local bits 0-1, lanes = local bits 2-6): float4 v of a
// thread is at ``start`` | the offsets of the register bits set in v.
template <int kR, bool kStore>
__device__ __forceinline__ void move_plane(float* plane, float (&a)[1 << kR],
                                           const PassParams& p, int L,
                                           uint64_t start) {
  uint64_t roff[kR];
#pragma unroll
  for (int k = 2; k < kR; ++k) {
    roff[k] = uint64_t(1) << p.lbits[p.layouts[L][k]];
  }
#pragma unroll
  for (int v = 0; v < (1 << kR) / 4; ++v) {
    uint64_t g = start;
#pragma unroll
    for (int k = 2; k < kR; ++k) {
      if ((v >> (k - 2)) & 1) g |= roff[k];
    }
    float4* ptr = reinterpret_cast<float4*>(plane + g);
    if (kStore) {
      __stcs(ptr, make_float4(a[4 * v], a[4 * v + 1], a[4 * v + 2],
                              a[4 * v + 3]));
    } else {
      const float4 x = __ldcs(ptr);
      a[4 * v] = x.x;
      a[4 * v + 1] = x.y;
      a[4 * v + 2] = x.z;
      a[4 * v + 3] = x.w;
    }
  }
}

// Base index of tile `tile`: deposit it into the bits outside the local
// set (bits 0..w-1, then a zero inserted at each local bit above them,
// ascending).
__device__ __forceinline__ uint64_t tile_base(const PassParams& p,
                                              uint64_t tile) {
  uint64_t base = tile << p.w;
  for (int i = p.w; i < p.tile_bits; ++i) {
    const int q = p.lbits[i];
    base = ((base >> q) << (q + 1)) | (base & ((uint64_t(1) << q) - 1));
  }
  return base;
}

// Shared-memory words of one layout: the thread's part and one unit per
// register bit (the word of register j is thr ^ the units of j's bits).
template <int kR>
struct Words {
  int thr;
  int reg[kR];
};

template <int kR>
__device__ __forceinline__ Words<kR> layout_words(const PassParams& p, int L,
                                                  int tid,
                                                  const unsigned char* g) {
  Words<kR> out;
  out.thr = 0;
  for (int k = 0; k < p.tile_bits - kR; ++k) {
    if ((tid >> k) & 1) out.thr ^= swizzle_unit(p.layouts[L][kR + k], g);
  }
#pragma unroll
  for (int k = 0; k < kR; ++k) out.reg[k] = swizzle_unit(p.layouts[L][k], g);
  return out;
}

template <int kR>
__device__ __forceinline__ int word_of(const Words<kR>& w, int j) {
  int ad = w.thr;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if ((j >> k) & 1) ad ^= w.reg[k];
  }
  return ad;
}

// One plane from layout `from` to layout `to` through shared memory.
template <int kR>
__device__ __forceinline__ void exchange_plane(float (&a)[1 << kR],
                                               float* smem,
                                               const Words<kR>& from,
                                               const Words<kR>& to) {
  __syncthreads();  // the previous exchange's reads are done
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) smem[word_of(from, j)] = a[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) a[j] = smem[word_of(to, j)];
}

// U, CNOT or CU on register bit kT; with kMasked, only where the register
// control mask cmask is set.
template <int kR, int kT, bool kComplex, bool kMasked>
__device__ __forceinline__ void pair_op(float (&ar)[1 << kR],
                                        float (&ai)[1 << kR], const Op& op,
                                        int cmask) {
  constexpr int kHalf = 1 << (kR - 1);
  constexpr int tbit = 1 << kT;
  if (op.kind == kCNOT) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int i0 = ((i >> kT) << (kT + 1)) | (i & (tbit - 1));
      const int i1 = i0 | tbit;
      const bool on = !kMasked || (i0 & cmask) != 0;
      const float x0 = ar[i0], x1 = ar[i1];
      ar[i0] = on ? x1 : x0;
      ar[i1] = on ? x0 : x1;
      if (kComplex) {
        const float y0 = ai[i0], y1 = ai[i1];
        ai[i0] = on ? y1 : y0;
        ai[i1] = on ? y0 : y1;
      }
    }
    return;
  }
  const float m00 = op.m[0], m01 = op.m[2], m10 = op.m[4], m11 = op.m[6];
  if (!kComplex || op.real) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int i0 = ((i >> kT) << (kT + 1)) | (i & (tbit - 1));
      const int i1 = i0 | tbit;
      const bool on = !kMasked || (i0 & cmask) != 0;
      const float x0 = ar[i0], x1 = ar[i1];
      const float y0 = m00 * x0 + m01 * x1, y1 = m10 * x0 + m11 * x1;
      ar[i0] = on ? y0 : x0;
      ar[i1] = on ? y1 : x1;
      if (kComplex) {
        const float u0 = ai[i0], u1 = ai[i1];
        const float v0 = m00 * u0 + m01 * u1, v1 = m10 * u0 + m11 * u1;
        ai[i0] = on ? v0 : u0;
        ai[i1] = on ? v1 : u1;
      }
    }
    return;
  }
  const float n00 = op.m[1], n01 = op.m[3], n10 = op.m[5], n11 = op.m[7];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int i0 = ((i >> kT) << (kT + 1)) | (i & (tbit - 1));
    const int i1 = i0 | tbit;
    const bool on = !kMasked || (i0 & cmask) != 0;
    const float x0r = ar[i0], x0i = ai[i0], x1r = ar[i1], x1i = ai[i1];
    const float y0r = m00 * x0r - n00 * x0i + m01 * x1r - n01 * x1i;
    const float y0i = m00 * x0i + n00 * x0r + m01 * x1i + n01 * x1r;
    const float y1r = m10 * x0r - n10 * x0i + m11 * x1r - n11 * x1i;
    const float y1i = m10 * x0i + n10 * x0r + m11 * x1i + n11 * x1r;
    ar[i0] = on ? y0r : x0r;
    ai[i0] = on ? y0i : x0i;
    ar[i1] = on ? y1r : x1r;
    ai[i1] = on ? y1i : x1i;
  }
}

template <int kR, int kT, bool kComplex>
__device__ __forceinline__ void pair_dispatch(float (&ar)[1 << kR],
                                              float (&ai)[1 << kR],
                                              const Op& op, int cmask) {
  if (cmask) {
    pair_op<kR, kT, kComplex, true>(ar, ai, op, cmask);
  } else {
    pair_op<kR, kT, kComplex, false>(ar, ai, op, 0);
  }
}

// The pair gate on the runtime register bit op.t, as a compile-time one.
template <int kR, bool kComplex>
__device__ __forceinline__ void pair_switch(float (&ar)[1 << kR],
                                            float (&ai)[1 << kR],
                                            const Op& op, int cmask) {
  static_assert(kR >= 5 && kR <= 7, "one case per register bit");
  switch (op.t) {
    case 0: pair_dispatch<kR, 0, kComplex>(ar, ai, op, cmask); break;
    case 1: pair_dispatch<kR, 1, kComplex>(ar, ai, op, cmask); break;
    case 2: pair_dispatch<kR, 2, kComplex>(ar, ai, op, cmask); break;
    case 3: pair_dispatch<kR, 3, kComplex>(ar, ai, op, cmask); break;
    case 4: pair_dispatch<kR, 4, kComplex>(ar, ai, op, cmask); break;
    case 5:
      if constexpr (kR > 5) pair_dispatch<kR, 5, kComplex>(ar, ai, op, cmask);
      break;
    default:
      if constexpr (kR > 6) pair_dispatch<kR, 6, kComplex>(ar, ai, op, cmask);
      break;
  }
}

// D2: multiply register j by m[bit_a(j)][bit_b(j)].
template <int kR, bool kComplex>
__device__ __forceinline__ void diag_op(float (&ar)[1 << kR],
                                        float (&ai)[1 << kR], const Op& op,
                                        int tid, uint64_t base) {
  const int ua = src_uniform(op.a, tid, base);
  const int ub = src_uniform(op.b, tid, base);
  const int ma = src_mask(op.a), mb = src_mask(op.b);
  const bool cplx = kComplex && !op.real;
  // the four factors of (register bit a, register bit b)
  const int e00 = (ua << 1) | ub;
  const int e01 = (ua << 1) | (ub | (mb != 0));
  const int e10 = ((ua | (ma != 0)) << 1) | ub;
  const int e11 = ((ua | (ma != 0)) << 1) | (ub | (mb != 0));
  const float r00 = op.m[2 * e00], r01 = op.m[2 * e01];
  const float r10 = op.m[2 * e10], r11 = op.m[2 * e11];
  const float i00 = op.m[2 * e00 + 1], i01 = op.m[2 * e01 + 1];
  const float i10 = op.m[2 * e10 + 1], i11 = op.m[2 * e11 + 1];
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) {
    const bool x = (j & ma) != 0, y = (j & mb) != 0;
    const float dr = x ? (y ? r11 : r10) : (y ? r01 : r00);
    if (!cplx) {
      ar[j] *= dr;
      if (kComplex) ai[j] *= dr;
    } else {
      const float di = x ? (y ? i11 : i10) : (y ? i01 : i00);
      const float xr = ar[j], xi = ai[j];
      ar[j] = dr * xr - di * xi;
      ai[j] = dr * xi + di * xr;
    }
  }
}

// Apply the pass's records to one tile in registers; returns the layout in
// force at the end.
template <int kR, bool kComplex>
__device__ __forceinline__ int apply_ops(float (&ar)[1 << kR],
                                         float (&ai)[1 << kR], float* smem,
                                         const PassParams& p, int tid,
                                         uint64_t base) {
  int cur = 0;
  for (int k = 0; k < p.num_ops; ++k) {
    const Op& op = p.ops[k];
    const int kind = op.kind;
    if (kind == kSwap) {
      const unsigned char* g = reinterpret_cast<const unsigned char*>(op.m);
      const Words<kR> from = layout_words<kR>(p, cur, tid, g);
      const Words<kR> to = layout_words<kR>(p, op.t, tid, g);
      exchange_plane<kR>(ar, smem, from, to);
      if (kComplex) exchange_plane<kR>(ai, smem, from, to);
      cur = op.t;
      continue;
    }
    if (kind == kD2) {
      diag_op<kR, kComplex>(ar, ai, op, tid, base);
      continue;
    }
    int cmask = 0;
    if (kind != kU) {
      cmask = src_mask(op.a);
      if (cmask == 0 && !src_uniform(op.a, tid, base)) continue;
    }
    pair_switch<kR, kComplex>(ar, ai, op, cmask);
  }
  return cur;
}

// kR register bits per thread; launch bounds of kThreads threads and
// kBlocks resident blocks per SM. Block k owns tile k & (2^(n - T) - 1) of
// batch element k >> (n - T).
template <bool kComplex, int kR, int kThreads, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fused_pass_kernel(float* __restrict__ re, float* __restrict__ im,
                  const __grid_constant__ PassParams p) {
  constexpr int kRegs = 1 << kR;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tile_log = p.n - p.tile_bits;
  const uint64_t block = blockIdx.x;
  const uint64_t element = (block >> tile_log) << p.n;
  re += element;
  if (kComplex) im += element;
  const uint64_t base =
      tile_base(p, block & ((uint64_t(1) << tile_log) - 1));
  const uint64_t load_off = thread_offset<kR>(p, 0, tid);
  float ar[kRegs], ai[kRegs];
  if (p.gen_zero) {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) ar[j] = ai[j] = 0.0f;
    if (base == 0 && load_off == 0) ar[0] = 1.0f;
  } else {
    move_plane<kR, false>(re, ar, p, 0, base | load_off);
    if (kComplex) move_plane<kR, false>(im, ai, p, 0, base | load_off);
  }
  const int cur = apply_ops<kR, kComplex>(ar, ai, smem, p, tid, base);
  const uint64_t start = base | thread_offset<kR>(p, cur, tid);
  move_plane<kR, true>(re, ar, p, cur, start);
  if (kComplex) move_plane<kR, true>(im, ai, p, cur, start);
}

template <bool kComplex, int kR, int kThreads, int kBlocks>
cudaError_t launch_pass(float* re, float* im, const PassParams& p,
                        cudaStream_t stream) {
  auto kernel = fused_pass_kernel<kComplex, kR, kThreads, kBlocks>;
  bool exchanges = false;
  for (int k = 0; k < p.num_ops; ++k) exchanges |= p.ops[k].kind == kSwap;
  const size_t smem =
      exchanges ? (size_t(1) << p.tile_bits) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks =
      static_cast<unsigned int>(p.batch) << (p.n - p.tile_bits);
  const int threads = 1 << (p.tile_bits - kR);
  kernel<<<blocks, threads, smem, stream>>>(re, im, p);
  return cudaGetLastError();
}

bool valid_source(int s, const PassParams& p) {
  const int cls = s >> 8, idx = s & 0xff;
  const int r = p.reg_bits;
  switch (cls) {
    case kNone: return idx == 0;
    case kReg: return idx < r;
    case kThread: return idx < p.tile_bits - r;
    case kFree: return idx < p.n;
    default: return false;
  }
}

bool valid_params(const PassParams& p) {
  const int t = p.tile_bits;
  if (t < kMinTileBits || t > kMaxTileBits || p.n < t || p.n - t > 31 ||
      p.batch < 1 || (uint64_t(p.batch) << (p.n - t)) > 0x7fffffffu ||
      (p.gen_zero && p.batch != 1) ||
      p.w < 1 || p.w > t || p.num_ops < 0 || p.num_ops > kMaxOps ||
      p.reg_bits < 5 || p.reg_bits > 7 || t - p.reg_bits < kLaneBits ||
      t - p.reg_bits > kLaneBits + kMaxWarpBits) {
    return false;
  }
  for (int i = 0; i < t; ++i) {
    if (p.lbits[i] < 0 || p.lbits[i] >= p.n) return false;
    if (i < p.w ? p.lbits[i] != i : p.lbits[i] <= p.lbits[i - 1]) {
      return false;
    }
  }
  int layouts = 1;
  for (int k = 0; k < p.num_ops; ++k) {
    const Op& op = p.ops[k];
    if (op.kind > kSwap) return false;
    if (op.kind == kSwap ? op.t >= kMaxLayouts
                         : (op.kind != kD2 && op.t >= p.reg_bits)) {
      return false;
    }
    if (op.kind == kSwap && op.t >= layouts) layouts = op.t + 1;
    if (!valid_source(op.a, p) || !valid_source(op.b, p)) return false;
  }
  // every layout in use is a permutation of the local positions
  for (int L = 0; L < layouts; ++L) {
    int seen = 0;
    for (int i = 0; i < t; ++i) {
      const int pos = p.layouts[L][i];
      if (pos < 0 || pos >= t || ((seen >> pos) & 1)) return false;
      seen |= 1 << pos;
    }
  }
  return true;
}

__global__ void init_zero_kernel(float4* __restrict__ out, uint64_t nvec) {
  const uint64_t stride = uint64_t(gridDim.x) * blockDim.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (uint64_t i = uint64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    __stcs(out + i, i == 0 ? make_float4(1.0f, 0.0f, 0.0f, 0.0f) : zero);
  }
}

__global__ void init_zero_small_kernel(float* out, int size) {
  if (static_cast<int>(threadIdx.x) < size) out[threadIdx.x] = threadIdx.x == 0;
}

}  // namespace

// re, im: (batch, 2^n) float32 planes on the device, contiguous and 16-byte
// aligned; im == nullptr selects the real-plane mode (every gate real; the
// only mode with more than 5 register bits). params: a host PassParams
// (ops/fused_sv.py packs it), passed to the kernel by value. Returns a
// cudaError_t.
extern "C" int rocq_fused_pass(float* re, float* im, const void* params,
                               void* stream) {
  const PassParams& p = *static_cast<const PassParams*>(params);
  if (re == nullptr || !valid_params(p) ||
      (im != nullptr && p.reg_bits != 5)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (im != nullptr) {
    err = launch_pass<true, 5, 256, 2>(re, im, p, s);
  } else if (p.reg_bits == 5) {
    err = launch_pass<false, 5, 256, 3>(re, im, p, s);
  } else if (p.reg_bits == 6) {
    err = launch_pass<false, 6, 256, 1>(re, im, p, s);
  } else {
    err = launch_pass<false, 7, 256, 1>(re, im, p, s);
  }
  return static_cast<int>(err);
}

// out: a flat (2^n,) float32 plane on the device, 16-byte aligned; writes
// |0...0> (1 at index 0, 0 elsewhere) with 16-byte streaming stores,
// about four blocks per SM striding over the plane. Returns a cudaError_t.
extern "C" int rocq_init_zero(float* out, int n, void* stream) {
  if (out == nullptr || n < 0 || n > 40) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 2) {
    init_zero_small_kernel<<<1, 32, 0, s>>>(out, 1 << n);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  const uint64_t nvec = uint64_t(1) << (n - 2);
  const uint64_t need = (nvec + kThreads - 1) / kThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      need < uint64_t(4) * sms ? need : uint64_t(4) * sms);
  init_zero_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<float4*>(out), nvec);
  return static_cast<int>(cudaGetLastError());
}
