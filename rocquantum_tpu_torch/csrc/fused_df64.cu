// Fused gate-layer pass over a double-float (df64) state vector, for Hopper
// (sm_90a).
//
// What it replaces. In the JAX package two Pallas TPU kernels compute one
// function -- apply an ordered gate list to every amplitude of a state held
// as hi/lo float32 planes, in compensated arithmetic, in one in-place pass
// (rocquantum_tpu/ops/pallas_df64.py):
//   _kernel_df        (:240)  gates inside the 17-bit window
//   _kernel_multi_df  (:274)  plus up to three runs of pair bits
// Here they are one kernel, rocq_fused_pass_df64.
//
// State planes. x = hi + lo with |lo| <= ulp(hi)/2 for each component:
//   real carry     (re_hi, re_lo)               2 planes
//   complex carry  (re_hi, re_lo, im_hi, im_lo) 4 planes
//
// Geometry: that of csrc/fused_sv.cu, planned on the host by the same
// scheduler (ops/fused_sv.py, pass_schedule, with ops/fused_df64.py's
// RULE). A launch has a LOCAL SET of T index bits (10 <= T <= 13): bits
// 0-6 (one 512-byte row of each plane a warp), every bit a gate targets
// above them, and padding up to 10 bits. One block owns one TILE, the 2^T
// amplitudes of one assignment of the bits outside the local set; its
// threads hold 2^R amplitudes each in registers, hi and lo of every
// component: R = 5 on the real carry (64 registers of state), R = 4 on the
// complex carry (64 as well). The LAYOUT says which local bit is which
// register bit and which thread bit (5 lane bits, then up to 4 warp bits):
//   - the load and store layouts put local bits 0-1 on register bits 0-1
//     and local bits 2-6 on the lanes: each plane moves as one float4 a
//     thread, 512 contiguous bytes a warp; the pair bits are deposited into
//     the address once per tile (the tile base and one offset per register
//     bit);
//   - a gate's target is always a register bit, so the gate runs in
//     registers with no barrier; a control or diagonal bit is a register
//     bit, a thread bit or a free bit (outside the local set, read from the
//     tile's base index);
//   - when the next gates target thread bits, an exchange moves every plane
//     to a new layout through shared memory (2^T x 4 bytes a plane, the
//     bank swizzle of fused_sv.cu chosen on the host): two barriers per
//     exchange, not one per gate.
// The records are decoded on the host and passed by value: a 7080-byte
// parameter block of 96 records of 72 bytes (each 2x2 entry as re_hi,
// re_lo, im_hi, im_lo), above the classic 4 KiB limit. It relies on the
// large kernel parameters of CUDA >= 12.1 (up to 32764 bytes on sm_70 and
// up), so a pass of up to 96 records is one launch; a longer one is split
// on the host in list order.
//
// Gate ops (entry e = row * 2 + col, or bit_a * 2 + bit_b for D2):
//   U    dense 2x2 on register bit t
//   CNOT conditional swap of registers on bit t, control source a
//   CU   conditional 2x2 on register bit t, control source a
//   D2   multiply by entry (bit_a, bit_b) (source b "none": bit_b = 0)
//   SWAP move the tile to layout t through shared memory (m's bytes: the
//        bank flip of each local position >= 5)
//
// Arithmetic. The error-free transformations must not be contracted into
// FMAs by the compiler (nvcc contracts a*b+c by default): every operation
// is a round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which
// nvcc never contracts, and two_prod takes its error term from one explicit
// FMA, which is exact. df_add is QD's accurate "ieee_add", df_mul QD's
// product, in the order rocquantum_tpu/ops/pallas_df64.py applies them, so
// the kernel agrees with its plain-torch version to the last bit wherever
// the float64 error terms of the latter are exact. The scheduler may run
// gates on disjoint qubits in another order than the list, which changes
// the last bits (df64 rounding depends on the order), not the value.
//
// What bounds it. A pass reads and writes each plane once: 16 bytes per
// amplitude on the real carry, 32 on the complex one. A real gate costs
// each amplitude two df_mul (9 FP32 instructions each) and one df_add (20):
// 38 instructions; at the H100's 33.5e12 FP32 instructions/s against
// 3.35 TB/s a real-carry pass of more than ~4 gates is bound by its
// arithmetic. So the design removes every instruction that is not
// arithmetic: no shared-memory sweep and barrier per gate, coefficients
// read once per gate (a broadcast from the parameter block), addresses
// built once per tile, 16-byte accesses; and enough tiles are resident on
// an SM to overlap one tile's arithmetic with other tiles' loads.
//
// Registers (nvcc 12.9, -Xptxas -v). Uncapped, the real-carry instance
// takes 168 registers and spills nothing, which leaves 12 one-warp tiles
// (2^10 amplitudes) on an SM; capped at 128 it keeps 16 and spills four
// amplitudes to local memory (a 16-byte stack frame, L1 traffic), and the
// passes of the n = 26 ansatz take ~17% less time (PERF.md). The complex
// instance is capped at 128 by its 512 threads and spills a little as well.
//
// Indices are 64-bit. C interface (ctypes): rocq_fused_pass_df64(...)
// returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBits = 5;
constexpr int kMinTileBits = 10;
constexpr int kMaxTileBits = 13;
constexpr int kMaxWarpBits = 4;         // at most 512 threads a block
constexpr int kMaxOps = 96;
constexpr int kMaxLayouts = 8;
constexpr int kSlots = 16;              // local positions per layout record
constexpr int kRealRegBits = 5;
constexpr int kComplexRegBits = 4;
// Resident blocks of 256 threads the real-carry instance is compiled for:
// 2 caps it at 128 registers (see the note on registers above).
constexpr int kRealMinBlocks = 2;

enum Kind : int { kU = 0, kCNOT = 1, kCU = 2, kD2 = 3, kSwap = 4 };
// bit source: class << 8 | index (register bit, thread bit or qubit)
enum SrcClass : int { kNone = 0, kReg = 1, kThread = 2, kFree = 3 };

struct Op {                // 72 bytes
  unsigned char kind;
  unsigned char real;      // 1: every entry is real
  unsigned char t;         // target register bit; layout index for kSwap
  unsigned char pad;
  short a, b;              // bit sources: the control (a), or D2's bits
  float m[16];             // entry e: re_hi, re_lo, im_hi, im_lo at 4e
};

struct PassParams {
  int n, w, tile_bits, reg_bits, num_ops, pad;
  signed char lbits[kSlots];               // qubit of each local position
  // per layout: local position of register bits 0..R-1, then of thread bits
  signed char layouts[kMaxLayouts][kSlots];
  Op ops[kMaxOps];
};
static_assert(sizeof(Op) == 72, "Op must match ops/fused_df64.py");
static_assert(sizeof(PassParams) == 7080,
              "PassParams must match ops/fused_df64.py");

// ---- df64 arithmetic --------------------------------------------------

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

// Complex coefficient u = (ur, ui) times x = (xr, xi), as the JAX kernel
// orders it: re = ur xr - ui xi, im = ur xi + ui xr.
__device__ __forceinline__ df cmul_re(df ur, df ui, df xr, df xi) {
  return df_add(df_mul(ur, xr), df_neg(df_mul(ui, xi)));
}
__device__ __forceinline__ df cmul_im(df ur, df ui, df xr, df xi) {
  return df_add(df_mul(ur, xi), df_mul(ui, xr));
}

__device__ __forceinline__ df pick(bool on, df y, df x) {
  return {on ? y.hi : x.hi, on ? y.lo : x.lo};
}

// Entry e of a record: part 0 the real, part 1 the imaginary component.
__device__ __forceinline__ df coef(const Op& op, int e, int part) {
  return {op.m[4 * e + 2 * part], op.m[4 * e + 2 * part + 1]};
}

// ---- the tile in registers --------------------------------------------

// hi and lo of each component of a thread's 2^kR amplitudes (ih and il
// stay unused on the real carry).
template <int kR>
struct Amps {
  float rh[1 << kR], rl[1 << kR], ih[1 << kR], il[1 << kR];
};

template <int kR>
__device__ __forceinline__ df re(const Amps<kR>& s, int j) {
  return {s.rh[j], s.rl[j]};
}
template <int kR>
__device__ __forceinline__ df im(const Amps<kR>& s, int j) {
  return {s.ih[j], s.il[j]};
}
template <int kR>
__device__ __forceinline__ void set_re(Amps<kR>& s, int j, df v) {
  s.rh[j] = v.hi;
  s.rl[j] = v.lo;
}
template <int kR>
__device__ __forceinline__ void set_im(Amps<kR>& s, int j, df v) {
  s.ih[j] = v.hi;
  s.il[j] = v.lo;
}

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

// Move one plane between global memory and registers in IO layout L
// (registers 0-1 = local bits 0-1, lanes = local bits 2-6): float4 v of a
// thread is at ``start`` | the offsets of the register bits set in v.
template <int kR, bool kStore>
__device__ __forceinline__ void move_plane(float* plane, float (&a)[1 << kR],
                                           const uint64_t (&roff)[kR],
                                           uint64_t start) {
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

// Every plane of the tile between global memory and registers in IO layout
// L, tile base `base`.
template <int kR, bool kComplex, bool kStore>
__device__ __forceinline__ void move_tile(float* rh, float* rl, float* ih,
                                          float* il, Amps<kR>& s,
                                          const PassParams& p, int L,
                                          int tid, uint64_t base) {
  uint64_t roff[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    roff[k] = k < 2 ? 0 : uint64_t(1) << p.lbits[p.layouts[L][k]];
  }
  const uint64_t start = base | thread_offset<kR>(p, L, tid);
  move_plane<kR, kStore>(rh, s.rh, roff, start);
  move_plane<kR, kStore>(rl, s.rl, roff, start);
  if constexpr (kComplex) {
    move_plane<kR, kStore>(ih, s.ih, roff, start);
    move_plane<kR, kStore>(il, s.il, roff, start);
  }
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

// Every plane from layout `from` to layout `to` through shared memory
// (plane k at word k * 2^T): all writes, one barrier, all reads.
template <int kR, bool kComplex>
__device__ __forceinline__ void exchange(Amps<kR>& s, float* smem,
                                         int plane_words,
                                         const Words<kR>& from,
                                         const Words<kR>& to) {
  __syncthreads();  // the previous exchange's reads are done
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) {
    const int w = word_of(from, j);
    smem[w] = s.rh[j];
    smem[plane_words + w] = s.rl[j];
    if constexpr (kComplex) {
      smem[2 * plane_words + w] = s.ih[j];
      smem[3 * plane_words + w] = s.il[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) {
    const int w = word_of(to, j);
    s.rh[j] = smem[w];
    s.rl[j] = smem[plane_words + w];
    if constexpr (kComplex) {
      s.ih[j] = smem[2 * plane_words + w];
      s.il[j] = smem[3 * plane_words + w];
    }
  }
}

// ---- gates ------------------------------------------------------------

// U, CNOT or CU on register bit kT; with kMasked, only where the register
// control mask cmask is set.
template <int kR, int kT, bool kComplex, bool kMasked>
__device__ __forceinline__ void pair_op(Amps<kR>& s, const Op& op,
                                        int cmask) {
  constexpr int kHalf = 1 << (kR - 1);
  constexpr int tbit = 1 << kT;
  if (op.kind == kCNOT) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int i0 = ((i >> kT) << (kT + 1)) | (i & (tbit - 1));
      const int i1 = i0 | tbit;
      const bool on = !kMasked || (i0 & cmask) != 0;
      const df x0 = re(s, i0), x1 = re(s, i1);
      set_re(s, i0, pick(on, x1, x0));
      set_re(s, i1, pick(on, x0, x1));
      if constexpr (kComplex) {
        const df y0 = im(s, i0), y1 = im(s, i1);
        set_im(s, i0, pick(on, y1, y0));
        set_im(s, i1, pick(on, y0, y1));
      }
    }
    return;
  }
  const df a00 = coef(op, 0, 0), a01 = coef(op, 1, 0);
  const df a10 = coef(op, 2, 0), a11 = coef(op, 3, 0);
  if (!kComplex || op.real) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int i0 = ((i >> kT) << (kT + 1)) | (i & (tbit - 1));
      const int i1 = i0 | tbit;
      const bool on = !kMasked || (i0 & cmask) != 0;
      const df x0 = re(s, i0), x1 = re(s, i1);
      const df y0 = df_add(df_mul(a00, x0), df_mul(a01, x1));
      const df y1 = df_add(df_mul(a10, x0), df_mul(a11, x1));
      set_re(s, i0, pick(on, y0, x0));
      set_re(s, i1, pick(on, y1, x1));
      if constexpr (kComplex) {
        const df u0 = im(s, i0), u1 = im(s, i1);
        const df v0 = df_add(df_mul(a00, u0), df_mul(a01, u1));
        const df v1 = df_add(df_mul(a10, u0), df_mul(a11, u1));
        set_im(s, i0, pick(on, v0, u0));
        set_im(s, i1, pick(on, v1, u1));
      }
    }
    return;
  }
  if constexpr (kComplex) {
    const df b00 = coef(op, 0, 1), b01 = coef(op, 1, 1);
    const df b10 = coef(op, 2, 1), b11 = coef(op, 3, 1);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int i0 = ((i >> kT) << (kT + 1)) | (i & (tbit - 1));
      const int i1 = i0 | tbit;
      const bool on = !kMasked || (i0 & cmask) != 0;
      const df x0r = re(s, i0), x0i = im(s, i0);
      const df x1r = re(s, i1), x1i = im(s, i1);
      const df y0r = df_add(cmul_re(a00, b00, x0r, x0i),
                            cmul_re(a01, b01, x1r, x1i));
      const df y0i = df_add(cmul_im(a00, b00, x0r, x0i),
                            cmul_im(a01, b01, x1r, x1i));
      const df y1r = df_add(cmul_re(a10, b10, x0r, x0i),
                            cmul_re(a11, b11, x1r, x1i));
      const df y1i = df_add(cmul_im(a10, b10, x0r, x0i),
                            cmul_im(a11, b11, x1r, x1i));
      set_re(s, i0, pick(on, y0r, x0r));
      set_im(s, i0, pick(on, y0i, x0i));
      set_re(s, i1, pick(on, y1r, x1r));
      set_im(s, i1, pick(on, y1i, x1i));
    }
  }
}

template <int kR, int kT, bool kComplex>
__device__ __forceinline__ void pair_dispatch(Amps<kR>& s, const Op& op,
                                              int cmask) {
  if (cmask) {
    pair_op<kR, kT, kComplex, true>(s, op, cmask);
  } else {
    pair_op<kR, kT, kComplex, false>(s, op, 0);
  }
}

// The pair gate on the runtime register bit op.t, as a compile-time one.
template <int kR, bool kComplex>
__device__ __forceinline__ void pair_switch(Amps<kR>& s, const Op& op,
                                            int cmask) {
  static_assert(kR >= 4 && kR <= 5, "one case per register bit");
  switch (op.t) {
    case 0: pair_dispatch<kR, 0, kComplex>(s, op, cmask); break;
    case 1: pair_dispatch<kR, 1, kComplex>(s, op, cmask); break;
    case 2: pair_dispatch<kR, 2, kComplex>(s, op, cmask); break;
    case 3: pair_dispatch<kR, 3, kComplex>(s, op, cmask); break;
    default:
      if constexpr (kR > 4) pair_dispatch<kR, 4, kComplex>(s, op, cmask);
      break;
  }
}

// Multiply register j by factor (dr, di) (di unused unless kCplx).
template <int kR, bool kComplex, bool kCplx>
__device__ __forceinline__ void scale(Amps<kR>& s, int j, df dr, df di) {
  const df xr = re(s, j);
  if constexpr (!kComplex) {
    set_re(s, j, df_mul(xr, dr));
  } else {
    const df xi = im(s, j);
    if constexpr (kCplx) {
      set_re(s, j, cmul_re(dr, di, xr, xi));
      set_im(s, j, cmul_im(dr, di, xr, xi));
    } else {
      set_re(s, j, df_mul(xr, dr));
      set_im(s, j, df_mul(xi, dr));
    }
  }
}

// D2 with the sources' four entries e[bit_a(j)][bit_b(j)] of a register
// mask pair (ma, mb); one entry for every register when both are 0.
template <int kR, bool kComplex, bool kCplx>
__device__ __forceinline__ void diag_regs(Amps<kR>& s, const Op& op,
                                          const int (&e)[4], int ma, int mb) {
  if ((ma | mb) == 0) {
    const df dr = coef(op, e[0], 0);
    const df di = kCplx ? coef(op, e[0], 1) : dr;
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) {
      scale<kR, kComplex, kCplx>(s, j, dr, di);
    }
    return;
  }
  df r[4], q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = coef(op, e[k], 0);
    q[k] = kCplx ? coef(op, e[k], 1) : r[k];
  }
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) {
    const bool x = (j & ma) != 0, y = (j & mb) != 0;
    const df dr = pick(x, pick(y, r[3], r[2]), pick(y, r[1], r[0]));
    const df di = kCplx
        ? pick(x, pick(y, q[3], q[2]), pick(y, q[1], q[0])) : dr;
    scale<kR, kComplex, kCplx>(s, j, dr, di);
  }
}

// D2: multiply register j by entry (bit_a(j), bit_b(j)).
template <int kR, bool kComplex>
__device__ __forceinline__ void diag_op(Amps<kR>& s, const Op& op, int tid,
                                        uint64_t base) {
  const int ua = src_uniform(op.a, tid, base);
  const int ub = src_uniform(op.b, tid, base);
  const int ma = src_mask(op.a), mb = src_mask(op.b);
  const int ha = ua | (ma != 0), hb = ub | (mb != 0);
  // entries of (register bit a, register bit b) = 00, 01, 10, 11
  const int e[4] = {(ua << 1) | ub, (ua << 1) | hb, (ha << 1) | ub,
                    (ha << 1) | hb};
  if (kComplex && !op.real) {
    diag_regs<kR, kComplex, true>(s, op, e, ma, mb);
  } else {
    diag_regs<kR, kComplex, false>(s, op, e, ma, mb);
  }
}

// Apply the launch's records to one tile in registers; returns the layout
// in force at the end.
template <int kR, bool kComplex>
__device__ __forceinline__ int apply_ops(Amps<kR>& s, float* smem,
                                         const PassParams& p, int tid,
                                         uint64_t base) {
  const int plane_words = 1 << p.tile_bits;
  int cur = 0;
  for (int k = 0; k < p.num_ops; ++k) {
    const Op& op = p.ops[k];
    const int kind = op.kind;
    if (kind == kSwap) {
      const unsigned char* g = reinterpret_cast<const unsigned char*>(op.m);
      const Words<kR> from = layout_words<kR>(p, cur, tid, g);
      const Words<kR> to = layout_words<kR>(p, op.t, tid, g);
      exchange<kR, kComplex>(s, smem, plane_words, from, to);
      cur = op.t;
      continue;
    }
    if (kind == kD2) {
      diag_op<kR, kComplex>(s, op, tid, base);
      continue;
    }
    int cmask = 0;
    if (kind != kU) {
      cmask = src_mask(op.a);
      if (cmask == 0 && !src_uniform(op.a, tid, base)) continue;
    }
    pair_switch<kR, kComplex>(s, op, cmask);
  }
  return cur;
}

// kR register bits per thread; launch bounds of kThreads threads and
// kBlocks resident blocks per SM. Block b owns tile b.
template <bool kComplex, int kR, int kThreads, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fused_pass_df64_kernel(float* __restrict__ rh, float* __restrict__ rl,
                       float* __restrict__ ih, float* __restrict__ il,
                       const __grid_constant__ PassParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const uint64_t base = tile_base(p, blockIdx.x);
  Amps<kR> s;
  move_tile<kR, kComplex, false>(rh, rl, ih, il, s, p, 0, tid, base);
  const int cur = apply_ops<kR, kComplex>(s, smem, p, tid, base);
  move_tile<kR, kComplex, true>(rh, rl, ih, il, s, p, cur, tid, base);
}

template <bool kComplex, int kR, int kThreads, int kBlocks>
cudaError_t launch_pass(float* rh, float* rl, float* ih, float* il,
                        const PassParams& p, cudaStream_t stream) {
  auto kernel = fused_pass_df64_kernel<kComplex, kR, kThreads, kBlocks>;
  bool exchanges = false;
  for (int k = 0; k < p.num_ops; ++k) exchanges |= p.ops[k].kind == kSwap;
  const size_t smem = exchanges
      ? (size_t(1) << p.tile_bits) * sizeof(float) * (kComplex ? 4 : 2) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks = 1u << (p.n - p.tile_bits);
  const int threads = 1 << (p.tile_bits - kR);
  kernel<<<blocks, threads, smem, stream>>>(rh, rl, ih, il, p);
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

bool valid_params(const PassParams& p, bool complex_carry) {
  const int t = p.tile_bits;
  if (t < kMinTileBits || t > kMaxTileBits || p.n < t || p.n - t > 30 ||
      p.w < 1 || p.w > t || p.num_ops < 0 || p.num_ops > kMaxOps ||
      p.reg_bits != (complex_carry ? kComplexRegBits : kRealRegBits) ||
      t - p.reg_bits < kLaneBits ||
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

}  // namespace

// rh, rl (and ih, il): flat (2^n,) float32 hi/lo planes on the device,
// 16-byte aligned; ih == il == nullptr selects the real carry (every gate
// real). params: a host PassParams (ops/fused_df64.py packs it), passed to
// the kernel by value. Returns a cudaError_t.
extern "C" int rocq_fused_pass_df64(float* rh, float* rl, float* ih,
                                    float* il, const void* params,
                                    void* stream) {
  const PassParams& p = *static_cast<const PassParams*>(params);
  const bool complex_carry = ih != nullptr;
  if (rh == nullptr || rl == nullptr || (il != nullptr) != complex_carry ||
      !valid_params(p, complex_carry)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      complex_carry
          ? launch_pass<true, kComplexRegBits, 512, 1>(rh, rl, ih, il, p, s)
          : launch_pass<false, kRealRegBits, 256, kRealMinBlocks>(
                rh, rl, ih, il, p, s);
  return static_cast<int>(err);
}
