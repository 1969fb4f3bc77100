// Tensor-core probe for Hopper (sm_90a): dense real matrices on low index
// bits of a float32 plane, at float32 accuracy, on the tensor cores.
//
// What it replaces. The two MXU feasibility probes of the JAX package
// (.scratch/tpu_mxu_probe.py), each a pallas_call over a plane viewed as
// (R, 4096) float32 rows, in place, at Precision.HIGHEST:
//   lane dot (:27)  y[r, 128 k + j] = sum_i x[r, 128 k + i] m[i, j]
//                   a 128x128 matrix m on index bits 0-6;
//   row dot  (:55)  y[32 t + i, c] = sum_k a[i, k] x[32 t + k, c]
//                   a 32x32 matrix a on row bits 0-4 (index bits 12-16).
// The question they answer here: can composed gate matrices run on the
// tensor cores at float32 accuracy, at the speed of the bytes?
//
// Arithmetic: 3xTF32. TF32 keeps 10 mantissa bits. Each operand is split
// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi) (rounded to nearest,
// cvt.rna), which leaves an error of about 2^-22 |v|, and each product is
// summed as hi*hi' + (lo*hi' + hi*lo'), dropping lo*lo'. The tensor cores
// truncate when they add to an accumulator, which biases a long running
// sum towards zero, so the big products start from zero every few k-steps
// and are joined by rounded float32 adds; the small ones (2^-11 of the big)
// may chain.
//
// Lane dot design (wgmma). The plane is a (rows, 128) matrix X and y = X m,
// cut into tiles of 64 rows (32 KiB, contiguous). One persistent block an
// SM, three warpgroups:
// - a producer warp copies m's B operand image (the wrapper's
//   region_dot.lane_operands: hi and lo tf32 splits, K-major, in the
//   128-byte swizzled layout a wgmma descriptor names, 64 KiB each) into
//   shared memory once, then keeps a ring of three X tiles filled with
//   1-D cp.async.bulk copies completing on mbarriers;
// - two consumer warpgroups take alternate tiles. Each thread reads its A
//   fragments (rows g, g + 8 of its warp's 16) from the staged tile as
//   16-byte loads, splits them once in registers and issues, per k-step of
//   8, three wgmma.mma_async m64n128k8 tf32: hi*B_hi (from zero every
//   k-step, joined into a float32 sum), hi*B_lo and lo*B_hi (chained).
//   The K order is permuted (the same permutation is packed
//   into B) so that one float4 holds a thread's A values of two k-steps,
//   and odd rows read their two chunks in the other order, so the reads of
//   a quarter-warp hit 32 distinct banks. A tile's stage is released
//   after its last k-step; the results go to global memory as float2
//   straight from the accumulators.
// Registers: accumulators 3 x 64 floats a consumer thread, so setmaxnreg
// gives the consumers 232 and the producer warpgroup 40. Shared memory:
// 128 KiB of B + 3 x 32 KiB of tiles + barriers (above the 48 KiB default,
// so the launch raises the limit). A tile is read whole into shared memory
// before any of its rows is written, and blocks own disjoint tiles, so in
// place is safe.
//
// Row dot design. Columns are independent, so a block takes a 32-row x
// 128-column slab (16 KiB, rows padded to 136 floats for conflict-free B
// fragment reads) of one 32-row tile; 4 warps, each 16 rows of the output
// by 64 columns; the split of a stays in registers (32 per thread);
// mma.sync m16n8k8 does the products.
//
// What bounds them (n = 29, R = 2^17, one 2 GiB plane): both read and write
// the plane once, 4.3 GB = 1.28 ms at 3.35 TB/s. The lane dot does
// 2 * 2^29 * 128 = 1.37e11 FLOP of the function, 4.1e11 as three TF32
// products: 0.83 ms at the 495 TFLOP/s TF32 peak, so the bytes bound it;
// on the FP32 cores the same function would take 2.05 ms at 67 TFLOP/s.
// The row dot does 3.4e10 FLOP and is bound by the bytes.
//
// C interface (ctypes): rocq_lane_dot(...), rocq_row_dot(...) return a
// cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4096;  // floats in a probe row (index bits 0-11)

// ---- TF32 helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo up to ~2^-22 |v|; v - hi is exact in float32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile. Fragments (g = lane / 4, t = lane % 4):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k = t, n = g), b1 (k = t + 4, n = g);
// d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, 2t, 2t + 1).
// Not volatile: the compiler may interleave independent products, which a
// chain of dependent mma.sync in program order would serialize.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (a zero accumulator in)
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

// ---- mbarriers, bulk copies, wgmma ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, `bytes` (a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzled layout: 8-row groups 1024 bytes apart (SBO), LBO unused
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t(1) << 62) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 16) | uint64_t((addr >> 4) & 0x3FFF);
}

// keep the compiler from moving register reads across wgmma waits
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b: m64n128k8, A (tf32 bit patterns) from registers, B from
// shared memory; d starts from zero when `accumulate` is 0.
// d[i] is row 16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t +
// (i & 1); a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ---- lane dot -------------------------------------------------------------

constexpr int kK = 128;                  // the matrix is kK x kK
constexpr int kKSteps = kK / 8;          // 16 wgmma k-steps
constexpr int kTileRows = 64;            // X rows of kK floats per tile
constexpr uint32_t kTileBytes = kTileRows * kK * 4;  // 32 KiB
constexpr int kStages = 3;
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kLaneThreads = (kConsumers + 1) * 128;
constexpr uint32_t kBBytes = kK * kK * 4;  // one split of m (64 KiB)
constexpr size_t kLaneSmem =
    1024 + 2 * size_t(kBBytes) + kStages * size_t(kTileBytes) + 64;
static_assert(kLaneSmem <= 232448, "fits one SM's shared memory");

__global__ void __launch_bounds__(kLaneThreads, 1)
lane_dot_kernel(float* __restrict__ x, const float* __restrict__ b_image,
                long long ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is on absolute address bits: B starts 1024-aligned
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* b_hi = smem;
  unsigned char* b_lo = smem + kBBytes;
  float* tiles = reinterpret_cast<float*>(smem + 2 * kBBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + 2 * kBBytes + kStages * kTileBytes);
  uint64_t* b_bar = bars;           // B image arrived
  uint64_t* full = bars + 1;        // [kStages]: a tile arrived
  uint64_t* empty = full + kStages; // [kStages]: a tile's A values read

  if (threadIdx.x == 0) {
    mbar_init(b_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(b_bar, 2 * kBBytes);
      bulk_load(b_hi, b_image, 2 * kBBytes, b_bar);
      int i = 0;
      for (long long tile = blockIdx.x; tile < ntiles;
           tile += gridDim.x, ++i) {
        const int stage = i % kStages;
        if (i >= kStages) mbar_wait(&empty[stage], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[stage], kTileBytes);
        bulk_load(tiles + stage * (kTileBytes / 4), x + tile * kTileRows * kK,
                  kTileBytes, &full[stage]);
      }
    }
  } else {
    // ---- consumer warpgroups: alternate tiles of this block ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int odd = g & 1;
    const uint32_t hi_addr = smem_addr(b_hi);
    const uint32_t lo_addr = smem_addr(b_lo);
    mbar_wait(b_bar, 0);

    int i = wg;
    for (long long tile = blockIdx.x + wg * (long long)gridDim.x;
         tile < ntiles; tile += kConsumers * (long long)gridDim.x,
                   i += kConsumers) {
      const int stage = i % kStages;
      mbar_wait(&full[stage], (i / kStages) & 1);
      // row g of this warp's 16, at column 4t of each 16-float chunk
      const float* xs =
          tiles + stage * (kTileBytes / 4) + (warp * 16 + g) * kK + 4 * t;

      float acc[64], big[64], small[64];
#pragma unroll
      for (int q = 0; q < kKSteps / 4; ++q) {
        // chunks 2q and 2q + 1 (k-steps 4q .. 4q + 3) of rows g and g + 8;
        // odd rows load them in the other order (distinct banks)
        float4 v[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* p = xs + r * 8 * kK + 32 * q;
          const float4 first =
              *reinterpret_cast<const float4*>(p + 16 * odd);
          const float4 second =
              *reinterpret_cast<const float4*>(p + 16 * (1 - odd));
          v[r][0] = odd ? second : first;
          v[r][1] = odd ? first : second;
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int s = 4 * q + h;
          // k-step s holds, at logical k = t and t + 4, the chunk's
          // elements 2 (s % 2) and 2 (s % 2) + 1
          const float4& c0 = v[0][h >> 1];
          const float4& c1 = v[1][h >> 1];
          uint32_t a_hi[4], a_lo[4];
          split_tf32((h & 1) ? c0.z : c0.x, a_hi[0], a_lo[0]);
          split_tf32((h & 1) ? c1.z : c1.x, a_hi[1], a_lo[1]);
          split_tf32((h & 1) ? c0.w : c0.y, a_hi[2], a_lo[2]);
          split_tf32((h & 1) ? c1.w : c1.y, a_hi[3], a_lo[3]);
          // k-step s of B: K block s / 4 (16 KiB), 32 bytes in per s % 4
          const uint32_t off = (s >> 2) * (kBBytes / 4) + (s & 3) * 32;
          wgmma_fence();
          wgmma_tf32(big, a_hi, b_desc(hi_addr + off), 0);
          wgmma_tf32(small, a_hi, b_desc(lo_addr + off), s);
          wgmma_tf32(small, a_lo, b_desc(hi_addr + off), 1);
          wgmma_commit_and_wait();
          fence_regs(big);
          fence_regs(small);
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            acc[e] = s == 0 ? big[e] : acc[e] + big[e];
          }
        }
      }

      // release the stage once every value read from it has fed a wgmma
      // (waited on): an mbarrier arrive does not wait for shared loads in
      // flight, and the producer's next bulk copy would overwrite them.
      // The fence orders these generic-proxy reads before that copy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&empty[stage]);

      float* out = x + (tile * kTileRows + warp * 16 + g) * kK + 2 * t;
#pragma unroll
      for (int e = 0; e < 64; e += 4) {
        const int col = 8 * (e >> 2);
        *reinterpret_cast<float2*>(out + col) =
            make_float2(acc[e] + small[e], acc[e + 1] + small[e + 1]);
        *reinterpret_cast<float2*>(out + 8 * kK + col) =
            make_float2(acc[e + 2] + small[e + 2],
                        acc[e + 3] + small[e + 3]);
      }
    }
  }
}

// ---- row dot --------------------------------------------------------------

constexpr int kT = 32;               // the matrix is kT x kT
constexpr int kRowThreads = 128;     // 4 warps
constexpr int kSlab = 128;           // columns per block
constexpr int kSStride = kSlab + 8;  // padded shared row
constexpr int kSlabsPerRow = kCols / kSlab;

__global__ void __launch_bounds__(kRowThreads)
row_dot_kernel(const float* __restrict__ a, float* __restrict__ x) {
  __shared__ __align__(16) float xs[kT * kSStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long tile = blockIdx.x / kSlabsPerRow;
  const int col0 = (blockIdx.x % kSlabsPerRow) * kSlab;
  float* base = x + tile * kT * kCols + col0;

  // the slab: 32 rows x 128 floats, 8 16-byte loads a thread, all in flight
  float4 v[kT * kSlab / 4 / kRowThreads];
#pragma unroll
  for (int j = 0; j < kT * kSlab / 4 / kRowThreads; ++j) {
    const int i = threadIdx.x + j * kRowThreads;
    v[j] = *reinterpret_cast<const float4*>(base + (i / (kSlab / 4)) * kCols +
                                            (i % (kSlab / 4)) * 4);
  }
#pragma unroll
  for (int j = 0; j < kT * kSlab / 4 / kRowThreads; ++j) {
    const int i = threadIdx.x + j * kRowThreads;
    *reinterpret_cast<float4*>(xs + (i / (kSlab / 4)) * kSStride +
                               (i % (kSlab / 4)) * 4) = v[j];
  }

  // A fragments of a (rows mt*16.., 4 k-steps), split, while loads land
  const int mt = warp & 1;
  const int n0 = (warp >> 1) * 64;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float* p = a + (mt * 16 + g) * kT + ks * 8 + t;
    split_tf32(p[0], ah[ks][0], al[ks][0]);
    split_tf32(p[8 * kT], ah[ks][1], al[ks][1]);
    split_tf32(p[4], ah[ks][2], al[ks][2]);
    split_tf32(p[8 * kT + 4], ah[ks][3], al[ks][3]);
  }
  __syncthreads();

  // per n-tile: the big products and the small ones in two accumulators
  // (4 k-steps of 8 terms), joined by one rounded float32 add at the end
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float small[4], big[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* p = xs + (ks * 8 + t) * kSStride + n0 + j * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(p[0], bh0, bl0);
      split_tf32(p[4 * kSStride], bh1, bl1);
      if (ks == 0) {
        mma_tf32_from_zero(small, al[ks], bh0, bh1);
        mma_tf32_from_zero(big, ah[ks], bh0, bh1);
      } else {
        mma_tf32(small, al[ks], bh0, bh1);
        mma_tf32(big, ah[ks], bh0, bh1);
      }
      mma_tf32(small, ah[ks], bl0, bl1);
    }
    // every global read of the slab happened before the barrier above
    const int r = mt * 16 + g;
    const int c = n0 + j * 8 + 2 * t;
    *reinterpret_cast<float2*>(base + r * kCols + c) =
        make_float2(big[0] + small[0], big[1] + small[1]);
    *reinterpret_cast<float2*>(base + (r + 8) * kCols + c) =
        make_float2(big[2] + small[2], big[3] + small[3]);
  }
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace

// x: (rows, 4096) float32 on the device, updated in place; rows a multiple
// of 32. b_image: m's B operand image on the device (2 x 128 x 128 tf32
// bit patterns, region_dot.lane_operands). Returns a cudaError_t.
extern "C" int rocq_lane_dot(float* x, const float* b_image, long long rows,
                             void* stream) {
  if (rows < 32 || rows % 32 != 0 || misaligned(x) || misaligned(b_image)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ntiles = rows * (kCols / kK) / kTileRows;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lane_dot_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kLaneSmem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = ntiles < sms ? ntiles : sms;
  lane_dot_kernel<<<static_cast<unsigned int>(blocks), kLaneThreads,
                    kLaneSmem, static_cast<cudaStream_t>(stream)>>>(
      x, b_image, ntiles);
  return static_cast<int>(cudaGetLastError());
}

// a: (32, 32) float32 on the device, row-major. x: (rows, 4096) float32 on
// the device, updated in place; rows a multiple of 32. Returns a
// cudaError_t.
extern "C" int rocq_row_dot(const float* a, float* x, long long rows,
                            void* stream) {
  if (rows < 32 || rows % 32 != 0 || misaligned(x) ||
      rows / kT * kSlabsPerRow > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks =
      static_cast<unsigned int>(rows / kT * kSlabsPerRow);
  row_dot_kernel<<<blocks, kRowThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, x);
  return static_cast<int>(cudaGetLastError());
}
