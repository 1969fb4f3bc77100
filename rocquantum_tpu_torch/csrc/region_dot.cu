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
// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), which leaves an
// error of about 2^-22 |v|, and each product is summed as
// hi*hi' + (lo*hi' + hi*lo'), dropping lo*lo'. mma.sync m16n8k8 TF32 does
// the products. The tensor cores truncate when they add to an accumulator,
// which biases a long running sum towards zero, so the big and the small
// products go to separate accumulators that start from zero for a few
// k-steps and are joined, and summed over the k-steps, by rounded float32
// adds.
//
// Lane dot design. The plane is a (rows, 128) matrix X and y = X m. Each
// block keeps m's hi and lo splits in shared memory in mma fragment order
// (128 KiB, above the 48 KiB default, so the launch raises the limit), runs
// persistently over tiles of 64 rows (32 KiB) and double-buffers them with
// cp.async, so the next tile loads while this one multiplies. 16 warps,
// each a 16-row x 32-column corner of the tile: 4 n-tiles x 16 k-steps x
// 3 products. Shared rows are padded to 132 floats so the A fragment reads
// hit 32 distinct banks. A block reads all of its tile before it writes
// it, and blocks own disjoint tiles, so in place is safe.
//
// Row dot design. Columns are independent, so a block takes a 32-row x
// 128-column slab (16 KiB, rows padded to 136 floats for conflict-free B
// fragment reads) of one 32-row tile; 4 warps, each 16 rows of the output
// by 64 columns; the split of a stays in registers (32 per thread).
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---- lane dot -------------------------------------------------------------

constexpr int kK = 128;              // the matrix is kK x kK
constexpr int kLaneThreads = 512;    // 16 warps
constexpr int kTileRows = 64;        // X rows per tile
constexpr int kXStride = kK + 4;     // padded shared row
constexpr int kKSteps = kK / 8;      // 16
constexpr int kNTiles = kK / 8;      // 16
constexpr size_t kFragBytes = size_t(kKSteps) * kNTiles * 32 * sizeof(uint4);
constexpr size_t kLaneSmem =
    kFragBytes + 2 * size_t(kTileRows) * kXStride * sizeof(float);

__global__ void __launch_bounds__(kLaneThreads, 1)
lane_dot_kernel(float* __restrict__ x, const float* __restrict__ m,
                long long ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* frag = reinterpret_cast<uint4*>(smem_raw);  // [ks][nt][lane]
  float* xs = reinterpret_cast<float*>(smem_raw + kFragBytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  auto load_tile = [&](long long tile, int buf) {
    const float* src = x + tile * kTileRows * kK;
    float* dst = xs + buf * kTileRows * kXStride;
    for (int i = threadIdx.x; i < kTileRows * (kK / 4); i += kLaneThreads) {
      const int r = i / (kK / 4);
      const int c = (i % (kK / 4)) * 4;
      cp_async16(dst + r * kXStride + c, src + r * kK + c);
    }
  };

  long long tile = blockIdx.x;
  if (tile < ntiles) load_tile(tile, 0);
  cp_async_commit();

  // m's B fragments, hi and lo, while the first tile is in flight
  for (int i = threadIdx.x; i < kKSteps * kNTiles * 32; i += kLaneThreads) {
    const int l = i & 31;
    const int nt = (i >> 5) % kNTiles;
    const int ks = (i >> 5) / kNTiles;
    const int n = nt * 8 + (l >> 2);
    const int k = ks * 8 + (l & 3);
    uint4 f;
    split_tf32(m[k * kK + n], f.x, f.z);
    split_tf32(m[(k + 4) * kK + n], f.y, f.w);
    frag[i] = f;
  }

  const int row0 = (warp >> 2) * 16;  // this warp's 16 rows of the tile
  const int nt0 = (warp & 3) * 4;     // and its 4 n-tiles (32 columns)

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < ntiles) load_tile(next, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this tile is here
    __syncthreads();

    const float* xt = xs + (it & 1) * kTileRows * kXStride;
    float acc[4][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t ah[4], al[4];
      const float* p = xt + (row0 + g) * kXStride + ks * 8 + t;
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * kXStride], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * kXStride + 4], ah[3], al[3]);
      uint4 b[4];  // {hi b0, hi b1, lo b0, lo b1} of 4 n-tiles
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = frag[(ks * kNTiles + nt0 + j) * 32 + lane];
      }
      // this k-step's 8-term sums start from zero on the tensor cores and
      // join acc by a rounded float32 add: the tensor cores truncate when
      // they accumulate, which would bias a 128-term running sum
      float small[4][4], big[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32_from_zero(small[j], al, b[j].x, b[j].y);
        mma_tf32_from_zero(big[j], ah, b[j].x, b[j].y);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(small[j], ah, b[j].z, b[j].w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += big[j][e] + small[j][e];
        }
      }
    }

    float* out = x + tile * kTileRows * kK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + g;
      const int c = (nt0 + j) * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + r * kK + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * kK + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();
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
// of 32. m: (128, 128) float32 on the device, row-major. Returns a
// cudaError_t.
extern "C" int rocq_lane_dot(float* x, const float* m, long long rows,
                             void* stream) {
  if (rows < 32 || rows % 32 != 0 || misaligned(x) || misaligned(m)) {
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
                    kLaneSmem, static_cast<cudaStream_t>(stream)>>>(x, m,
                                                                    ntiles);
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
