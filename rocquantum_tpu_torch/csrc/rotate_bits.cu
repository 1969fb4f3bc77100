// Index-bit rotation copy for Hopper (sm_90a).
//
// What it replaces. rocquantum_tpu/ops/relabel.py:91 _rotate_bits_down_pallas
// (called through rotate_region, :139): an out-of-place copy of a float32
// plane of 2^n amplitudes that rotates the index bits [7, n) DOWN by
// `shift`: the bit at position 7 + j moves to 7 + ((j - shift) mod (n - 7)).
// Bits [0, 7) stay put. The TPU kernel puts the rotation in its block index
// maps and needs n >= 17 and shift <= n - 17 (a Mosaic tile rule); its XLA
// twin rotate_bits_down (:66) covers the other shifts and leading batch
// dimensions. This kernel computes the whole function: every shift in
// [1, n - 7) and any number of planes laid end to end.
//
// Design. The 2^7 = 128 floats of bits [0, 7) form a run of 512 contiguous
// bytes in both the input and the output. Output run o (its index over bits
// [7, n)) is input run rotl_{n-7}(o, shift): the bit j of o came from input
// bit (j + shift) mod (n - 7). One warp copies one run, each thread one
// 16-byte load and one 16-byte store, so every warp access is 512 contiguous
// bytes. Warps walk the runs grid-stride; indices are 64-bit.
//
// What bounds it. The bytes: each input float read once and each output
// float written once, 2 * 4 * 2^n bytes a plane (1.28 ms for n = 29 at
// 3.35 TB/s). It does no arithmetic.
//
// C interface (ctypes): rocq_rotate_bits_down(...) returns a cudaError_t as
// int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLowBits = 7;       // bits that never move: one 128-float run
constexpr int kThreads = 256;     // 8 warps, 8 runs in flight per block
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rotate_bits_down_kernel(const float4* __restrict__ in,
                        float4* __restrict__ out, uint64_t total_runs,
                        int size, int shift) {
  const uint64_t run_mask = (uint64_t(1) << size) - 1;
  const int lane = threadIdx.x & 31;
  const uint64_t warp = uint64_t(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const uint64_t warps = uint64_t(gridDim.x) * kWarpsPerBlock;
  for (uint64_t run = warp; run < total_runs; run += warps) {
    const uint64_t plane = run & ~run_mask;  // batch offset, in runs
    const uint64_t o = run & run_mask;
    const uint64_t src =
        plane | (((o << shift) | (o >> (size - shift))) & run_mask);
    // a run is 32 float4: lane l moves floats [4 l, 4 l + 4)
    out[(run << (kLowBits - 2)) + lane] = in[(src << (kLowBits - 2)) + lane];
  }
}

}  // namespace

// in, out: device arrays of `batch` planes of 2^n float32 each, contiguous,
// 16-byte aligned, not overlapping. shift in [1, n - 7). Returns a
// cudaError_t.
extern "C" int rocq_rotate_bits_down(const float* in, float* out,
                                     long long batch, int n, int shift,
                                     void* stream) {
  const int size = n - kLowBits;
  if (batch < 1 || size < 2 || size > 50 || shift < 1 || shift >= size ||
      (reinterpret_cast<uintptr_t>(in) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t total_runs = static_cast<uint64_t>(batch) << size;
  // enough warps to keep every SM's memory pipe full; the rest grid-stride
  const uint64_t want = (total_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned int blocks =
      static_cast<unsigned int>(want < (1u << 20) ? want : (1u << 20));
  rotate_bits_down_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      total_runs, size, shift);
  return static_cast<int>(cudaGetLastError());
}
