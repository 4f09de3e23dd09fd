// Shared helpers for the FPTC decode kernels (sm_90a, plain C interface).
//
// Every exported launcher takes raw device pointers and the CUDA stream as
// void*, sizes as int64_t, launches on that stream, allocates nothing, and
// returns cudaGetLastError() as an int (0 = success); the Python wrappers in
// repro_torch/kernels raise on anything else.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FPTC_EXPORT extern "C" __attribute__((visibility("default")))

// Return the launch error (if any) of the kernel just launched.
#define FPTC_CHECK_LAUNCH()                       \
  do {                                            \
    cudaError_t fptc_err_ = cudaGetLastError();   \
    if (fptc_err_ != cudaSuccess) {               \
      return static_cast<int>(fptc_err_);         \
    }                                             \
  } while (0)

namespace fptc {

constexpr int kWarp = 32;

// Exclusive scan of one int32 per thread across a block of up to 1024
// threads (a multiple of 32).  `warp_sums` is shared scratch of 32 ints.
// Returns the thread's exclusive prefix; `*total` receives the block sum.
// Starts and ends with a barrier, so it may be called in a loop.
__device__ __forceinline__ int32_t block_exclusive_scan(
    int32_t v, int32_t* warp_sums, int32_t* total) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int num_warps = blockDim.x / kWarp;
  int32_t x = v;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();  // warp_sums may still be read by a previous call
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t s = lane < num_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[num_warps - 1];
  const int32_t base = warp > 0 ? warp_sums[warp - 1] : 0;
  __syncthreads();
  return base + x - v;
}

}  // namespace fptc
