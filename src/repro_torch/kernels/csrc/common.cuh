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

// Exclusive scan of one value per thread across a block of up to 1024
// threads (a multiple of 32) under an associative operator `op` with
// identity `identity`: a warp shuffle scan, then a scan of the warp
// aggregates by warp 0.  `warp_aggs` is shared scratch of 32 values.
// Returns the thread's exclusive prefix (op of every earlier thread's value,
// in thread order); `*total` receives the block's aggregate.  Starts and ends
// with a barrier, so it may be called in a loop.
template <typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, Op op, T identity,
                                                  T* warp_aggs, T* total) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int num_warps = blockDim.x / kWarp;
  T x = v;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(y, x);
  }
  T ex = __shfl_up_sync(0xffffffffu, x, 1);  // exclusive within the warp
  if (lane == 0) ex = identity;
  __syncthreads();  // warp_aggs may still be read by a previous call
  if (lane == kWarp - 1) warp_aggs[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < num_warps ? warp_aggs[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s = op(y, s);
    }
    warp_aggs[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_aggs[num_warps - 1];
  const T base = warp > 0 ? op(warp_aggs[warp - 1], ex) : ex;
  __syncthreads();
  return base;
}

struct Plus {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return a + b; }
};

// The int32 sum scan (K1's offsets).
__device__ __forceinline__ int32_t block_exclusive_scan(
    int32_t v, int32_t* warp_sums, int32_t* total) {
  return block_exclusive_scan(v, Plus{}, 0, warp_sums, total);
}

}  // namespace fptc
