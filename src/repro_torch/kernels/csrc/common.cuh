// Shared helpers for the FPTC decode kernels (sm_90a, plain C interface).
//
// Every exported launcher takes raw device pointers and the CUDA stream as
// void*, sizes as int64_t, launches on that stream, allocates nothing, and
// returns cudaGetLastError() as an int (0 = success); the Python wrappers in
// repro_torch/kernels raise on anything else.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

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

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// cp.async of 16 bytes (cached in L2 only) or 4 bytes: `bytes` of them are
// read from `src` and the rest of the unit is zero-filled, so a copy that
// ends early reads nothing past its end.  The caller commits the group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait for all but the newest committed group.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Item `it` (from `start`, `stride` apart: by default threadIdx.x and
// blockDim.x) of a [rows][per] loop as (row r, column j), stepped without
// a division.
struct Walk {
  int r, j, dr, dj, per;
  __device__ __forceinline__ explicit Walk(int per_)
      : Walk(per_, threadIdx.x, blockDim.x) {}
  __device__ __forceinline__ Walk(int per_, int start, int stride)
      : per(per_) {
    r = start / per;
    j = start - r * per;
    dr = stride / per;
    dj = stride - dr * per;
  }
  __device__ __forceinline__ void step() {
    r += dr;
    j += dj;
    if (j >= per) {
      j -= per;
      ++r;
    }
  }
};

// A thread's RW x 4 register tile of fp32 FMA chains, the DCT's and the
// iDCT's: acc[i][c] = the chain over j < n of x[i * wstride + j] * b[j * bs
// + c], j ascending from 0.0f (x: the thread's first row of operands, rows
// wstride floats apart; b: its first output column, rows bs floats apart;
// both 16-byte aligned, wstride and bs multiples of 4).  Per 4 j-steps it
// reads 4 float4 rows of b and RW float4s of x and issues 16 RW FMAs; the
// float4 reads change where the operands come from, never the chain's order.
template <int RW>
__device__ __forceinline__ void fma_tile(const float* __restrict__ x,
                                         int wstride,
                                         const float* __restrict__ b, int bs,
                                         int n, float (&acc)[RW][4]) {
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }
  int j = 0;
#pragma unroll 2
  for (; j + 4 <= n; j += 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(b + j * bs);
    const float4 b1 = *reinterpret_cast<const float4*>(b + (j + 1) * bs);
    const float4 b2 = *reinterpret_cast<const float4*>(b + (j + 2) * bs);
    const float4 b3 = *reinterpret_cast<const float4*>(b + (j + 3) * bs);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(x + i * wstride + j);
      acc[i][0] = fmaf(v.x, b0.x, acc[i][0]);
      acc[i][1] = fmaf(v.x, b0.y, acc[i][1]);
      acc[i][2] = fmaf(v.x, b0.z, acc[i][2]);
      acc[i][3] = fmaf(v.x, b0.w, acc[i][3]);
      acc[i][0] = fmaf(v.y, b1.x, acc[i][0]);
      acc[i][1] = fmaf(v.y, b1.y, acc[i][1]);
      acc[i][2] = fmaf(v.y, b1.z, acc[i][2]);
      acc[i][3] = fmaf(v.y, b1.w, acc[i][3]);
      acc[i][0] = fmaf(v.z, b2.x, acc[i][0]);
      acc[i][1] = fmaf(v.z, b2.y, acc[i][1]);
      acc[i][2] = fmaf(v.z, b2.z, acc[i][2]);
      acc[i][3] = fmaf(v.z, b2.w, acc[i][3]);
      acc[i][0] = fmaf(v.w, b3.x, acc[i][0]);
      acc[i][1] = fmaf(v.w, b3.y, acc[i][1]);
      acc[i][2] = fmaf(v.w, b3.z, acc[i][2]);
      acc[i][3] = fmaf(v.w, b3.w, acc[i][3]);
    }
  }
  for (; j < n; ++j) {  // n % 4 tail
    const float4 bj = *reinterpret_cast<const float4*>(b + j * bs);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float v = x[i * wstride + j];
      acc[i][0] = fmaf(v, bj.x, acc[i][0]);
      acc[i][1] = fmaf(v, bj.y, acc[i][1]);
      acc[i][2] = fmaf(v, bj.z, acc[i][2]);
      acc[i][3] = fmaf(v, bj.w, acc[i][3]);
    }
  }
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device
// where that is more than the default 48 KiB: its limit is raised to the
// device's opt-in maximum less the kernel's static shared memory, once per
// (device, kernel), so launches of one kernel at several shapes all fit.
// Keyed by the kernel: a process that loads two builds of a library shares
// this function's static state between them.  Returns the error, if any.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int room = max_smem - static_cast<int>(attr.sharedSizeBytes);
  if (bytes > static_cast<size_t>(room)) return cudaErrorInvalidValue;
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(device, kernel);
  if (done.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
  if (err == cudaSuccess) done.insert(key);
  return err;
}

// CTAs of `kernel` (`threads` threads, `smem` bytes) the current device
// holds at once: its SMs times the CTAs an SM holds.
inline cudaError_t resident_ctas(const void* kernel, int threads, size_t smem,
                                 int64_t* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *out = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// resident_ctas for a kernel that needs nothing but `smem` bytes sized per
// launch: computed once per (device, kernel, threads, smem), after raising
// the kernel's shared-memory limit where it needs more than 48 KiB.  Keyed
// by the kernel, since a process that loads two builds of a library shares
// this function's static state between them.
inline cudaError_t cached_resident_ctas(const void* kernel, int threads,
                                        size_t smem, int64_t* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int64_t> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, kernel, threads, smem);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = resident_ctas(kernel, threads, smem, out);
  if (err != cudaSuccess) return err;
  cache.emplace(key, *out);
  return cudaSuccess;
}

}  // namespace fptc
