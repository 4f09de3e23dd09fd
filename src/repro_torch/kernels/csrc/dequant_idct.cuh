// The dequant + inverse-DCT kernel template shared by K2's last stage
// (LUT dequant) and K3 (inline 3-zone dequant).
//
//   out[w, j] = sum_k dequant(k, levels[w, k]) * basis[k, j]
//
// levels u8[W, E], basis f32[E, N], out f32[W, N]; E <= N <= 128.
//
// A CTA stages the basis and the dequant table in dynamic shared memory
// once, then walks window blocks of `bw` rows (grid-stride): the block's
// coefficients are dequantized into shared memory, then each output is a
// sequential fp32 FMA sum over k.  What bounds it on the H100: the output
// write (4 N bytes per window against E level bytes read) at the memory
// rate, and, at this simple first design, the shared-memory operand traffic
// of the FMA loop (two shared loads per FMA, one of them a broadcast).
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace fptc {

constexpr int kIdctThreads = 256;
constexpr int kMaxDim = 128;

// Dequant by exact selection from the 256-level reconstruction LUT
// (the reference's quant_grid): lut f32[E, 256], staged as is.
struct LutDequant {
  const float* lut;
  static int table_floats(int e) { return e * 256; }
  __device__ void stage(float* s, int e) const {
    for (int i = threadIdx.x; i < e * 256; i += blockDim.x) s[i] = lut[i];
  }
  __device__ float apply(const float* s, int, int k, uint8_t lvl) const {
    return s[k * 256 + lvl];
  }
};

// Inline 3-zone dequant (repro/kernels/idct_dequant.py::_kernel, lines
// 46-74, op for op in fp32): mu-law expm1/log1p in zone 0, linear deadzone
// in zone 1, zero in zone 2.  Staged table: zone[E] (as float), scale[E],
// then mu, alpha1, log1p(mu).
struct ZoneDequant {
  const int32_t* zone;
  const float* scale;
  const float* mu;
  const float* alpha1;
  static int table_floats(int e) { return 2 * e + 3; }
  __device__ void stage(float* s, int e) const {
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      s[i] = static_cast<float>(zone[i]);
      s[e + i] = scale[i];
    }
    if (threadIdx.x == 0) {
      s[2 * e] = *mu;
      s[2 * e + 1] = *alpha1;
      s[2 * e + 2] = log1pf(*mu);
    }
  }
  __device__ float apply(const float* s, int e, int k, uint8_t level) const {
    const float lvl = static_cast<float>(level);
    const int zone_k = static_cast<int>(s[k]);
    const float a = s[e + k];
    const bool pos = lvl > 128.0f;
    const bool neg = lvl < 128.0f;
    if (zone_k == 0) {
      float q01 = pos ? (lvl - 129.0f) / 126.0f : (127.0f - lvl) / 127.0f;
      q01 = fminf(fmaxf(q01, 0.0f), 1.0f);
      const float mag0 = a * (expm1f(q01 * s[2 * e + 2]) / s[2 * e]);
      if (lvl == 128.0f) return 0.0f;
      return pos ? mag0 : -mag0;
    }
    if (zone_k == 1) {
      const float d1 = s[2 * e + 1] * a;
      const float span = a - d1;
      const float mag1 = pos ? d1 + (lvl - 129.0f) / 126.0f * span
                             : d1 + (127.0f - lvl) / 127.0f * span;
      return pos ? mag1 : (neg ? -mag1 : 0.0f);
    }
    return 0.0f;
  }
};

template <class Dequant>
__global__ void __launch_bounds__(kIdctThreads)
    dequant_idct_kernel(const uint8_t* __restrict__ levels, int64_t num_windows,
                        int e, int n, int bw, const float* __restrict__ basis,
                        Dequant dq, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_basis = smem;             // [E, N]
  float* s_coef = s_basis + e * n;   // [bw, E]
  float* s_table = s_coef + bw * e;  // the dequant table
  for (int i = threadIdx.x; i < e * n; i += blockDim.x) s_basis[i] = basis[i];
  dq.stage(s_table, e);
  __syncthreads();

  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * bw; w0 < num_windows;
       w0 += static_cast<int64_t>(gridDim.x) * bw) {
    const int rows = static_cast<int>(min(static_cast<int64_t>(bw),
                                          num_windows - w0));
    const uint8_t* lv = levels + w0 * e;
    for (int i = threadIdx.x; i < rows * e; i += blockDim.x) {
      s_coef[i] = dq.apply(s_table, e, i % e, lv[i]);
    }
    __syncthreads();
    float* o = out + w0 * n;
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int w = i / n;
      const int j = i - w * n;
      const float* c = s_coef + w * e;
      float acc = 0.0f;
      for (int k = 0; k < e; ++k) acc = fmaf(c[k], s_basis[k * n + j], acc);
      o[i] = acc;
    }
    __syncthreads();
  }
}

// Shared-memory bytes for a window block of `bw` rows.
inline size_t dequant_idct_smem(int e, int n, int bw, int table_floats) {
  return sizeof(float) * (static_cast<size_t>(e) * n +
                          static_cast<size_t>(bw) * e + table_floats);
}

// The launch geometry for one (device, E, N): the window block, its
// shared-memory bytes, and the most CTAs the device holds at once.
struct DequantIdctGeometry {
  int bw;
  size_t smem;
  int64_t resident;
};

// Compute the geometry on `device` (the current device), raising the
// kernel's dynamic shared-memory limit there to the device's opt-in maximum.
template <class Dequant>
cudaError_t dequant_idct_geometry(int device, int e, int n,
                                  DequantIdctGeometry* g) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the largest window block (<= 256 rows) whose coefficients fit beside
  // the basis and the table
  const int table_floats = Dequant::table_floats(e);
  int bw = 256;
  while (bw > 8 && dequant_idct_smem(e, n, bw, table_floats) >
                       static_cast<size_t>(max_smem)) {
    bw /= 2;
  }
  const size_t smem = dequant_idct_smem(e, n, bw, table_floats);
  auto kernel = dequant_idct_kernel<Dequant>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kIdctThreads, smem);
  if (err != cudaSuccess) return err;
  *g = {bw, smem, static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1)};
  return cudaSuccess;
}

// Launch over `levels` u8[num_windows, e] -> out f32[num_windows, n] on the
// current device.  The geometry is computed once per (device, E, N).
template <class Dequant>
int launch_dequant_idct(const uint8_t* levels, int64_t num_windows, int e,
                        int n, const float* basis, Dequant dq, float* out,
                        cudaStream_t stream) {
  if (num_windows <= 0) return 0;
  if (e < 1 || n < 1 || e > kMaxDim || n > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, DequantIdctGeometry> cache;
  DequantIdctGeometry g;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(device, e, n);
    auto it = cache.find(key);
    if (it == cache.end()) {
      err = dequant_idct_geometry<Dequant>(device, e, n, &g);
      if (err != cudaSuccess) return static_cast<int>(err);
      cache.emplace(key, g);
    } else {
      g = it->second;
    }
  }
  const int64_t blocks_needed = (num_windows + g.bw - 1) / g.bw;
  const int64_t grid = blocks_needed < g.resident ? blocks_needed : g.resident;
  dequant_idct_kernel<Dequant>
      <<<static_cast<unsigned>(grid), kIdctThreads, g.smem, stream>>>(
          levels, num_windows, e, n, g.bw, basis, dq, out);
  FPTC_CHECK_LAUNCH();
  return 0;
}

}  // namespace fptc
