// The forward DCT + 3-zone quantize template shared by K5 (dct_quant.cu)
// and K4's first stage (encode_fused.cu, encode_levels).
//
//   level[w, k] = quantize(sum_j x[w, j] * basis[j, k], k)
//
// x f32[rows, N] (staged in shared memory with a row stride of N + 1, so
// the threads of a warp that read different windows hit different banks),
// basis f32[N, E] in shared memory, N, E <= 128.  Each output is one fp32
// FMA chain over j in ascending order, starting from 0.
//
// Rounding.  The quantizer must equal the port's plain
// repro_torch/core/quantize.py::quantize bit for bit when given the same
// coefficient, and PyTorch rounds after every elementwise op:
//  * torch.round rounds half to even: rintf here, never roundf;
//  * nvcc would contract `(c - d1) / denom * 126 + 0.5` (and `a - alpha1 *
//    a`) into FMAs, which round once where torch rounds twice, so every
//    such line is written with __fsub_rn / __fdiv_rn / __fmul_rn /
//    __fadd_rn, which are never contracted (the shared nvcc flags keep
//    -fmad=true for the decode kernels);
//  * log1p(mu) is log1pf of the f32 mu, computed once per CTA, as the plain
//    version's torch.log1p(mu) on the f32 mu tensor is.
// The DCT itself sums in another order than the plain version's cuBLAS
// product, so a coefficient within an ulp of a cell boundary can land one
// level away; the quantizer alone is exact (an identity basis makes the
// coefficients the inputs).
#pragma once

#include <mutex>
#include <set>
#include <tuple>

#include "common.cuh"

namespace fptc {

constexpr int kDctMaxDim = 128;

// The quantizer's per-band table and scalars, staged in shared memory.
struct QuantArgs {
  const int32_t* zone;  // [E]
  const float* scale;   // [E]
  const float* mu;      // [1], read on the device (no host sync)
  const float* alpha1;  // [1]
};

// Floats of shared memory the staged table takes: zone[E] (as int bits),
// scale[E], then mu, alpha1, log1p(mu).
__host__ __device__ inline int quant_table_floats(int e) { return 2 * e + 3; }

__device__ __forceinline__ void stage_quant(float* s, const QuantArgs& q,
                                            int e) {
  int* s_zone = reinterpret_cast<int*>(s);
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    s_zone[i] = q.zone[i];
    s[e + i] = q.scale[i];
  }
  if (threadIdx.x == 0) {
    const float mu = *q.mu;
    s[2 * e] = mu;
    s[2 * e + 1] = *q.alpha1;
    s[2 * e + 2] = log1pf(mu);
  }
}

// repro_torch/core/quantize.py::quantize for one coefficient of band k,
// op for op in fp32.
__device__ __forceinline__ uint8_t quantize_level(float c, const float* s,
                                                  int e, int k) {
  const int zone = reinterpret_cast<const int*>(s)[k];
  if (zone == 0) {  // mu-law companding
    if (c == 0.0f) return 128;
    const float a = s[e + k];
    const float x = fminf(__fdiv_rn(fabsf(c), a), 1.0f);
    const float q01 = __fdiv_rn(log1pf(__fmul_rn(s[2 * e], x)), s[2 * e + 2]);
    const float lvl = c > 0.0f
                          ? __fadd_rn(129.0f, rintf(__fmul_rn(q01, 126.0f)))
                          : __fsub_rn(127.0f, rintf(__fmul_rn(q01, 127.0f)));
    return static_cast<uint8_t>(fminf(fmaxf(lvl, 0.0f), 255.0f));
  }
  if (zone == 1) {  // linear deadzone
    const float a = s[e + k];
    const float d1 = __fmul_rn(s[2 * e + 1], a);
    const float denom = fmaxf(__fsub_rn(a, d1), 1e-12f);
    const float cc = fmaxf(fminf(c, a), -a);
    float lvl = 128.0f;
    if (cc > d1) {
      const float t = __fmul_rn(__fdiv_rn(__fsub_rn(cc, d1), denom), 126.0f);
      lvl = __fadd_rn(129.0f, floorf(__fadd_rn(t, 0.5f)));
    } else if (cc < -d1) {
      const float t =
          __fmul_rn(__fdiv_rn(__fsub_rn(fabsf(cc), d1), denom), 127.0f);
      lvl = __fsub_rn(127.0f, floorf(__fadd_rn(t, 0.5f)));
    }
    return static_cast<uint8_t>(fminf(fmaxf(lvl, 0.0f), 255.0f));
  }
  return 128;  // zone 2: aggressive zeroing
}

// Copy rows x N contiguous floats from device memory into shared memory
// with row stride N + 1 (coalesced reads).
__device__ __forceinline__ void stage_windows(float* s_x,
                                              const float* __restrict__ x,
                                              int rows, int n) {
  const int total = rows * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int w = i / n;
    s_x[w * (n + 1) + (i - w * n)] = x[i];
  }
}

// stage_windows for a row that is a run of a flat sample tensor: `row`
// points at the run's first sample and the run holds `len` samples, so
// sample p of the row (p from `first`) is row[p] for p < len and an exact
// zero past it — the gather the transcoder's GatherStage describes.  Only
// the run is read: no sample past row[len - 1].
__device__ __forceinline__ void stage_windows_gather(
    float* s_x, const float* __restrict__ row, int64_t len, int64_t first,
    int rows, int n) {
  const int total = rows * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int w = i / n;
    const int64_t p = first + i;
    s_x[w * (n + 1) + (i - w * n)] = p < len ? row[p] : 0.0f;
  }
}

// DCT + quantize of a staged window block: calls store(w, k, level) for
// every (w, k) of the block, threads striding over the rows x E outputs.
template <class Store>
__device__ __forceinline__ void dct_quant_block(const float* s_x, int rows,
                                                int n, int e,
                                                const float* s_basis,
                                                const float* s_quant,
                                                Store store) {
  const int total = rows * e;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int w = i / e;
    const int k = i - w * e;
    const float* xw = s_x + w * (n + 1);
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = fmaf(xw[j], s_basis[j * e + k], acc);
    store(w, k, quantize_level(acc, s_quant, e, k));
  }
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device when it needs more than the default 48 KiB, once per (device,
// kernel, bytes); returns the error, if any.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::set<std::tuple<int, const void*, size_t>> done;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, kernel, bytes);
  if (done.count(key)) return cudaSuccess;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.insert(key);
  return err;
}

}  // namespace fptc
