// K5: fused forward DCT + 3-zone quantize — the fixed-rate (entropy-off)
// encode of the KV cache.
//
// Replaces repro/kernels/dct_quant.py::dct_quant (_kernel), the TPU kernel
// at dct_quant.py:123: windows f32[W, N] @ dct_basis[N, E] -> 3-zone
// quantize -> levels [W, E].  The TPU kernel has a fast arm that inlines
// the quantizer for the TPU's vector unit and an exact=True arm that
// traces the reference quantizer; on Hopper the exact quantizer costs the
// same as any other, so both arms are this one kernel, exact, and it writes
// u8 levels (the TPU kernel wrote int32 for the caller to cast).
//
// What bounds it on the H100: bytes — the f32 input (4 N bytes per window)
// read once against E level bytes written, at the memory rate; the
// 2 N E fp32 operations per window take about a third of that time at the
// card's fp32 rate for the KV block (N = E = 16).  Design: a CTA stages the
// basis [N, E] (at most 64 KiB) and the quant table in shared memory once,
// then walks window blocks grid-stride: each block's windows are read
// coalesced into shared memory and every (w, k) output is one FMA chain
// followed by the quantizer inline (dct_quant.cuh says what keeps it bit
// exact).  The grid is the card's resident-CTA count, so the staging of the
// basis is paid once per CTA, not once per block.
#include <map>

#include "dct_quant.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dct_quant_kernel(const float* __restrict__ windows, int64_t num_windows,
                     int n, int e, int bw, const float* __restrict__ basis,
                     fptc::QuantArgs q, uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_basis = smem;                                   // [N, E]
  float* s_quant = s_basis + n * e;                        // the table
  float* s_x = s_quant + fptc::quant_table_floats(e);      // [bw, N + 1]
  for (int i = threadIdx.x; i < n * e; i += blockDim.x) s_basis[i] = basis[i];
  fptc::stage_quant(s_quant, q, e);

  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * bw; w0 < num_windows;
       w0 += static_cast<int64_t>(gridDim.x) * bw) {
    const int rows = static_cast<int>(min(static_cast<int64_t>(bw),
                                          num_windows - w0));
    __syncthreads();  // the previous block is done with s_x (and staging)
    fptc::stage_windows(s_x, windows + w0 * n, rows, n);
    __syncthreads();
    uint8_t* o = out + w0 * e;
    fptc::dct_quant_block(s_x, rows, n, e, s_basis, s_quant,
                          [&](int w, int k, uint8_t level) {
                            o[w * e + k] = level;
                          });
  }
}

size_t dct_quant_smem(int n, int e, int bw) {
  return sizeof(float) * (static_cast<size_t>(n) * e +
                          fptc::quant_table_floats(e) +
                          static_cast<size_t>(bw) * (n + 1));
}

struct Geometry {
  int bw;
  size_t smem;
  int64_t resident;
};

// The window block, its shared memory and the resident-CTA count, once
// per (device, N, E).
cudaError_t geometry(int n, int e, Geometry* g) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Geometry> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, n, e);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *g = it->second;
    return cudaSuccess;
  }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int bw = 256;
  while (bw > 8 && dct_quant_smem(n, e, bw) > static_cast<size_t>(max_smem)) {
    bw /= 2;
  }
  const size_t smem = dct_quant_smem(n, e, bw);
  err = fptc::allow_smem(reinterpret_cast<const void*>(dct_quant_kernel), smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dct_quant_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *g = {bw, smem, static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1)};
  cache.emplace(key, *g);
  return cudaSuccess;
}

}  // namespace

// windows f32[num_windows, n], basis f32[n, e], zone i32[e], scale f32[e],
// mu f32[1], alpha1 f32[1] -> out u8[num_windows, e].
FPTC_EXPORT int fptc_dct_quant(const void* windows, int64_t num_windows,
                               int64_t n, int64_t e, const void* basis,
                               const void* zone, const void* scale,
                               const void* mu, const void* alpha1, void* out,
                               void* stream) {
  if (num_windows <= 0) return 0;
  if (n < 1 || e < 1 || e > n || n > fptc::kDctMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  cudaError_t err = geometry(static_cast<int>(n), static_cast<int>(e), &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (num_windows + g.bw - 1) / g.bw;
  const int64_t grid = blocks < g.resident ? blocks : g.resident;
  fptc::QuantArgs q{static_cast<const int32_t*>(zone),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(mu),
                    static_cast<const float*>(alpha1)};
  dct_quant_kernel<<<static_cast<unsigned>(grid), kThreads, g.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), num_windows, static_cast<int>(n),
      static_cast<int>(e), g.bw, static_cast<const float*>(basis), q,
      static_cast<uint8_t*>(out));
  FPTC_CHECK_LAUNCH();
  return 0;
}
