// K2, after K1's decode: the container-v3 expansion + un-prediction, and
// the LUT dequant + inverse DCT.
//
// Replaces repro/kernels/decode_fused.py::decode_fused (_fused_kernel,
// lut_dequant), the TPU megakernel at decode_fused.py:305, which runs K1's
// decode, then for v3 codings the expand_coded_stream gather (-1 -> 128)
// and unpredict_levels (a segmented cumsum mod 256 over bands <
// predict_bands, twice for linear2), then coeffs[w, k] = lut[k, level] and
// coeffs @ basis.  Here that is three launches (K1's kernel writes dense u8
// levels to device memory; these two kernels follow) until measurements say
// fusing pays.
//
// What bounds it on the H100: the f32 output (4 N bytes per window) at the
// memory rate for the dequant/iDCT; the v3 un-prediction walks each
// signal's windows in order (one thread per (signal, band)), so it is bound
// by the latency of that walk, not by bandwidth.
//
// Design, against the TPU workarounds it drops:
//  * the 256-step masked-select lut_dequant loop (TPUs lack a per-element
//    VMEM gather) becomes a direct shared-memory table read;
//  * the segment scan crosses window blocks, so it is its own pass: one
//    thread per (segment, band < predict_bands) walks the segment's windows
//    in order; bands >= predict_bands only gather.  Arithmetic stays mod
//    256 (masked after every add), which equals the reference's uint32 wrap
//    mod 256 because 256 divides 2^32.
#include "dequant_idct.cuh"

namespace {

constexpr int kThreads = 256;

// grid[p] = dense[idx[p]], or the zero bin where idx[p] < 0.  Out-of-range
// positions clamp like XLA's gather.
__global__ void v3_expand(const uint8_t* __restrict__ dense, int64_t dense_len,
                          const int32_t* __restrict__ idx, int64_t num_cells,
                          uint8_t* __restrict__ grid) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= num_cells) return;
  const int64_t i = idx[p];
  grid[p] = i >= 0 ? dense[i < dense_len ? i : dense_len - 1]
                   : static_cast<uint8_t>(128);
}

// In place over grid u8[num_windows, e], bands k < bands.  Thread t takes
// (window t / bands, band t % bands) and, when that window starts a segment
// (seg[w] == w), walks the segment's windows: t = (g + 128) mod 256, a
// running sum (a double running sum for linear2), level = (sum + 128) mod 256.
__global__ void v3_unpredict(uint8_t* __restrict__ grid,
                             const int32_t* __restrict__ seg,
                             int64_t num_windows, int e, int bands,
                             int pred_id) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= num_windows * bands) return;
  const int64_t start = t / bands;
  const int k = static_cast<int>(t - start * bands);
  if (seg[start] != start) return;
  uint32_t cs1 = 0;
  uint32_t cs2 = 0;
  for (int64_t w = start; w < num_windows && (w == start || seg[w] == start);
       ++w) {
    uint8_t* cell = grid + w * e + k;
    cs1 = (cs1 + ((static_cast<uint32_t>(*cell) + 128u) & 255u)) & 255u;
    uint32_t cs = cs1;
    if (pred_id == 2) {
      cs2 = (cs2 + cs1) & 255u;
      cs = cs2;
    }
    *cell = static_cast<uint8_t>((cs + 128u) & 255u);
  }
}

}  // namespace

// dense u8[dense_len] coded symbols, idx i32[num_windows * e],
// seg i32[num_windows] -> grid u8[num_windows * e] (plain levels).
FPTC_EXPORT int fptc_v3_expand_unpredict(const void* dense, int64_t dense_len,
                                         const void* idx, const void* seg,
                                         int64_t num_windows, int64_t e,
                                         int64_t bands, int64_t pred_id,
                                         void* grid, void* stream) {
  const int64_t cells = num_windows * e;
  if (cells <= 0) return 0;
  if (dense_len <= 0 || bands < 0 || bands > e) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  v3_expand<<<static_cast<unsigned>((cells + kThreads - 1) / kThreads),
              kThreads, 0, s>>>(static_cast<const uint8_t*>(dense), dense_len,
                                static_cast<const int32_t*>(idx), cells,
                                static_cast<uint8_t*>(grid));
  FPTC_CHECK_LAUNCH();
  if (pred_id == 0 || bands == 0) return 0;
  const int64_t walkers = num_windows * bands;
  v3_unpredict<<<static_cast<unsigned>((walkers + kThreads - 1) / kThreads),
                 kThreads, 0, s>>>(static_cast<uint8_t*>(grid),
                                   static_cast<const int32_t*>(seg),
                                   num_windows, static_cast<int>(e),
                                   static_cast<int>(bands),
                                   static_cast<int>(pred_id));
  FPTC_CHECK_LAUNCH();
  return 0;
}

// levels u8[num_windows, e], lut f32[e, 256], basis f32[e, n]
// -> out f32[num_windows, n].
FPTC_EXPORT int fptc_lut_idct(const void* levels, int64_t num_windows,
                              int64_t e, int64_t n, const void* lut,
                              const void* basis, void* out, void* stream) {
  fptc::LutDequant dq{static_cast<const float*>(lut)};
  return fptc::launch_dequant_idct(
      static_cast<const uint8_t*>(levels), num_windows, static_cast<int>(e),
      static_cast<int>(n), static_cast<const float*>(basis), dq,
      static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
