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
// read once against E level bytes written, at the memory rate; the 2 N E
// fp32 operations per window take about a third of that time at the
// card's fp32 rate for the KV block (N = E = 16), and the quantizer's
// divisions and log1pf (tens of instructions an output) more than that,
// so it sits between the two.  Design: K4's levels_kernel (dct_quant.cuh)
// with one row of W windows and no v3 coding — persistent CTAs, the basis
// and quant table staged once a CTA, each block of windows copied by
// cp.async while the block before is transformed in RW x 4 register tiles,
// quantized a band a warp from shared memory, and written 16 bytes a
// store.  Every output stays one ascending fmaf chain from 0.0f followed
// by the unchanged quantizer, so the levels equal the one-thread-per-
// output kernel's bit for bit.
#include "dct_quant.cuh"

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
  return fptc::launch_levels<false>(
      static_cast<const float*>(windows), nullptr, nullptr, nullptr, 1,
      num_windows, static_cast<int>(n), static_cast<int>(e),
      static_cast<const float*>(basis),
      fptc::QuantArgs{static_cast<const int32_t*>(zone),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(mu),
                      static_cast<const float*>(alpha1)},
      fptc::Coding{0, 0, 0}, static_cast<uint8_t*>(out), nullptr, nullptr,
      nullptr, nullptr, 0, static_cast<cudaStream_t>(stream));
}
