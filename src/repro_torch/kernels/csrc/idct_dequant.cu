// K3: fused 3-zone dequant + inverse DCT for fixed-rate (entropy-off) blocks.
//
// Replaces repro/kernels/idct_dequant.py::idct_dequant (_kernel), the TPU
// kernel at idct_dequant.py:104: levels [W, E] -> inline 3-zone dequant
// (mu-law expm1/log1p in zone 0, linear deadzone in zone 1, zero in zone 2)
// -> @ idct_basis [E, N] -> f32 [W, N].  It dequantizes by that kernel's
// 3-zone formulas, not from quant_grid's LUT.
//
// What bounds it on the H100: the f32 output write (4 N bytes per window
// against E level bytes read) at the memory rate (see dequant_idct.cuh).
// Design: the template of K2's last stage.  Each CTA builds the E x 256
// dequant table on the device once, by the unchanged inline 3-zone dequant
// (ZoneDequant::apply) for every (band, level), from zone, scale, mu and
// alpha1 (read on the device, so no host sync); the windows then take the
// same table path as the LUT-iDCT.  The reference evaluates the dequant per
// coefficient; the table holds the same values for 2^21 x 16 coefficients
// at the cost of 4096 evaluations a CTA.
#include "dequant_idct.cuh"

// levels u8[num_windows, e], zone i32[e], scale f32[e], mu f32[1],
// alpha1 f32[1], basis f32[e, n] -> out f32[num_windows, n].
FPTC_EXPORT int fptc_idct_dequant(const void* levels, int64_t num_windows,
                                  int64_t e, int64_t n, const void* zone,
                                  const void* scale, const void* mu,
                                  const void* alpha1, const void* basis,
                                  void* out, void* stream) {
  fptc::ZoneDequant dq{static_cast<const int32_t*>(zone),
                       static_cast<const float*>(scale),
                       static_cast<const float*>(mu),
                       static_cast<const float*>(alpha1)};
  return fptc::launch_dequant_idct(
      static_cast<const uint8_t*>(levels), num_windows, static_cast<int>(e),
      static_cast<int>(n), static_cast<const float*>(basis), dq,
      static_cast<float*>(out), 0, static_cast<cudaStream_t>(stream));
}
