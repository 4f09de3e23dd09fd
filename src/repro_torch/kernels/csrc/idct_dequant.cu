// K3: fused 3-zone dequant + inverse DCT for fixed-rate (entropy-off) blocks.
//
// Replaces repro/kernels/idct_dequant.py::idct_dequant (_kernel), the TPU
// kernel at idct_dequant.py:104: levels [W, E] -> inline 3-zone dequant
// (mu-law expm1/log1p in zone 0, linear deadzone in zone 1, zero in zone 2)
// -> @ idct_basis [E, N] -> f32 [W, N].  It dequantizes inline, as that
// kernel does, not from the LUT.
//
// What bounds it on the H100: the f32 output write (4 N bytes per window
// against E level bytes read) at the memory rate; the expm1f per zone-0
// coefficient and the FMA loop are the compute side (see dequant_idct.cuh).
// Design: the same CTA template as K2's last stage, with the zone table,
// scales and (mu, alpha1, log1p(mu)) staged in shared memory in place of
// the LUT; mu and alpha1 are read on the device, so no host sync.
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
      static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
