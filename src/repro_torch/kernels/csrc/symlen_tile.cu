// K6: slot-major SymLen decode tile — every slot of every word, uncompacted.
//
// Replaces repro/kernels/huffman_decode.py::huffman_decode_tile (its
// _decode_kernel), the TPU kernel whose pallas_call is at
// huffman_decode.py:359.  It computes what that kernel computes: word w
// decodes max_symlen symbols MSB first, whatever its symlen, and slot j of
// word w lands at out[j * W + w] of an int32 [max_symlen, W] tile.  Slots
// past a word's symlen and all-zero padding words decode the bits that are
// left (zeros shift in), with the length clamp and the rank clip of the
// shared step (symlen_step.cuh), exactly as the TPU kernel does; the
// compaction stays outside (core/symlen.py::compact_padded_scatter), which
// makes this the staged decode that holds K1 on the card.
//
// What bounds it on the H100: bytes.  A word is read once (8 bytes) and
// max_symlen int32 slots are written (4 * max_symlen bytes).
//
// Design: persistent CTAs, each building the decode table of
// symlen_step.cuh in its shared memory once (2^l_max entries by the
// canonical arithmetic), so a slot is one table read and two shifts in
// place of a chain of l_max compares and three dependent reads.  A warp
// takes groups of 32 x kWords words, lane l the words l, l + 32, ...: each
// thread walks kWords independent chains (native 64-bit words, no (hi, lo)
// funnel shifts), and for each slot j and chain the warp's store is 32
// consecutive int32 of row j — the slot-major layout the TPU kernel chose
// for its lanes is what makes the stores coalesced here — streamed past
// the caches.
#include "symlen_step.cuh"

namespace {

constexpr int kTileThreads = 512;
constexpr int kWords = 4;  // independent chains a thread

__global__ void __launch_bounds__(kTileThreads, 2)
    symlen_tile_kernel(const uint64_t* __restrict__ words, int64_t num_words,
                       const int32_t* __restrict__ dec_limit,
                       const int32_t* __restrict__ dec_first,
                       const int32_t* __restrict__ dec_rank,
                       const int32_t* __restrict__ dec_syms, int l_max,
                       int max_symlen, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  __shared__ fptc::SymlenTables tab;
  fptc::load_symlen_tables(&tab, dec_limit, dec_first, dec_rank, dec_syms,
                           l_max);
  __syncthreads();
  fptc::build_lut(s_lut, tab, l_max, threadIdx.x, blockDim.x);
  __syncthreads();
  const int shift = 64 - l_max;
  const int lane = threadIdx.x & 31;
  constexpr int64_t kSpan = 32 * kWords;
  const int64_t groups = (num_words + kSpan - 1) / kSpan;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kTileThreads / 32);
  const auto* src = reinterpret_cast<const unsigned long long*>(words);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * (kTileThreads / 32) +
                   threadIdx.x / 32;
       g < groups; g += warps) {
    const int64_t w0 = g * kSpan + lane;
    uint64_t cur[kWords];
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
      const int64_t w = w0 + 32 * r;
      cur[r] = w < num_words ? __ldcs(src + w) : 0;
    }
    int32_t* row = out;
    for (int j = 0; j < max_symlen; ++j, row += num_words) {
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        const uint32_t sym = fptc::lut_step(cur[r], s_lut, shift);
        const int64_t w = w0 + 32 * r;
        if (w < num_words) __stcs(row + w, static_cast<int32_t>(sym));
      }
    }
  }
}

}  // namespace

// words u64[num_words], decode tables (int32 bit patterns) -> out
// i32[max_symlen, num_words].
FPTC_EXPORT int fptc_symlen_tile(const void* words, int64_t num_words,
                                 const void* dec_limit, const void* dec_first,
                                 const void* dec_rank, const void* dec_syms,
                                 int64_t l_max, int64_t max_symlen, void* out,
                                 void* stream) {
  if (num_words <= 0 || max_symlen <= 0) return 0;
  if (l_max < 1 || l_max > fptc::kMaxLmax || max_symlen > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fptc::lut_bytes(static_cast<int>(l_max));
  int64_t resident = 0;
  cudaError_t err = fptc::cached_resident_ctas(
      reinterpret_cast<const void*>(symlen_tile_kernel), kTileThreads, smem,
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = (num_words + 32 * kWords - 1) / (32 * kWords);
  const int64_t ctas_needed =
      (groups + kTileThreads / 32 - 1) / (kTileThreads / 32);
  const int64_t ctas = ctas_needed < resident ? ctas_needed : resident;
  symlen_tile_kernel<<<static_cast<unsigned>(ctas), kTileThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(words), num_words,
      static_cast<const int32_t*>(dec_limit),
      static_cast<const int32_t*>(dec_first),
      static_cast<const int32_t*>(dec_rank),
      static_cast<const int32_t*>(dec_syms), static_cast<int>(l_max),
      static_cast<int>(max_symlen), static_cast<int32_t*>(out));
  FPTC_CHECK_LAUNCH();
  return 0;
}
