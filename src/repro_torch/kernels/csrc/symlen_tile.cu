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
// max_symlen int32 slots are written (4 * max_symlen bytes), against a
// dependent chain of <= 16 compares and a shared-memory read per slot.
//
// Design: one thread per native 64-bit word (no (hi, lo) funnel shifts),
// the canonical tables in shared memory in place of the one-hot [BW, 256]
// MXU lookup.  The slot-major layout the TPU kernel chose for its lanes is
// what makes the stores coalesced here: for each slot j the 32 threads of a
// warp store 32 consecutive int32 of row j.
#include "symlen_step.cuh"

namespace {

constexpr int kTileBlock = 256;

__global__ void __launch_bounds__(kTileBlock)
    symlen_tile_kernel(const uint64_t* __restrict__ words, int64_t num_words,
                       const int32_t* __restrict__ dec_limit,
                       const int32_t* __restrict__ dec_first,
                       const int32_t* __restrict__ dec_rank,
                       const int32_t* __restrict__ dec_syms, int l_max,
                       int max_symlen, int32_t* __restrict__ out) {
  __shared__ fptc::SymlenTables s_tab;
  fptc::load_symlen_tables(&s_tab, dec_limit, dec_first, dec_rank, dec_syms,
                           l_max);
  __syncthreads();
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= num_words) return;
  uint64_t cur = words[w];
  int32_t* col = out + w;
  for (int j = 0; j < max_symlen; ++j) {
    col[static_cast<int64_t>(j) * num_words] =
        fptc::decode_step(cur, s_tab, l_max);
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
  const int64_t blocks = (num_words + kTileBlock - 1) / kTileBlock;
  symlen_tile_kernel<<<static_cast<unsigned>(blocks), kTileBlock, 0,
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
