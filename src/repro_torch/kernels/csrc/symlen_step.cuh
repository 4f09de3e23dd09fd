// The per-symbol SymLen decode step shared by K1 (symlen_decode.cu) and K6
// (symlen_tile.cu), so both decode with the same arithmetic.
//
// The arithmetic is the reference XLA arm's (core/symlen.py::unpack_symlen)
// and the Pallas kernels' (kernels/huffman_decode.py::_decode_slot): with
// prefix = the top l_max bits of the remaining word,
//   length = min(1 + #(prefix >= limit[l]), l_max)
//   rank   = rank_offset[length] + (uint32(prefix - first[length]) >>
//            (l_max - length)) as int32, clipped to [0, 255]
//   symbol = sorted_symbols[rank]
// and the word shifts left by length.  The clamp and the clip make every
// bit pattern decode to a defined symbol, so the slots past a word's symlen
// and all-zero padding words decode alike on every arm.  The word is a
// native 64-bit integer: the TPU kernels' (hi, lo) uint32 funnel shifts
// are not needed, and the one-hot [BW, 256] symbol lookup becomes a read of
// the 256-entry table in shared memory.
#pragma once

#include "common.cuh"

namespace fptc {

constexpr int kMaxLmax = 16;

// The canonical-code decode tables, staged in shared memory.
struct SymlenTables {
  uint32_t limit[kMaxLmax];     // limit_shifted[1:]
  uint32_t first[kMaxLmax + 1];  // first_code_shifted
  int32_t rank[kMaxLmax + 1];    // rank_offset
  uint8_t syms[256];             // sorted_symbols
};

// Stage the tables (int32 bit patterns, as the wrappers hold them) into
// shared memory; the caller synchronizes the block after it.
__device__ __forceinline__ void load_symlen_tables(
    SymlenTables* t, const int32_t* __restrict__ dec_limit,
    const int32_t* __restrict__ dec_first, const int32_t* __restrict__ dec_rank,
    const int32_t* __restrict__ dec_syms, int l_max) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    t->syms[i] = static_cast<uint8_t>(dec_syms[i]);
    if (i < l_max) t->limit[i] = static_cast<uint32_t>(dec_limit[i]);
    if (i <= l_max) {
      t->first[i] = static_cast<uint32_t>(dec_first[i]);
      t->rank[i] = dec_rank[i];
    }
  }
}

// Decode the symbol at the top of `cur` and consume its codeword.
__device__ __forceinline__ uint8_t decode_step(uint64_t& cur,
                                               const SymlenTables& t,
                                               int l_max) {
  const uint32_t prefix = static_cast<uint32_t>(cur >> (64 - l_max));
  int len = 1;
  for (int l = 0; l < l_max; ++l) len += prefix >= t.limit[l];
  len = min(len, l_max);
  const uint32_t diff = prefix - t.first[len];
  // wrap-around int32 addition, as the reference's int32 arrays add
  int32_t rank = static_cast<int32_t>(static_cast<uint32_t>(t.rank[len]) +
                                      (diff >> (l_max - len)));
  rank = min(max(rank, 0), 255);
  cur <<= len;  // len is in [1, 16]
  return t.syms[rank];
}

}  // namespace fptc
