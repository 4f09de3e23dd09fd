// The SymLen decode step shared by K1 (symlen_decode.cu) and K6
// (symlen_tile.cu): the canonical-code arithmetic for one prefix, and the
// decode table built from it, so both kernels decode with the same bits.
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
// and all-zero padding words decode alike on every arm.
//
// The step depends only on the prefix, so it is a table of 2^l_max
// entries (the paper's LUT): entry p holds decode_prefix(p) — the symbol in
// bits 0-7, the length in bits 8-15 — and is built by calling
// decode_prefix, so the table equals the arithmetic bit for bit by
// construction.  A step is then one table read and two shifts in place of
// a chain of l_max compares and three dependent table reads.  The table is
// 2^(l_max + 1) bytes: 8 KiB at l_max = 12 (every archive plan), 128 KiB at
// l_max = 16, which the kernels take as dynamic shared memory.  The word is
// a native 64-bit integer: the TPU kernels' (hi, lo) uint32 funnel shifts
// are not needed.
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

// The symbol and the codeword length that the top l_max bits `prefix` of a
// word decode to.
__device__ __forceinline__ void decode_prefix(uint32_t prefix,
                                              const SymlenTables& t,
                                              int l_max, uint32_t* sym,
                                              int* len_out) {
  int len = 1;
  for (int l = 0; l < l_max; ++l) len += prefix >= t.limit[l];
  len = min(len, l_max);
  const uint32_t diff = prefix - t.first[len];
  // wrap-around int32 addition, as the reference's int32 arrays add
  int32_t rank = static_cast<int32_t>(static_cast<uint32_t>(t.rank[len]) +
                                      (diff >> (l_max - len)));
  rank = min(max(rank, 0), 255);
  *sym = t.syms[rank];
  *len_out = len;  // in [1, 16]
}

// Table entries p = start, start + stride, ... < 2^l_max of `lut` (shared
// or device memory).
__device__ __forceinline__ void build_lut(uint16_t* lut, const SymlenTables& t,
                                          int l_max, int64_t start,
                                          int64_t stride) {
  for (int64_t p = start; p < (int64_t{1} << l_max); p += stride) {
    uint32_t sym;
    int len;
    decode_prefix(static_cast<uint32_t>(p), t, l_max, &sym, &len);
    lut[p] = static_cast<uint16_t>(sym | (static_cast<uint32_t>(len) << 8));
  }
}

// Bytes of the table for l_max, rounded up to 16.
__host__ __device__ inline size_t lut_bytes(int l_max) {
  return align16(size_t{2} << l_max);
}

// Decode the symbol at the top of `cur` and consume its codeword: the
// table read (`shift` = 64 - l_max) and the shift.
__device__ __forceinline__ uint32_t lut_step(uint64_t& cur,
                                             const uint16_t* lut, int shift) {
  const uint32_t e = lut[cur >> shift];
  cur <<= e >> 8;
  return e & 255u;
}

}  // namespace fptc
