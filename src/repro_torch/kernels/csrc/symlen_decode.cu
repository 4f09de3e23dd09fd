// K1: word-parallel SymLen Huffman decode + exclusive-scan compaction.
//
// Replaces repro/kernels/huffman_decode.py::huffman_decode_dense (its
// _dense_kernel / decode_block_to_dense / _decode_slot), the TPU kernel at
// huffman_decode.py:297.  It computes what that kernel computes: word w
// decodes symlen[w] canonical-Huffman symbols MSB first and writes them at
// the exclusive prefix sum of symlen plus the slot; positions past the true
// symbol total keep the zero the wrapper filled them with.
//
// What bounds it on the H100: the decode is a short dependent chain per
// symbol (prefix, <= 16 compares, rank, table read, shift) and each thread
// stores single bytes at scattered offsets — instruction latency and
// uncoalesced stores, not device-memory bandwidth (the words are read once,
// 9 bytes per word of input against ~8-30 output bytes).
//
// Design, against the TPU workarounds it drops:
//  * the running output base carried in SMEM across the sequential TPU grid
//    becomes a device-wide exclusive scan: a block-local scan, a scan of
//    the block sums, and the add-back folded into the decode kernel;
//  * one thread per native 64-bit word: no (hi, lo) funnel shifts;
//  * the canonical tables (limit, first, rank, symbols) sit in shared
//    memory in place of the one-hot [BW, 256] MXU lookup;
//  * each thread stores only its own symlen[w] symbols, so the overlapping
//    row spill and re-zero of the TPU store is not needed.
// The per-symbol step (symlen_step.cuh, shared with K6's symlen_tile.cu) is
// the reference XLA arm's arithmetic (core/symlen.py::unpack_symlen), clamp
// and clip included — so even garbage bits decode to the same symbol in both.
#include "symlen_step.cuh"

namespace {

constexpr int kScanBlock = 1024;  // words per block of the offset scan
constexpr int kDecodeBlock = 256;

__global__ void symlen_scan_local(const uint8_t* __restrict__ symlen,
                                  int64_t num_words,
                                  int32_t* __restrict__ local,
                                  int32_t* __restrict__ block_sums) {
  __shared__ int32_t warp_sums[32];
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kScanBlock + threadIdx.x;
  const int32_t v = w < num_words ? static_cast<int32_t>(symlen[w]) : 0;
  int32_t total;
  const int32_t excl = fptc::block_exclusive_scan(v, warp_sums, &total);
  if (w < num_words) local[w] = excl;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// Exclusive scan of the per-block sums in place: one block walks them in
// chunks of blockDim.x, carrying the running total.
__global__ void scan_block_sums(int32_t* __restrict__ sums, int64_t count) {
  __shared__ int32_t warp_sums[32];
  int32_t carry = 0;
  for (int64_t base = 0; base < count; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < count ? sums[i] : 0;
    int32_t total;
    const int32_t excl = fptc::block_exclusive_scan(v, warp_sums, &total);
    if (i < count) sums[i] = carry + excl;
    carry += total;
  }
}

__global__ void symlen_decode_words(
    const uint64_t* __restrict__ words, const uint8_t* __restrict__ symlen,
    const int32_t* __restrict__ local, const int32_t* __restrict__ block_base,
    int64_t num_words, const int32_t* __restrict__ dec_limit,
    const int32_t* __restrict__ dec_first, const int32_t* __restrict__ dec_rank,
    const int32_t* __restrict__ dec_syms, int l_max, int max_symlen,
    uint8_t* __restrict__ out, int64_t num_symbols) {
  __shared__ fptc::SymlenTables s_tab;
  fptc::load_symlen_tables(&s_tab, dec_limit, dec_first, dec_rank, dec_syms,
                           l_max);
  __syncthreads();

  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= num_words) return;
  const int count = min(static_cast<int>(symlen[w]), max_symlen);
  if (count == 0) return;
  const int64_t off =
      static_cast<int64_t>(local[w]) + block_base[w / kScanBlock];
  uint64_t cur = words[w];
  for (int j = 0; j < count; ++j) {
    const uint8_t sym = fptc::decode_step(cur, s_tab, l_max);
    const int64_t pos = off + j;
    if (pos < num_symbols) out[pos] = sym;
  }
}

}  // namespace

// words u64[num_words], symlen u8[num_words]; scratch: local i32[num_words],
// block_sums i32[ceil(num_words / 1024)]; out u8[num_symbols] zero-filled.
FPTC_EXPORT int fptc_symlen_decode(
    const void* words, const void* symlen, int64_t num_words, void* local,
    void* block_sums, const void* dec_limit, const void* dec_first,
    const void* dec_rank, const void* dec_syms, int64_t l_max,
    int64_t max_symlen, void* out, int64_t num_symbols, void* stream) {
  if (num_words <= 0 || num_symbols <= 0) return 0;
  if (l_max < 1 || l_max > fptc::kMaxLmax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t scan_blocks = (num_words + kScanBlock - 1) / kScanBlock;
  symlen_scan_local<<<static_cast<unsigned>(scan_blocks), kScanBlock, 0, s>>>(
      static_cast<const uint8_t*>(symlen), num_words,
      static_cast<int32_t*>(local), static_cast<int32_t*>(block_sums));
  FPTC_CHECK_LAUNCH();
  scan_block_sums<<<1, 1024, 0, s>>>(static_cast<int32_t*>(block_sums),
                                     scan_blocks);
  FPTC_CHECK_LAUNCH();
  const int64_t decode_blocks = (num_words + kDecodeBlock - 1) / kDecodeBlock;
  symlen_decode_words<<<static_cast<unsigned>(decode_blocks), kDecodeBlock, 0,
                        s>>>(
      static_cast<const uint64_t*>(words), static_cast<const uint8_t*>(symlen),
      static_cast<const int32_t*>(local),
      static_cast<const int32_t*>(block_sums), num_words,
      static_cast<const int32_t*>(dec_limit),
      static_cast<const int32_t*>(dec_first),
      static_cast<const int32_t*>(dec_rank),
      static_cast<const int32_t*>(dec_syms), static_cast<int>(l_max),
      static_cast<int>(max_symlen), static_cast<uint8_t*>(out), num_symbols);
  FPTC_CHECK_LAUNCH();
  return 0;
}

FPTC_EXPORT const char* fptc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
