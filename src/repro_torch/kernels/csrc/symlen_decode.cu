// K1: word-parallel SymLen Huffman decode + exclusive-scan compaction.
//
// Replaces repro/kernels/huffman_decode.py::huffman_decode_dense (its
// _dense_kernel / decode_block_to_dense / _decode_slot), the TPU kernel at
// huffman_decode.py:297.  It computes what that kernel computes: word w
// decodes min(symlen[w], max_symlen) canonical-Huffman symbols MSB first
// and writes them at the exclusive prefix sum of the raw symlen plus the
// slot; nothing at or past num_symbols is written, and every position no
// word writes (the gap a clamped word leaves, and the tail from the true
// symbol total to num_symbols) reads 0 — written here, so the output needs
// no zero fill before the call.
//
// What bounds it on the H100: its bytes set the least time (a word read
// once, 8 bytes and its 1-byte symlen, against about 9 output bytes), but
// it runs at the rate of its shared-memory traffic: a random 2-byte table
// read (about 3.5 bank wavefronts a warp) and a byte store into the stage
// for each symbol (measured by symlen_profile.py; PERF.md).  The TPU
// design's costs on this card were a long dependent chain per symbol (l_max
// compares and three table reads) and single-byte stores at scattered
// offsets.
//
// Design (two launches from one exported call):
//  1. symlen_reduce: the words split into segments of whole warp tiles
//     (kLaneWords consecutive words a lane, 32 lanes), one segment to each
//     warp of the decode; one warp per segment sums its raw symlen (1 byte
//     a word read), writing its sum and its CTA's, and the CTAs together
//     build the decode table of symlen_step.cuh into device memory, each a
//     share of its 2^l_max entries;
//  2. symlen_decode_tiles, launched as a programmatic dependent of 1 (its
//     launch overlaps 1's end): persistent CTAs.  A CTA stages the table
//     with cp.async, sums the CTAs before it and the warps before each of
//     its own for their bases, and zeroes its share of the tail past the
//     total.  Then each warp walks its own segment's tiles in order,
//     carrying its base, with no CTA barrier: a warp scan of the lanes'
//     counts for tile-local offsets (the next tile's words prefetched), each
//     lane decoding its words by table reads into the warp's shared-memory
//     stage, which holds the tile's output bytes at their 16-byte phase,
//     and the tile's run [base, base + tile sum) stored from the stage in
//     16-byte stores (single bytes at its ragged ends).  A tile whose run
//     outgrows the stage (words of more than kStageWordBytes symbols on
//     average) zeroes its run and stores its symbols directly.  Warps are
//     independent so that one warp's longest word holds back only its own
//     tile, not the CTA's.
// Against the TPU kernel it drops the running base carried in SMEM across
// the sequential grid (the segments' sums take its place), the (hi, lo)
// funnel shifts (native 64-bit words), the canonical compare chain and the
// one-hot [BW, 256] MXU lookup (one table read a symbol), and the
// overlapping row spill and re-zero of the TPU store (the stage is written
// once and stored once).
#include <mutex>

#include "symlen_step.cuh"

namespace {

constexpr int kThreads = 256;  // a CTA of the decode and of the reduce
constexpr int kWarps = kThreads / fptc::kWarp;
constexpr int kLaneWords = 4;  // consecutive words a lane
constexpr int kTileWords = fptc::kWarp * kLaneWords;  // a warp tile
constexpr int kStageWordBytes = 16;  // a warp's stage: 16 bytes a word
constexpr int kStage = kTileWords * kStageWordBytes + 16;
// the workspace: the decode table (room for l_max = 16), then the
// segments' sums
constexpr size_t kLutRegion = size_t{2} << fptc::kMaxLmax;

struct DecodeTables {
  const int32_t* limit;
  const int32_t* first;
  const int32_t* rank;
  const int32_t* syms;
};

// Warp tiles [t0, t1) of segment s of n over `tiles`: contiguous, balanced.
__device__ __forceinline__ void segment_tiles(int64_t tiles, int64_t n,
                                              int64_t s, int64_t* t0,
                                              int64_t* t1) {
  const int64_t q = tiles / n, r = tiles % n;
  *t0 = s * q + (s < r ? s : r);
  *t1 = *t0 + q + (s < r ? 1 : 0);
}

// Store bytes [lo, hi) of `out` by `n` threads (this one `t` of them):
// from `src`, where byte g is src[g - sbase] and lies at the same 16-byte
// phase as out + g, or zeros where src is null.  16-byte stores between
// the first and the last 16-byte boundary, single bytes outside them.
__device__ __forceinline__ void store_run(uint8_t* __restrict__ out,
                                          int64_t lo, int64_t hi,
                                          const uint8_t* src, int64_t sbase,
                                          int t, int n) {
  if (lo >= hi) return;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int64_t a = lo + static_cast<int64_t>((16 - ((o + lo) & 15)) & 15);
  if (a > hi) a = hi;
  int64_t b = hi - static_cast<int64_t>((o + hi) & 15);
  if (b < a) b = a;
  const int head = static_cast<int>(a - lo);
  const int ends = head + static_cast<int>(hi - b);
  for (int i = t; i < ends; i += n) {
    const int64_t g = i < head ? lo + i : b + (i - head);
    out[g] = src ? src[g - sbase] : 0;
  }
  const int64_t units = (b - a) >> 4;
  for (int64_t u = t; u < units; u += n) {
    const int64_t g = a + 16 * u;
    const uint4 v = src ? *reinterpret_cast<const uint4*>(src + (g - sbase))
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(out + g) = v;
  }
}

// Kernel 1: each warp's segment sum into sums[seg], each CTA's into
// cta_sums[c].  sums may be null: then only the table is built (the decode
// table on its own, for the tests).
__global__ void __launch_bounds__(kThreads)
    symlen_reduce(const uint8_t* __restrict__ symlen, int64_t num_words,
                  int64_t tiles, int64_t* __restrict__ cta_sums,
                  int64_t* __restrict__ sums, DecodeTables dt, int l_max,
                  uint16_t* __restrict__ lut) {
  __shared__ fptc::SymlenTables tab;
  __shared__ int64_t warp_sums[kWarps];
  // the decode kernel may start launching; it waits for this grid to end
  // before it reads what this one writes
  asm volatile("griddepcontrol.launch_dependents;");
  fptc::load_symlen_tables(&tab, dt.limit, dt.first, dt.rank, dt.syms, l_max);
  __syncthreads();
  fptc::build_lut(lut, tab, l_max,
                  static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                  static_cast<int64_t>(gridDim.x) * blockDim.x);
  if (sums == nullptr) return;
  const int lane = threadIdx.x & 31;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / fptc::kWarp;
  int64_t t0, t1;
  segment_tiles(tiles, static_cast<int64_t>(gridDim.x) * kWarps, seg, &t0,
                &t1);
  const int64_t w0 = t0 * kTileWords;
  const int64_t w1 = max(w0, min(t1 * kTileWords, num_words));  // [w0, w1)
  int64_t s = 0;
  if ((reinterpret_cast<uintptr_t>(symlen) & 15) == 0) {
    // 16 bytes a lane (a segment starts at a multiple of kTileWords)
    const int64_t v1 = w0 + ((w1 - w0) & ~int64_t{15});
    for (int64_t w = w0 + 16 * lane; w < v1; w += 16 * fptc::kWarp) {
      const uint4 q = *reinterpret_cast<const uint4*>(symlen + w);
      const uint32_t xs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // the 4 bytes of xs[k], in pairs
        const uint32_t pairs =
            (xs[k] & 0x00ff00ffu) + ((xs[k] >> 8) & 0x00ff00ffu);
        s += (pairs & 0xffffu) + (pairs >> 16);
      }
    }
    for (int64_t w = v1 + lane; w < w1; w += fptc::kWarp) s += symlen[w];
  } else {
#pragma unroll 8
    for (int64_t w = w0 + lane; w < w1; w += fptc::kWarp) s += symlen[w];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) {
    sums[seg] = s;
    warp_sums[threadIdx.x / fptc::kWarp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t c = 0;
    for (int i = 0; i < kWarps; ++i) c += warp_sums[i];
    cta_sums[blockIdx.x] = c;
  }
}

// Copy the table kernel 1 built into shared memory (committed as one
// cp.async group; the caller waits for it).
__device__ __forceinline__ void stage_lut(uint16_t* s_lut,
                                          const uint16_t* __restrict__ g_lut,
                                          int l_max) {
  const int bytes = 2 << l_max;
  if (bytes >= 16) {
    const uint8_t* g = reinterpret_cast<const uint8_t*>(g_lut);
    uint8_t* s = reinterpret_cast<uint8_t*>(s_lut);
    for (int i = 16 * threadIdx.x; i < bytes; i += 16 * blockDim.x) {
      fptc::cp_async16(s + i, g + i, 16);
    }
  } else if (static_cast<int>(threadIdx.x) < (1 << l_max)) {
    s_lut[threadIdx.x] = g_lut[threadIdx.x];
  }
  fptc::cp_async_commit();
}

// A lane's words of a warp tile and their symlen, read once (streamed
// past the caches); zeros past num_words.
struct LaneWords {
  uint64_t word[kLaneWords];
  int v[kLaneWords];
};

__device__ __forceinline__ void load_lane(const uint64_t* __restrict__ words,
                                          const uint8_t* __restrict__ symlen,
                                          int64_t w, int64_t num_words,
                                          LaneWords* x) {
  const auto* src = reinterpret_cast<const unsigned long long*>(words);
#pragma unroll
  for (int i = 0; i < kLaneWords; ++i) {
    const bool in = w + i < num_words;
    x->word[i] = in ? __ldcs(src + w + i) : 0;
    x->v[i] = in ? symlen[w + i] : 0;
  }
}

// Kernel 2, one warp per segment of kernel 1.
__global__ void __launch_bounds__(kThreads, 4)
    symlen_decode_tiles(const uint64_t* __restrict__ words,
                        const uint8_t* __restrict__ symlen, int64_t num_words,
                        int64_t tiles, const int64_t* __restrict__ cta_sums,
                        const int64_t* __restrict__ sums,
                        const uint16_t* __restrict__ g_lut, int l_max,
                        int max_symlen,
                        uint8_t* __restrict__ out, int64_t num_symbols) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  __shared__ int64_t warp_red[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid / fptc::kWarp;
  uint8_t* stage = smem + fptc::lut_bytes(l_max) + warp * kStage;
  const int64_t segs = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps;

  // kernel 1 wrote the table and the sums (launched as its dependent, this
  // grid may start before that one ends)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  stage_lut(s_lut, g_lut, l_max);
  // the symbols of the CTAs before this one, and the total
  int64_t before = 0, total = 0;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += kThreads) {
    const int64_t v = cta_sums[i];
    total += v;
    if (i < static_cast<int>(blockIdx.x)) before += v;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_xor_sync(0xffffffffu, before, d);
    total += __shfl_xor_sync(0xffffffffu, total, d);
  }
  if (lane == 0) {
    warp_red[0][warp] = before;
    warp_red[1][warp] = total;
  }
  __syncthreads();
  before = total = 0;
  for (int i = 0; i < kWarps; ++i) {
    before += warp_red[0][i];
    total += warp_red[1][i];
  }
  // this CTA's share of the zero tail [total, num_symbols)
  if (total < num_symbols) {
    const int64_t piece =
        static_cast<int64_t>(fptc::align16(static_cast<size_t>(
            (num_symbols - total + gridDim.x - 1) / gridDim.x)));
    const int64_t lo = total + piece * blockIdx.x;
    store_run(out, lo, min(lo + piece, num_symbols), nullptr, 0, tid,
              kThreads);
  }
  // this warp's base: the segments of the CTA's warps before it
  int64_t base = lane < warp ? sums[first + lane] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    base += __shfl_xor_sync(0xffffffffu, base, d);
  }
  base += before;
  fptc::cp_async_wait_all();
  __syncthreads();

  const int shift = 64 - l_max;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int64_t t0, t1;
  segment_tiles(tiles, segs, first + warp, &t0, &t1);
  LaneWords x;
  int64_t w = t0 * kTileWords + lane * kLaneWords;
  if (t0 < t1) load_lane(words, symlen, w, num_words, &x);
  for (int64_t t = t0; t < t1; ++t) {
    LaneWords cur = x;  // the next tile's words, in flight while it decodes
    w += kTileWords;
    if (t + 1 < t1) load_lane(words, symlen, w, num_words, &x);
    int32_t lane_sum = 0;
#pragma unroll
    for (int i = 0; i < kLaneWords; ++i) lane_sum += cur.v[i];
    int32_t local = lane_sum;  // inclusive warp scan of the lanes' counts
#pragma unroll
    for (int d = 1; d < fptc::kWarp; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, local, d);
      if (lane >= d) local += y;
    }
    const int32_t tile_sum = __shfl_sync(0xffffffffu, local, 31);
    local -= lane_sum;
    if (base < num_symbols) {  // uniform across the warp
      const int64_t end = min(base + tile_sum, num_symbols);
      const bool staged = tile_sum <= kStage - 16;
      // the stage holds byte g at sp + (g - base): the output's 16-byte
      // phase
      uint8_t* sp = stage + ((o + base) & 15);
#pragma unroll
      for (int i = 0; i < kLaneWords; ++i) {
        const bool live = base + local < num_symbols;
        const int cnt = live ? min(cur.v[i], max_symlen) : 0;
        uint64_t bits = cur.word[i];
        if (staged) {
          uint8_t* dst = sp + local;
          int j = 0;
          for (; j < cnt; ++j) dst[j] = fptc::lut_step(bits, s_lut, shift);
          for (const int n = live ? cur.v[i] : 0; j < n; ++j) dst[j] = 0;
        } else {
          if (i == 0) {
            store_run(out, base, end, nullptr, 0, lane, fptc::kWarp);
            __syncwarp();
          }
          for (int j = 0; j < cnt; ++j) {
            const uint8_t sym = fptc::lut_step(bits, s_lut, shift);
            const int64_t pos = base + local + j;
            if (pos < num_symbols) out[pos] = sym;
          }
        }
        local += cur.v[i];
      }
      __syncwarp();
      if (staged) {
        store_run(out, base, end, sp, base, lane, fptc::kWarp);
        __syncwarp();  // the stage is read before the next tile writes it
      }
    }
    base += tile_sum;
  }
}

DecodeTables decode_tables(const void* dec_limit, const void* dec_first,
                           const void* dec_rank, const void* dec_syms) {
  return DecodeTables{static_cast<const int32_t*>(dec_limit),
                      static_cast<const int32_t*>(dec_first),
                      static_cast<const int32_t*>(dec_rank),
                      static_cast<const int32_t*>(dec_syms)};
}

}  // namespace

// words u64[num_words], symlen u8[num_words], the decode tables (int32 bit
// patterns) -> out u8[num_symbols], every byte written.  workspace: device
// scratch of workspace_bytes (16-byte aligned; at least the table region
// and 8 bytes a CTA and a warp of one CTA), reused across calls on one
// stream.  The two launches of a call are enqueued as one unit, so calls
// from several host threads on one stream do not interleave between them
// (the second kernel reads what the first wrote into the workspace).
FPTC_EXPORT int fptc_symlen_decode(
    const void* words, const void* symlen, int64_t num_words,
    const void* dec_limit, const void* dec_first, const void* dec_rank,
    const void* dec_syms, int64_t l_max, int64_t max_symlen, void* workspace,
    int64_t workspace_bytes, void* out, int64_t num_symbols, void* stream) {
  if (num_symbols <= 0) return 0;
  if (l_max < 1 || l_max > fptc::kMaxLmax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_words <= 0) {
    cudaError_t err = cudaMemsetAsync(out, 0, num_symbols, s);
    return static_cast<int>(err);
  }
  // CTAs whose sums (one a CTA, one a warp) fit the workspace
  const int64_t room = (workspace_bytes - static_cast<int64_t>(kLutRegion)) /
                       (8 * (kWarps + 1));
  if (room < 1) return static_cast<int>(cudaErrorInvalidValue);
  // a word writes min(symlen, max_symlen) symbols, and symlen < 256
  const int ms = static_cast<int>(
      max_symlen < 0 ? 0 : max_symlen < 255 ? max_symlen : 255);
  const size_t smem =
      fptc::lut_bytes(static_cast<int>(l_max)) + size_t{kWarps} * kStage;
  int64_t resident = 0;
  cudaError_t err = fptc::cached_resident_ctas(
      reinterpret_cast<const void*>(symlen_decode_tiles), kThreads, smem,
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (num_words + kTileWords - 1) / kTileWords;
  int64_t g = (tiles + kWarps - 1) / kWarps;
  if (g > resident) g = resident;
  if (g > room) g = room;
  auto* lut = static_cast<uint16_t*>(workspace);
  auto* cta_sums = reinterpret_cast<int64_t*>(
      static_cast<uint8_t*>(workspace) + kLutRegion);
  int64_t* sums = cta_sums + g;
  const DecodeTables dt = decode_tables(dec_limit, dec_first, dec_rank,
                                        dec_syms);
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  symlen_reduce<<<static_cast<unsigned>(g), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(symlen), num_words, tiles, cta_sums, sums,
      dt, static_cast<int>(l_max), lut);
  FPTC_CHECK_LAUNCH();
  // a programmatic dependent launch: its CTAs may start while kernel 1's
  // last ones run, and wait for its end at griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, symlen_decode_tiles, static_cast<const uint64_t*>(words),
      static_cast<const uint8_t*>(symlen), num_words, tiles,
      static_cast<const int64_t*>(cta_sums), static_cast<const int64_t*>(sums),
      static_cast<const uint16_t*>(lut), static_cast<int>(l_max), ms,
      static_cast<uint8_t*>(out), num_symbols);
  if (err != cudaSuccess) return static_cast<int>(err);
  FPTC_CHECK_LAUNCH();
  return 0;
}

// The decode table alone, built on the device by kernel 1: out
// u16[2^l_max], entry p the symbol (bits 0-7) and length (bits 8-15) of
// prefix p.
FPTC_EXPORT int fptc_symlen_lut(const void* dec_limit, const void* dec_first,
                                const void* dec_rank, const void* dec_syms,
                                int64_t l_max, void* out, void* stream) {
  if (l_max < 1 || l_max > fptc::kMaxLmax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = ((int64_t{1} << l_max) + kThreads - 1) / kThreads;
  symlen_reduce<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      nullptr, 0, 0, nullptr, nullptr,
      decode_tables(dec_limit, dec_first, dec_rank, dec_syms),
      static_cast<int>(l_max), static_cast<uint16_t*>(out));
  FPTC_CHECK_LAUNCH();
  return 0;
}

FPTC_EXPORT const char* fptc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
