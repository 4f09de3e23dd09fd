// K4: the bucket encode — signal rows -> SymLen chunk parts — as two
// kernels in a row: encode_levels, then symlen_pack.
//
// Replaces repro/kernels/encode_fused.py::encode_fused (_kernel), the TPU
// kernel at encode_fused.py:283: DCT -> the exact quantize -> (container
// v3) predict_levels + zero-plane masks -> a (code, length) lookup -> the
// chunk-parallel greedy SymLen pack of repro/core/symlen.py::
// _pack_chunk_emit, one pallas_call per bucket.
//
// (a) encode_levels: signals f32[K, Wp * N] -> coded grid u8[K, Wp, E],
//     and under a v3 coding ncoded i32[K] plus, with zero planes, zrow
//     u8[K, Wp] and zcol u8[K, E].  One CTA per block of 128 windows of
//     one row: DCT + quantize (dct_quant.cuh, K5's template), then the
//     prediction against the previous one or two windows — the CTA
//     recomputes the two windows before its block (a halo; before window 0
//     the history is the virtual all-128 one), so blocks need nothing from
//     each other and the TPU kernel's whole-row residency is not needed.
//     zrow covers all Wp windows; zcol only the row's true windows (count
//     / E): each CTA ORs its nonzero bands and adds its kept windows into a
//     per-row scratch with atomics, and the row's last CTA to finish writes
//     zcol and ncoded = (true windows not in zrow) x (bands not in zcol).
//     encode_levels_gather is the same kernel with its rows read through
//     (flat, starts, lens) — the transcoder's decoded samples — in place of
//     a materialized f32[K, Wp * N] matrix: the staging masks each row at
//     its true length (a decoded signal's window tail is re-decoded data,
//     not zeros), so the signal matrix never makes a round trip through
//     device memory, as the TPU package fuses that gather into the same jit
//     as its pallas_call (batch_encode.py:371).  Its levels equal
//     encode_levels' on the gathered matrix bit for bit.
// (b) symlen_pack: grid + masks -> hi/lo u32[K, B, C], symlen i32[K, B, C],
//     words-per-chunk i32[K, B], bad u8[K].  One thread per chunk looks up
//     (code, length) in 256-entry tables in shared memory — this replaces
//     the TPU kernel's [cap, 256] one-hot matmul, its largest transient
//     (encode_fused.py:31-37) — and runs the greedy recurrence with an
//     O(1) carry: a word is flushed when bit_size + clen > 64, so no
//     codeword straddles a word, and each codeword is ORed into a native
//     64-bit word (the bits of different symbols are disjoint, so OR equals
//     the reference's segment sum).  Masked slots (padding, zero planes)
//     emit, advance and count nothing.  Slots past a chunk's word count
//     are zeroed cooperatively by the CTA (coalesced), as the reference
//     leaves them zero.  A valid symbol with no codeword (a histogram
//     gap: length 0, and code 0 in a canonical book) emits nothing, is
//     counted, and sets its row's bad flag, as in the reference.  In
//     exact mode (chunk = the row's symbol count) there is one chunk per
//     signal, and its walk is serial.
//
// What bounds it on the H100: bytes — the f32 signal read once, and the
// chunk parts written (12 bytes per symbol slot, most of them the zeros
// past each chunk's words); the grid between the two kernels adds one
// byte per cell written and read back.  The first design is latency bound
// instead: symlen_pack's threads walk 1024 symbols each in order, and
// encode_levels' CTAs stage, transform and store one block in turn.
//
// Where trouble is likely: the quantizer's rounding (dct_quant.cuh); the
// shift 64 - start - clen, which reaches 64 for clen == 0 (the reference's
// _shl32/_shr32 define a shift of 32 or more as 0; in CUDA it is undefined,
// so a zero-length code is never shifted); and the DCT's summation order,
// which differs from the plain version's cuBLAS product.
#include "dct_quant.cuh"

namespace {

constexpr int kLevelThreads = 256;
constexpr int kPackThreads = 64;

struct Coding {
  int pred_id;  // 0 none, 1 delta, 2 linear2
  int bands;    // predict_bands
  int zplanes;  // zero-plane suppression
};

// kGather: row r's samples are the run [starts[r], starts[r] + lens[r]) of
// the flat tensor `signals`, exact zero past lens[r]; otherwise row r is
// signals[r * wp * n, (r + 1) * wp * n).
template <bool kGather>
__global__ void __launch_bounds__(kLevelThreads)
    encode_levels_kernel(const float* __restrict__ signals,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ counts, int64_t wp,
                         int n, int e, int bw, const float* __restrict__ basis,
                         fptc::QuantArgs q, Coding coding,
                         uint8_t* __restrict__ grid, uint8_t* __restrict__ zrow,
                         uint8_t* __restrict__ zcol,
                         int32_t* __restrict__ ncoded,
                         int32_t* __restrict__ scratch) {
  extern __shared__ float smem[];
  float* s_basis = smem;                               // [N, E]
  float* s_quant = s_basis + n * e;                    // the quant table
  float* s_x = s_quant + fptc::quant_table_floats(e);  // [bw + 2, N + 1]
  int* s_nz = reinterpret_cast<int*>(s_x + (bw + 2) * (n + 1));  // [E]
  int* s_keep = s_nz + e;                                        // [1]
  uint8_t* s_lv = reinterpret_cast<uint8_t*>(s_keep + 1);  // [bw + 2, E]
  uint8_t* s_g = s_lv + (bw + 2) * e;                      // [bw, E]

  const int64_t row = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * bw;
  const int rows = static_cast<int>(min(static_cast<int64_t>(bw), wp - w0));
  const int64_t nvalid = counts[row] / e;  // the row's true windows
  const bool predict = coding.pred_id != 0 && coding.bands > 0;
  // the windows before the block that the prediction reads, recomputed
  // here (before window 0 the history is the virtual all-128 one)
  const int halo = predict ? static_cast<int>(min(static_cast<int64_t>(2),
                                                  w0))
                           : 0;
  for (int i = threadIdx.x; i < n * e; i += blockDim.x) s_basis[i] = basis[i];
  fptc::stage_quant(s_quant, q, e);
  for (int i = threadIdx.x; i < 2 * e; i += blockDim.x) s_lv[i] = 128;
  for (int i = threadIdx.x; i < e; i += blockDim.x) s_nz[i] = 0;
  if (threadIdx.x == 0) *s_keep = 0;
  if constexpr (kGather) {
    fptc::stage_windows_gather(s_x, signals + starts[row], lens[row],
                               (w0 - halo) * n, rows + halo, n);
  } else {
    fptc::stage_windows(s_x, signals + (row * wp + w0 - halo) * n,
                        rows + halo, n);
  }
  __syncthreads();
  // s_lv row 2 + j holds window w0 + j (j from -halo)
  uint8_t* s_lv0 = s_lv + (2 - halo) * e;
  fptc::dct_quant_block(s_x, rows + halo, n, e, s_basis, s_quant,
                        [&](int w, int k, uint8_t level) {
                          s_lv0[w * e + k] = level;
                        });
  __syncthreads();
  // the v3 prediction: residuals mod 256 against the previous window
  // (delta) or 2 * prev - prev2 (linear2) on bands k < predict_bands
  uint8_t* g_out = grid + (row * wp + w0) * e;
  for (int i = threadIdx.x; i < rows * e; i += blockDim.x) {
    const int w = i / e;
    const int k = i - w * e;
    const int lv = s_lv[(w + 2) * e + k];
    int g = lv;
    if (predict && k < coding.bands) {
      const int p1 = s_lv[(w + 1) * e + k];
      const int pred = coding.pred_id == 1 ? p1 : 2 * p1 - s_lv[w * e + k];
      g = (lv - pred + 128) & 255;
    }
    s_g[i] = static_cast<uint8_t>(g);
    g_out[i] = static_cast<uint8_t>(g);
  }
  if (!coding.zplanes) {
    if (ncoded != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      ncoded[row] = counts[row];
    }
    return;
  }
  __syncthreads();
  if (threadIdx.x < rows) {  // zrow over every window, padding included
    bool all = true;
    for (int k = 0; k < e; ++k) all = all && s_g[threadIdx.x * e + k] == 128;
    zrow[row * wp + w0 + threadIdx.x] = all ? 1 : 0;
    if (!all && w0 + threadIdx.x < nvalid) atomicAdd(s_keep, 1);
  }
  // zcol over the row's true windows only: a band is nonzero if any true
  // window of any block has a non-128 cell in it
  const int64_t live = min(static_cast<int64_t>(rows), nvalid - w0);
  for (int i = threadIdx.x; i < live * e; i += blockDim.x) {
    if (s_g[i] != 128) s_nz[i % e] = 1;
  }
  __syncthreads();
  // the row's totals in scratch [E + 2]: nonzero bands, kept windows, and
  // the count of finished blocks; the row's last block writes zcol, ncoded
  int32_t* acc = scratch + row * (e + 2);
  if (threadIdx.x < e && s_nz[threadIdx.x]) atomicOr(acc + threadIdx.x, 1);
  if (threadIdx.x == 0 && *s_keep) atomicAdd(acc + e, *s_keep);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_keep = atomicAdd(acc + e + 1, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!*s_keep) return;
  __threadfence();
  bool kept_col = false;
  if (threadIdx.x < e) {
    kept_col = atomicOr(acc + threadIdx.x, 0) != 0;
    zcol[row * e + threadIdx.x] = kept_col ? 0 : 1;
  }
  const int cols = __syncthreads_count(kept_col);
  if (threadIdx.x == 0) ncoded[row] = atomicAdd(acc + e, 0) * cols;
}

__global__ void __launch_bounds__(kPackThreads)
    symlen_pack_kernel(const uint8_t* __restrict__ grid,
                       const uint8_t* __restrict__ zrow,
                       const uint8_t* __restrict__ zcol,
                       const int32_t* __restrict__ counts, int64_t num_rows,
                       int64_t wp, int e, int64_t num_chunks, int64_t chunk,
                       int v3, const int64_t* __restrict__ codes,
                       const int32_t* __restrict__ lengths, int check_gaps,
                       uint32_t* __restrict__ hi, uint32_t* __restrict__ lo,
                       int32_t* __restrict__ sl, int32_t* __restrict__ wpc,
                       uint8_t* __restrict__ bad) {
  __shared__ uint32_t s_code[256];
  __shared__ int s_len[256];
  __shared__ int64_t s_words[kPackThreads];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_code[i] = static_cast<uint32_t>(codes[i]);
    s_len[i] = lengths[i];
  }
  __syncthreads();

  const int64_t total = num_rows * num_chunks;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t c = first + threadIdx.x;
  int64_t words = chunk;  // no chunk: nothing to zero
  if (c < total) {
    const int64_t row = c / num_chunks;
    const int64_t b = c - row * num_chunks;
    const int64_t sp = wp * e;
    const int64_t p0 = b * chunk;
    const int64_t p1 = min(p0 + chunk, sp);
    const int64_t count = counts[row];
    const int64_t nvalid = count / e;
    const uint8_t* g = grid + row * sp;
    const uint8_t* zr = zrow != nullptr ? zrow + row * wp : nullptr;
    const uint8_t* zc = zcol != nullptr ? zcol + row * e : nullptr;
    const int64_t base = c * chunk;
    uint64_t buf = 0;
    int bit = 0;
    int32_t cnt = 0;
    int64_t w_idx = 0;
    bool gap = false;
    int64_t w = p0 / e;
    int k = static_cast<int>(p0 - w * e);
    for (int64_t p = p0; p < p1; ++p) {
      bool valid;
      if (v3) {
        valid = w < nvalid && !(zr != nullptr && (zr[w] || zc[k]));
      } else {
        valid = p < count;
      }
      if (valid) {
        const int sym = g[p];
        const int clen = s_len[sym];
        gap = gap || clen == 0;
        if (bit + clen > 64) {  // flush: the codeword does not fit
          hi[base + w_idx] = static_cast<uint32_t>(buf >> 32);
          lo[base + w_idx] = static_cast<uint32_t>(buf);
          sl[base + w_idx] = cnt;
          ++w_idx;
          buf = 0;
          bit = 0;
          cnt = 0;
        }
        if (clen > 0) {  // shift in [0, 63]; a zero-length code adds nothing
          buf |= static_cast<uint64_t>(s_code[sym]) << (64 - bit - clen);
        }
        bit += clen;
        ++cnt;
      }
      if (++k == e) {
        k = 0;
        ++w;
      }
    }
    if (cnt > 0) {  // the last, partial word
      hi[base + w_idx] = static_cast<uint32_t>(buf >> 32);
      lo[base + w_idx] = static_cast<uint32_t>(buf);
      sl[base + w_idx] = cnt;
      ++w_idx;
    }
    wpc[c] = static_cast<int32_t>(w_idx);
    if (gap && check_gaps) bad[row] = 1;  // every writer stores the same 1
    words = w_idx;
  }
  s_words[threadIdx.x] = words;
  __syncthreads();
  // zero every slot past each chunk's words, the CTA's threads together
  for (int t = 0; t < blockDim.x && first + t < total; ++t) {
    const int64_t base = (first + t) * chunk;
    for (int64_t s = s_words[t] + threadIdx.x; s < chunk; s += blockDim.x) {
      hi[base + s] = 0;
      lo[base + s] = 0;
      sl[base + s] = 0;
    }
  }
}

size_t encode_levels_smem(int n, int e, int bw) {
  return sizeof(float) * (static_cast<size_t>(n) * e +
                          fptc::quant_table_floats(e) +
                          static_cast<size_t>(bw + 2) * (n + 1)) +
         sizeof(int) * (e + 1) + static_cast<size_t>(2 * bw + 2) * e;
}

template <bool kGather>
int launch_encode_levels(const void* signals, const void* starts,
                         const void* lens, const void* counts, int64_t k,
                         int64_t wp, int64_t n, int64_t e, const void* basis,
                         const void* zone, const void* scale, const void* mu,
                         const void* alpha1, int64_t pred_id, int64_t bands,
                         int64_t zplanes, void* grid, void* zrow, void* zcol,
                         void* ncoded, void* scratch, void* stream) {
  if (k <= 0 || wp <= 0) return 0;
  if (n < 1 || e < 1 || e > n || n > fptc::kDctMaxDim || k > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kGather && (starts == nullptr || lens == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (zplanes && (zrow == nullptr || zcol == nullptr || ncoded == nullptr ||
                  scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bw = 128;
  const size_t smem = encode_levels_smem(static_cast<int>(n),
                                         static_cast<int>(e), bw);
  cudaError_t err = fptc::allow_smem(
      reinterpret_cast<const void*>(encode_levels_kernel<kGather>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fptc::QuantArgs q{static_cast<const int32_t*>(zone),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(mu),
                    static_cast<const float*>(alpha1)};
  Coding coding{static_cast<int>(pred_id), static_cast<int>(bands),
                static_cast<int>(zplanes)};
  const dim3 blocks(static_cast<unsigned>((wp + bw - 1) / bw),
                    static_cast<unsigned>(k));
  encode_levels_kernel<kGather><<<blocks, kLevelThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signals), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(counts),
      wp, static_cast<int>(n), static_cast<int>(e), bw,
      static_cast<const float*>(basis), q, coding,
      static_cast<uint8_t*>(grid), static_cast<uint8_t*>(zrow),
      static_cast<uint8_t*>(zcol), static_cast<int32_t*>(ncoded),
      static_cast<int32_t*>(scratch));
  FPTC_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// signals f32[k, wp * n], counts i32[k], basis f32[n, e], zone i32[e],
// scale f32[e], mu f32[1], alpha1 f32[1] -> grid u8[k, wp, e]; with a v3
// coding also ncoded i32[k], and with zero planes zrow u8[k, wp] and
// zcol u8[k, e] (null pointers otherwise), which also need scratch
// i32[k, e + 2], zeroed by the caller.
FPTC_EXPORT int fptc_encode_levels(const void* signals, const void* counts,
                                   int64_t k, int64_t wp, int64_t n, int64_t e,
                                   const void* basis, const void* zone,
                                   const void* scale, const void* mu,
                                   const void* alpha1, int64_t pred_id,
                                   int64_t bands, int64_t zplanes, void* grid,
                                   void* zrow, void* zcol, void* ncoded,
                                   void* scratch, void* stream) {
  return launch_encode_levels<false>(
      signals, nullptr, nullptr, counts, k, wp, n, e, basis, zone, scale, mu,
      alpha1, pred_id, bands, zplanes, grid, zrow, zcol, ncoded, scratch,
      stream);
}

// encode_levels with its rows gathered from a flat sample tensor: row r is
// flat[starts[r], starts[r] + lens[r]) (starts, lens i32[k]) followed by
// exact zeros up to wp * n samples; the rest as fptc_encode_levels.  The
// levels equal fptc_encode_levels' on the materialized rows bit for bit.
FPTC_EXPORT int fptc_encode_levels_gather(
    const void* flat, const void* starts, const void* lens, const void* counts,
    int64_t k, int64_t wp, int64_t n, int64_t e, const void* basis,
    const void* zone, const void* scale, const void* mu, const void* alpha1,
    int64_t pred_id, int64_t bands, int64_t zplanes, void* grid, void* zrow,
    void* zcol, void* ncoded, void* scratch, void* stream) {
  return launch_encode_levels<true>(
      flat, starts, lens, counts, k, wp, n, e, basis, zone, scale, mu, alpha1,
      pred_id, bands, zplanes, grid, zrow, zcol, ncoded, scratch, stream);
}

// grid u8[k, wp, e], zrow u8[k, wp] / zcol u8[k, e] (null without zero
// planes), counts i32[k], codes i64[256] (uint32 codewords), lengths
// i32[256] -> hi/lo u32[k, num_chunks, chunk], symlen i32[k, num_chunks,
// chunk], wpc i32[k, num_chunks], bad u8[k] (zeroed by the caller).
FPTC_EXPORT int fptc_symlen_pack(const void* grid, const void* zrow,
                                 const void* zcol, const void* counts,
                                 int64_t k, int64_t wp, int64_t e,
                                 int64_t num_chunks, int64_t chunk, int64_t v3,
                                 const void* codes, const void* lengths,
                                 int64_t check_gaps, void* hi, void* lo,
                                 void* sl, void* wpc, void* bad,
                                 void* stream) {
  const int64_t total = k * num_chunks;
  if (total <= 0) return 0;
  if (e < 1 || chunk < 1 || wp < 1 || (zrow == nullptr) != (zcol == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (total + kPackThreads - 1) / kPackThreads;
  symlen_pack_kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<const uint8_t*>(zrow),
      static_cast<const uint8_t*>(zcol), static_cast<const int32_t*>(counts),
      k, wp, static_cast<int>(e), num_chunks, chunk, static_cast<int>(v3 != 0),
      static_cast<const int64_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<int>(check_gaps != 0), static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo), static_cast<int32_t*>(sl),
      static_cast<int32_t*>(wpc), static_cast<uint8_t*>(bad));
  FPTC_CHECK_LAUNCH();
  return 0;
}
