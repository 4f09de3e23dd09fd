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
//     u8[K, Wp] and zcol u8[K, E]: levels_kernel of dct_quant.cuh (K5
//     runs it too).  Persistent CTAs walk contiguous ranges of (row, block
//     of bw windows) tiles: the basis and quant table staged once a CTA,
//     each tile copied by cp.async while the one before is transformed in
//     RW x 4 register tiles (the pick, bw x RW: 128 x 4 at E = 32,
//     256 x 4 at E = 16, 256 x 2 at E = 8 and 6; the tuning cache may force
//     another RW the buffers hold), quantized a band at a time, then
//     the prediction against the previous one or two windows.  A tile's
//     history (the two windows before its block; before window 0 the
//     virtual all-128 one) is the tile before's last levels, carried in
//     shared memory; only a CTA's first tile recomputes it, by the same
//     chain, so tiles need no order among CTAs and the TPU kernel's
//     whole-row residency is not needed.  The grid bytes are written 16 a
//     store where aligned, single bytes at the tile's edges.  zrow covers
//     all Wp windows; zcol only the row's true windows (count / E): a CTA
//     ORs the nonzero bands and counts the kept windows of its run of a
//     row's tiles, adds them into the row's scratch with atomics once, and
//     the CTA that finishes the row's last tiles writes zcol and ncoded =
//     (true windows not in zrow) x (bands not in zcol).
//     encode_levels_gather is the same kernel with its rows read through
//     (flat, starts, lens) — the transcoder's decoded samples — in place of
//     a materialized f32[K, Wp * N] matrix: the copies zero-fill each row
//     at its true length (cp.async's src-size; a decoded signal's window
//     tail is re-decoded data, not zeros, and is never read), so the signal
//     matrix never makes a round trip through device memory, as the TPU
//     package fuses that gather into the same jit as its pallas_call
//     (batch_encode.py:371).  Its levels equal encode_levels' on the
//     gathered matrix bit for bit.  dct_quant.cuh says which copies are 16
//     bytes wide and which 4.
// (b) symlen_pack: grid + masks -> hi/lo u32[K, B, C], symlen i32[K, B, C],
//     words-per-chunk i32[K, B], bad u8[K].  One CTA of one warp per
//     chunk walks the chunk in tiles of 256 symbols, 8 consecutive symbols
//     a lane.  Per tile: the grid bytes are read 8 to a load (the next
//     tile's load in flight), each slot's validity comes from count (v2)
//     or its window's zrow and its band's zcol (v3), and its code length
//     from a 256-entry table in shared memory — this replaces the TPU
//     kernel's [cap, 256] one-hot matmul, its largest transient
//     (encode_fused.py:31-37); masked slots get length 0.  A warp scan of
//     the lengths gives each slot its bit offset P.  The greedy rule (flush
//     when bit_size + clen > 64, so no codeword straddles a word) is a
//     chain: a word opened at slot s flushes at the first j > s with
//     P[j] + clen[j] > P[s] + 64.  The warp follows it 32 slots at a time:
//     each lane holds one slot's end offset (read without bank conflicts),
//     and a ballot against the open word's limit, its lowest bit and a
//     shuffle of that slot's start offset give each flush in turn, one
//     step a word.  Warp scans of the start flags and of the last start's
//     offset give each slot its word and its bit in it, P - P[start].  A
//     lane builds the words that start and end in its slots in registers
//     (the bits of different symbols are disjoint, so OR equals the
//     reference's segment sum); the parts of words that cross lanes are
//     joined by a segmented OR scan over the warp, so each word has one
//     writer and shared memory needs no atomics.  Masked slots emit,
//     advance and count nothing.  The finished words are written
//     coalesced; the last, open word (its bits, bit count, symbol count
//     and index) is carried in registers to the next tile of the same
//     chunk, which is how exact mode (chunk = the row's symbol count, one
//     CTA per row) walks its row.  Slots past a chunk's word count are
//     zeroed 16 bytes a store, as the reference leaves them zero.  A valid
//     symbol with no codeword (a histogram gap: length 0, and code 0 in a
//     canonical book) emits nothing, is counted in its word, and sets its
//     row's bad flag, as in the reference.  No block barrier is needed,
//     and at 5.3 KiB of shared memory and 64 registers an SM holds 32
//     such CTAs, so 32 chains are walked at once.
//
// What bounds K4 on the H100: bytes — the f32 signal read once, and the
// chunk parts written (12 bytes per symbol slot, most of them the zeros
// past each chunk's words); the grid between the two kernels adds one
// byte per cell written and read back.  encode_levels is bound by its
// bytes at E <= 8 and by its arithmetic at E >= 16: the quantizer (two
// IEEE divisions and a log1pf an output in zone 0) and the FMAs take
// longer than the bytes there, and the next tile's copies are in flight
// while they run (dct_quant.cuh).  symlen_pack is
// bound by its instructions and their latency, not by its bytes (leaving
// out every store saves little on the H100): the chain walk, one
// dependent ballot and shuffle a word, takes about half of a tile's time,
// and 64 registers a lane cap the SM at 32 warps to hide it.
//
// Where trouble is likely: the quantizer's rounding (dct_quant.cuh); the
// shift 64 - start - clen, which reaches 64 for clen == 0 (the reference's
// _shl32/_shr32 define a shift of 32 or more as 0; in CUDA it is undefined,
// so a zero-length code is never shifted); and the DCT's summation order,
// which differs from the plain version's cuBLAS product.
#include <climits>

#include "dct_quant.cuh"

namespace {

constexpr int kPackPer = 8;  // consecutive symbols a lane
constexpr int kPackTile = fptc::kWarp * kPackPer;

// Up to 8 grid bytes at src (those at i >= n read as 0), one 8-byte load
// when they are all in range and aligned.
__device__ __forceinline__ unsigned long long load_bytes(const uint8_t* src,
                                                         int n) {
  if (n >= kPackPer && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    return __ldg(reinterpret_cast<const unsigned long long*>(src));
  }
  unsigned long long v = 0;
  for (int j = 0; j < min(n, kPackPer); ++j) {
    v |= static_cast<unsigned long long>(src[j]) << (8 * j);
  }
  return v;
}

// Zero [from, to) of the three part rows, the lanes together, 16 bytes a
// store where the rows line up.
__device__ __forceinline__ void zero_parts(uint32_t* a, uint32_t* b,
                                           int32_t* c, int64_t from,
                                           int64_t to, int lane) {
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(a + from) >> 2) & 3;
  int64_t mid = min(to, from + static_cast<int64_t>((4 - mis) & 3));
  if ((((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) |
        (reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(c))) &
       15) != 0) {
    mid = to;  // the rows do not line up: all scalar
  }
  for (int64_t s = from + lane; s < mid; s += fptc::kWarp) {
    a[s] = 0u;
    b[s] = 0u;
    c[s] = 0;
  }
  const int64_t quads = (to - mid) / 4;
  const int4 z = make_int4(0, 0, 0, 0);
  for (int64_t q = lane; q < quads; q += fptc::kWarp) {
    reinterpret_cast<int4*>(a + mid)[q] = z;
    reinterpret_cast<int4*>(b + mid)[q] = z;
    reinterpret_cast<int4*>(c + mid)[q] = z;
  }
  for (int64_t s = mid + 4 * quads + lane; s < to; s += fptc::kWarp) {
    a[s] = 0u;
    b[s] = 0u;
    c[s] = 0;
  }
}

// 32 one-warp CTAs an SM (the block limit), so at most 64 registers
__global__ void __launch_bounds__(fptc::kWarp, 32)
    symlen_pack_kernel(const uint8_t* __restrict__ grid,
                       const uint8_t* __restrict__ zrow,
                       const uint8_t* __restrict__ zcol,
                       const int32_t* __restrict__ counts, int64_t wp, int e,
                       int64_t num_chunks, int64_t chunk, int v3,
                       const int64_t* __restrict__ codes,
                       const int32_t* __restrict__ lengths, int check_gaps,
                       uint32_t* __restrict__ hi, uint32_t* __restrict__ lo,
                       int32_t* __restrict__ sl, int32_t* __restrict__ wpc,
                       uint8_t* __restrict__ bad) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ uint32_t s_code[256];
  __shared__ uint8_t s_len[256];
  __shared__ __align__(16) int32_t s_inc[kPackTile];  // inclusive bit prefix
  __shared__ uint32_t s_starts[kPackTile / fptc::kWarp];  // per 32 slots
  __shared__ uint32_t s_hi[kPackTile + 1];  // [h]: word h's bits 63..32
  __shared__ uint32_t s_lo[kPackTile + 1];  // [h]: word h's bits 31..0
  __shared__ int32_t s_cnt[kPackTile + 1];  // [h]: word h's valid symbols
  const int lane = threadIdx.x;
  for (int i = lane; i < 256; i += fptc::kWarp) {
    s_code[i] = static_cast<uint32_t>(codes[i]);
    s_len[i] = static_cast<uint8_t>(lengths[i]);
  }
  __syncwarp();

  const int64_t c = blockIdx.x;  // one CTA (one warp) per (row, chunk)
  const int64_t row = c / num_chunks;
  const int64_t sp = wp * e;
  const int64_t p0 = (c - row * num_chunks) * chunk;
  const int64_t p1 = min(p0 + chunk, sp);
  const int64_t count = counts[row];
  const int64_t nvalid = count / e;
  const uint8_t* g = grid + row * sp;
  const uint8_t* zr = zrow != nullptr ? zrow + row * wp : nullptr;
  const uint8_t* zc = zcol != nullptr ? zcol + row * e : nullptr;
  uint32_t* o_hi = hi + c * chunk;
  uint32_t* o_lo = lo + c * chunk;
  int32_t* o_sl = sl + c * chunk;
  const int i0 = lane * kPackPer;  // the lane's first tile slot

  // the open word, carried from tile to tile: its bits, its bit count,
  // its valid symbols and its index in the chunk
  unsigned long long buf = 0;
  int bit = 0;
  int cnt = 0;
  int64_t w_open = 0;
  bool gap = false;
  unsigned long long ahead = load_bytes(
      g + p0 + i0, static_cast<int>(min(static_cast<int64_t>(kPackTile),
                                        p1 - p0)) - i0);
  for (int64_t t0 = p0; t0 < p1; t0 += kPackTile) {
    const int n = static_cast<int>(min(static_cast<int64_t>(kPackTile),
                                       p1 - t0));
    // (1) the lane's slots: grid bytes (the next tile's load in flight),
    // validity, code lengths
    const unsigned long long syms = ahead;
    if (t0 + kPackTile < p1) {
      ahead = load_bytes(g + t0 + kPackTile + i0,
                         static_cast<int>(min(static_cast<int64_t>(kPackTile),
                                              p1 - t0 - kPackTile)) - i0);
    }
    unsigned valid = 0;  // bit j: slot i0 + j enters the stream
    const int64_t p = t0 + i0;
    if (v3) {  // a true window outside zrow, a band outside zcol
      int64_t w = p / e;
      int k = static_cast<int>(p - w * e);
      bool live = i0 < n && w < nvalid && (zr == nullptr || !zr[w]);
#pragma unroll
      for (int j = 0; j < kPackPer; ++j) {
        if (live && i0 + j < n && (zc == nullptr || !zc[k])) valid |= 1u << j;
        if (++k == e) {
          k = 0;
          ++w;
          live = i0 + j + 1 < n && w < nvalid && (zr == nullptr || !zr[w]);
        }
      }
    } else {  // the slots before min(n, count - t0)
      const int64_t lim = min(static_cast<int64_t>(n), count - t0) - i0;
      valid = lim >= kPackPer ? 255u
              : lim > 0 ? (1u << lim) - 1u : 0u;
    }
    // (2) bit offsets: P[j] is slot i0 + j's offset in the tile (masked
    // slots get length 0), by a warp scan of the lanes' sums
    int P[kPackPer + 1];
    P[0] = 0;
#pragma unroll
    for (int j = 0; j < kPackPer; ++j) {
      const int len = (valid >> j) & 1 ? s_len[(syms >> (8 * j)) & 255] : 0;
      gap = gap || ((valid >> j) & 1 && len == 0);
      P[j + 1] = P[j] + len;
    }
    int incl = P[kPackPer];
#pragma unroll
    for (int d = 1; d < fptc::kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(kAll, incl, fptc::kWarp - 1);
    const int excl = incl - P[kPackPer];
#pragma unroll
    for (int j = 0; j <= kPackPer; ++j) P[j] += excl;
    reinterpret_cast<int4*>(s_inc + i0)[0] = make_int4(P[1], P[2], P[3], P[4]);
    reinterpret_cast<int4*>(s_inc + i0)[1] = make_int4(P[5], P[6], P[7], P[8]);
    __syncwarp();
    // (3) the word starts: from the open word (its start `bit` bits before
    // the tile), a word opened at slot s flushes at the first slot whose
    // codeword ends past P[s] + 64 bits.  The warp reads 32 slots' end
    // offsets at a time and finds every flush among them from registers:
    // a ballot of the slots that would end past the open word's limit,
    // its lowest bit, and the flush's start offset from that lane
    {
      int base = -bit;
#pragma unroll
      for (int r = 0; r < kPackTile / fptc::kWarp; ++r) {
        const int j = r * fptc::kWarp + lane;
        const int reach = j < n ? s_inc[j] - 64 : INT_MIN;  // flush if > base
        const int begin = j > 0 && j <= n ? s_inc[j - 1] : 0;
        unsigned starts = 0;
        unsigned over = __ballot_sync(kAll, reach > base);
        while (over != 0) {
          const unsigned first = over & (0u - over);
          starts |= first;
          base = __shfl_sync(kAll, begin, __popc(first - 1u));
          over = __ballot_sync(kAll, reach > base) & ~(2u * first - 1u);
        }
        if (lane == 0) s_starts[r] = starts;
      }
    }
    __syncwarp();
    // (4) each slot's word (0: the open one) and its word's start offset,
    // by warp scans of the start counts and of the last start's offset
    const unsigned flags = (s_starts[lane / 4] >> (8 * (lane % 4))) & 255u;
    int last = -bit;  // the open word's start, before any start here
#pragma unroll
    for (int j = 0; j < kPackPer; ++j) {
      if ((flags >> j) & 1) last = P[j];
    }
    const int mine = __popc(flags);
    int h = mine;
    int base = last;  // offsets never fall: max is the last start's
#pragma unroll
    for (int d = 1; d < fptc::kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kAll, h, d);
      const int b = __shfl_up_sync(kAll, base, d);
      if (lane >= d) {
        h += y;
        base = max(base, b);
      }
    }
    const int nst = __shfl_sync(kAll, h, fptc::kWarp - 1);
    const int last_base = __shfl_sync(kAll, base, fptc::kWarp - 1);
    h -= mine;
    const int h0 = h;
    base = __shfl_up_sync(kAll, base, 1);
    if (lane == 0) base = -bit;
    // the lane's codewords: a word that starts and ends in the lane is
    // stored whole; the part before its first start (head) and from its
    // last start (tail) join their neighbours' by a segmented scan
    unsigned long long acc = 0;
    unsigned long long head = 0;
    int acnt = 0;
    int hcnt = 0;
#pragma unroll
    for (int j = 0; j < kPackPer; ++j) {
      if ((flags >> j) & 1) {
        if (h > h0) {  // word h started in this lane
          s_hi[h] = static_cast<uint32_t>(acc >> 32);
          s_lo[h] = static_cast<uint32_t>(acc);
          s_cnt[h] = acnt;
        } else {
          head = acc;
          hcnt = acnt;
        }
        ++h;
        base = P[j];
        acc = 0;
        acnt = 0;
      }
      if ((valid >> j) & 1) {
        const int len = P[j + 1] - P[j];
        if (len > 0) {  // shift in [0, 63]; a zero-length code adds nothing
          acc |= static_cast<unsigned long long>(
                     s_code[(syms >> (8 * j)) & 255])
                 << (64 - (P[j] - base) - len);
        }
        ++acnt;
      }
    }
    // segmented OR scan of the tails, a segment from each lane with a
    // start: (flag << 30 | count, bits)
    constexpr int kFlag = 1 << 30;
    uint32_t thi = static_cast<uint32_t>(acc >> 32);
    uint32_t tlo = static_cast<uint32_t>(acc);
    int tcnt = acnt | (flags != 0 ? kFlag : 0);
#pragma unroll
    for (int d = 1; d < fptc::kWarp; d <<= 1) {
      const uint32_t yhi = __shfl_up_sync(kAll, thi, d);
      const uint32_t ylo = __shfl_up_sync(kAll, tlo, d);
      const int ycnt = __shfl_up_sync(kAll, tcnt, d);
      if (lane >= d && !(tcnt & kFlag)) {
        thi |= yhi;
        tlo |= ylo;
        tcnt += ycnt;  // takes the left flag too
      }
    }
    // the word the lane's first start closes: the tails since the last
    // start before the lane, the lane's head, and the carried open word
    uint32_t ehi = __shfl_up_sync(kAll, thi, 1);
    uint32_t elo = __shfl_up_sync(kAll, tlo, 1);
    int ecnt = __shfl_up_sync(kAll, tcnt, 1) & (kFlag - 1);
    if (lane == 0) {
      ehi = 0;
      elo = 0;
      ecnt = 0;
    }
    if (flags != 0) {
      ehi |= static_cast<uint32_t>(head >> 32);
      elo |= static_cast<uint32_t>(head);
      ecnt += hcnt;
      if (h0 == 0) {
        ehi |= static_cast<uint32_t>(buf >> 32);
        elo |= static_cast<uint32_t>(buf);
        ecnt += cnt;
      }
      s_hi[h0] = ehi;
      s_lo[h0] = elo;
      s_cnt[h0] = ecnt;
    }
    __syncwarp();
    // (5) words [0, nst) are finished (word 0 completes the open one);
    // word nst stays open
    for (int w = lane; w < nst; w += fptc::kWarp) {
      o_hi[w_open + w] = s_hi[w];
      o_lo[w_open + w] = s_lo[w];
      o_sl[w_open + w] = s_cnt[w];
    }
    // the tile's last word stays open: lane 31's scan holds its part here
    const unsigned long long word =
        static_cast<unsigned long long>(__shfl_sync(kAll, thi, fptc::kWarp - 1))
            << 32 |
        __shfl_sync(kAll, tlo, fptc::kWarp - 1);
    const int wcnt = __shfl_sync(kAll, tcnt, fptc::kWarp - 1) & (kFlag - 1);
    if (nst == 0) {
      buf |= word;
      cnt += wcnt;
      bit += total;
    } else {
      buf = word;
      cnt = wcnt;
      bit = total - last_base;
      w_open += nst;
    }
    __syncwarp();  // every lane has read the words before the next tile
  }
  // the open word, then zeros to the chunk's end
  const bool open = cnt > 0;  // false only if the chunk has no valid slot
  if (open && lane == 0) {
    o_hi[w_open] = static_cast<uint32_t>(buf >> 32);
    o_lo[w_open] = static_cast<uint32_t>(buf);
    o_sl[w_open] = cnt;
  }
  zero_parts(o_hi, o_lo, o_sl, w_open + open, chunk, lane);
  if (lane == 0) wpc[c] = static_cast<int32_t>(w_open + open);
  if (__any_sync(kAll, gap) && check_gaps && lane == 0) bad[row] = 1;
}

template <bool kGather>
int launch_encode_levels(const void* signals, const void* starts,
                         const void* lens, const void* counts, int64_t k,
                         int64_t wp, int64_t n, int64_t e, const void* basis,
                         const void* zone, const void* scale, const void* mu,
                         const void* alpha1, int64_t pred_id, int64_t bands,
                         int64_t zplanes, void* grid, void* zrow, void* zcol,
                         void* ncoded, void* scratch, int64_t rw,
                         void* stream) {
  if (n < 1 || e < 1 || e > n || n > fptc::kDctMaxDim || k > 65535 ||
      (rw != 0 && rw != 1 && rw != 2 && rw != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 0 || wp <= 0) return 0;
  if (kGather && (starts == nullptr || lens == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (zplanes && (zrow == nullptr || zcol == nullptr || ncoded == nullptr ||
                  scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fptc::launch_levels<kGather>(
      static_cast<const float*>(signals), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(counts),
      k, wp, static_cast<int>(n), static_cast<int>(e),
      static_cast<const float*>(basis),
      fptc::QuantArgs{static_cast<const int32_t*>(zone),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(mu),
                      static_cast<const float*>(alpha1)},
      fptc::Coding{static_cast<int>(pred_id), static_cast<int>(bands),
                   static_cast<int>(zplanes)},
      static_cast<uint8_t*>(grid), static_cast<uint8_t*>(zrow),
      static_cast<uint8_t*>(zcol), static_cast<int32_t*>(ncoded),
      static_cast<int32_t*>(scratch), static_cast<int>(rw),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// signals f32[k, wp * n], counts i32[k], basis f32[n, e], zone i32[e],
// scale f32[e], mu f32[1], alpha1 f32[1] -> grid u8[k, wp, e]; with a v3
// coding also ncoded i32[k], and with zero planes zrow u8[k, wp] and
// zcol u8[k, e] (null pointers otherwise), which also need scratch
// i32[k, e + 2], zeroed by the caller.  rw: the register tile's windows a
// thread, 0 to pick it (dct_tile_shape), 1, 2 or 4 to force it; a refused
// rw returns cudaErrorInvalidValue.
FPTC_EXPORT int fptc_encode_levels(const void* signals, const void* counts,
                                   int64_t k, int64_t wp, int64_t n, int64_t e,
                                   const void* basis, const void* zone,
                                   const void* scale, const void* mu,
                                   const void* alpha1, int64_t pred_id,
                                   int64_t bands, int64_t zplanes, void* grid,
                                   void* zrow, void* zcol, void* ncoded,
                                   void* scratch, int64_t rw, void* stream) {
  return launch_encode_levels<false>(
      signals, nullptr, nullptr, counts, k, wp, n, e, basis, zone, scale, mu,
      alpha1, pred_id, bands, zplanes, grid, zrow, zcol, ncoded, scratch, rw,
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
    void* zcol, void* ncoded, void* scratch, int64_t rw, void* stream) {
  return launch_encode_levels<true>(
      flat, starts, lens, counts, k, wp, n, e, basis, zone, scale, mu, alpha1,
      pred_id, bands, zplanes, grid, zrow, zcol, ncoded, scratch, rw, stream);
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
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // one CTA per chunk, in exact mode (num_chunks == 1) too
  symlen_pack_kernel<<<static_cast<unsigned>(total), fptc::kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<const uint8_t*>(zrow),
      static_cast<const uint8_t*>(zcol), static_cast<const int32_t*>(counts),
      wp, static_cast<int>(e), num_chunks, chunk, static_cast<int>(v3 != 0),
      static_cast<const int64_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<int>(check_gaps != 0), static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo), static_cast<int32_t*>(sl),
      static_cast<int32_t*>(wpc), static_cast<uint8_t*>(bad));
  FPTC_CHECK_LAUNCH();
  return 0;
}

// The tile fptc_encode_levels and fptc_encode_levels_gather launch at
// (n, e) for rw (0: the kernel's own pick), for the tuner (see
// fptc_idct_tile in decode_fused.cu): out i64[4] = {rw, wg, bw, smem}; a
// refused rw returns cudaErrorInvalidValue.
FPTC_EXPORT int fptc_levels_tile(int64_t n, int64_t e, int64_t rw,
                                 int64_t* out) {
  fptc::DctTile t;
  if (!fptc::dct_tile_shape(static_cast<int>(n), static_cast<int>(e),
                            static_cast<int>(rw), &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = t.rw;
  out[1] = t.wg;
  out[2] = t.bw;
  out[3] = static_cast<int64_t>(
      fptc::levels_carve(static_cast<int>(n), static_cast<int>(e), t).total);
  return 0;
}
