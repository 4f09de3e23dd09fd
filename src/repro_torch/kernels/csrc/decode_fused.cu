// K2, after K1's decode: the container-v3 expansion + un-prediction, and
// the LUT dequant + inverse DCT.
//
// Replaces repro/kernels/decode_fused.py::decode_fused (_fused_kernel,
// lut_dequant), the TPU megakernel at decode_fused.py:305, which runs K1's
// decode, then for v3 codings the expand_coded_stream gather (-1 -> 128)
// and unpredict_levels (a segmented cumsum mod 256 over bands <
// predict_bands, twice for linear2), then coeffs[w, k] = lut[k, level] and
// coeffs @ basis.  Here that is three launches (K1's kernel writes dense u8
// levels to device memory; the v3 stage and the LUT-iDCT follow) until
// measurements say fusing pays.
//
// What bounds it on the H100: device-memory bytes.  The v3 stage reads
// idx (4 bytes a cell), the coded symbol (1 byte) and seg (4 bytes a
// window) and writes the level (1 byte); the dequant/iDCT writes 4 N bytes
// of f32 per window.
//
// Design of the v3 stage, three launches in one exported call:
//  1. v3_tile: a CTA takes a tile of T windows x all e bands (T: the
//     caller's, kernels/tiles.py's pick or the tuning cache's).  It reads idx
//     coalesced (16 bytes a thread), gathers the coded symbols into the
//     tile in shared memory (so the grid is written once, in wide stores),
//     and, for each band < predict_bands, runs a block-wide segmented scan
//     over the tile's windows: local cumsums that start at the tile (or at
//     a segment head inside it).  It writes the tile's aggregate per band
//     and the count of windows before its first head.
//  2. v3_carry_scan: one block per band scans the tiles' aggregates in
//     order, in place, into each tile's incoming carry.
//  3. v3_carry_apply: adds the carry to the windows before each tile's
//     first head, bands < predict_bands only; later windows are final.
// The scan's operator: a window or range is (h, A1, A2, n) — whether it
// holds a segment head, its local cumsum and double cumsum at its end, and
// its length — all mod 256, packed in one 32-bit word.  With incoming
// carries (C1, C2) and no head, the range ends at (C1 + A1, C2 + n C1 + A2);
// a range with a head ignores the carry.  So combining (L, R) gives R when
// R has a head, else (L.h, L.A1 + R.A1, L.A2 + R.n L.A1 + R.A2, L.n + R.n).
// Every sum is taken mod 256, which equals the reference's uint32 wrap mod
// 256 because 256 divides 2^32.  Against the TPU kernel it drops the
// reference's whole-bucket cumsum minus a gather at each segment start.
// For pred_id == 0 or predict_bands == 0 only the gather runs.
//
// The LUT dequant drops the TPU's 256-step masked-select lut_dequant loop
// (TPUs lack a per-element VMEM gather) for a direct shared-memory table
// read.
#include "dequant_idct.cuh"

namespace {

constexpr int kThreads = 256;  // windows per scan round of a v3 tile
constexpr int kCarryThreads = 1024;

// The scan operand: A1 in bits 0-7, A2 in 8-15, n in 16-23, h in bit 24.
constexpr uint32_t kHead = 1u << 24;

__device__ __forceinline__ uint32_t v3_pack(uint32_t h, uint32_t a1,
                                            uint32_t a2, uint32_t n) {
  return (h ? kHead : 0u) | ((n & 255u) << 16) | ((a2 & 255u) << 8) |
         (a1 & 255u);
}

struct V3Combine {
  __device__ uint32_t operator()(uint32_t l, uint32_t r) const {
    if (r & kHead) return r;
    const uint32_t l1 = l & 255u, l2 = (l >> 8) & 255u, ln = (l >> 16) & 255u;
    const uint32_t r1 = r & 255u, r2 = (r >> 8) & 255u, rn = (r >> 16) & 255u;
    return v3_pack(l & kHead, l1 + r1, l2 + rn * l1 + r2, ln + rn);
  }
};

// grid cell from its idx: the coded symbol, or the zero bin where idx < 0.
// Out-of-range positions clamp like XLA's gather.
__device__ __forceinline__ uint32_t v3_expand(const uint8_t* __restrict__ dense,
                                              int64_t dense_len, int32_t i) {
  if (i < 0) return 128u;
  return __ldg(dense + (i < dense_len ? i : dense_len - 1));
}

// Stage 1.  Tile t covers windows [t T, t T + tw); its cells are contiguous
// in idx and grid.  agg u32[num_tiles, bands], lead i32[num_tiles].
__global__ void __launch_bounds__(kThreads)
v3_tile(const uint8_t* __restrict__ dense, int64_t dense_len,
        const int32_t* __restrict__ idx, const int32_t* __restrict__ seg,
        int64_t num_windows, int e, int bands, int pred2, int tile_windows,
        uint8_t* __restrict__ grid, uint32_t* __restrict__ agg,
        int32_t* __restrict__ lead) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem;                               // [tile_windows, e]
  uint8_t* heads = smem + tile_windows * e;            // [tile_windows]
  __shared__ uint32_t warp_aggs[32];
  __shared__ int first_head;

  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * tile_windows;
  const int64_t rest = num_windows - w0;
  const int tw = static_cast<int>(rest < tile_windows ? rest : tile_windows);
  const int cells = tw * e;
  const int64_t base = w0 * e;

  // expand: 16 bytes of idx a thread, four cells into one 32-bit word
  const int nv = cells / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + base);
  uint32_t* tile32 = reinterpret_cast<uint32_t*>(tile);
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const int4 q = __ldcs(idx4 + v);
    tile32[v] = v3_expand(dense, dense_len, q.x) |
                (v3_expand(dense, dense_len, q.y) << 8) |
                (v3_expand(dense, dense_len, q.z) << 16) |
                (v3_expand(dense, dense_len, q.w) << 24);
  }
  for (int c = nv * 4 + threadIdx.x; c < cells; c += kThreads) {
    tile[c] = static_cast<uint8_t>(v3_expand(dense, dense_len, idx[base + c]));
  }

  if (bands > 0) {
    if (threadIdx.x == 0) first_head = tw;
    __syncthreads();
    for (int w = threadIdx.x; w < tw; w += kThreads) {
      const bool h = __ldcs(seg + w0 + w) == w0 + w;
      heads[w] = h;
      if (h) atomicMin(&first_head, w);
    }
    __syncthreads();
    const V3Combine op{};
    for (int k = 0; k < bands; ++k) {
      uint32_t run = 0;  // the identity: no head, zero sums, zero length
      for (int r = 0; r < tw; r += kThreads) {
        const int w = r + threadIdx.x;
        uint32_t x = 0;
        if (w < tw) {
          const uint32_t t = (tile[w * e + k] + 128u) & 255u;
          x = v3_pack(heads[w], t, t, 1u);
        }
        uint32_t total;
        const uint32_t ex =
            fptc::block_exclusive_scan(x, op, 0u, warp_aggs, &total);
        if (w < tw) {
          const uint32_t in = op(run, op(ex, x));
          const uint32_t cs = pred2 ? (in >> 8) : in;
          tile[w * e + k] = static_cast<uint8_t>((cs + 128u) & 255u);
        }
        run = op(run, total);
      }
      if (threadIdx.x == 0) agg[blockIdx.x * static_cast<int64_t>(bands) + k] = run;
    }
    if (threadIdx.x == 0) lead[blockIdx.x] = first_head;
  }
  __syncthreads();

  // write the tile back: 16 bytes a thread, then the ragged tail
  const int nq = cells / 16;
  const int4* tile16 = reinterpret_cast<const int4*>(tile);
  int4* out16 = reinterpret_cast<int4*>(grid + base);
  for (int v = threadIdx.x; v < nq; v += kThreads) __stcs(out16 + v, tile16[v]);
  for (int c = nq * 16 + threadIdx.x; c < cells; c += kThreads) {
    grid[base + c] = tile[c];
  }
}

// Stage 2.  Block k scans band k's tile aggregates in order, in place, into
// each tile's exclusive prefix: the (C1, C2) carried into its first window.
__global__ void __launch_bounds__(kCarryThreads)
v3_carry_scan(uint32_t* __restrict__ agg, int64_t num_tiles, int bands) {
  __shared__ uint32_t warp_aggs[32];
  const int k = blockIdx.x;
  const V3Combine op{};
  uint32_t run = 0;
  for (int64_t b = 0; b < num_tiles; b += kCarryThreads) {
    const int64_t i = b + threadIdx.x;
    const uint32_t x = i < num_tiles ? agg[i * bands + k] : 0u;
    uint32_t total;
    const uint32_t ex = fptc::block_exclusive_scan(x, op, 0u, warp_aggs, &total);
    if (i < num_tiles) agg[i * bands + k] = op(run, ex);
    run = op(run, total);
  }
}

// Stage 3.  Tile blockIdx.x + 1 (the first tile's carry is the identity):
// window w < lead, band k < bands gains C1 (delta) or C2 + (w + 1) C1
// (linear2) to its level.
__global__ void __launch_bounds__(kThreads)
v3_carry_apply(uint8_t* __restrict__ grid, const uint32_t* __restrict__ carry,
               const int32_t* __restrict__ lead, int e, int bands, int pred2,
               int tile_windows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) + 1;
  const int cells = lead[t] * bands;
  const int64_t w0 = t * tile_windows;
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const int w = c / bands;
    const int k = c - w * bands;
    const uint32_t cv = carry[t * bands + k];
    const uint32_t c1 = cv & 255u;
    const uint32_t add =
        pred2 ? ((cv >> 8) + static_cast<uint32_t>(w + 1) * c1) : c1;
    uint8_t* cell = grid + (w0 + w) * e + k;
    *cell = static_cast<uint8_t>((*cell + add) & 255u);
  }
}

// The v3 stage's tile rule: a positive multiple of the CTA's 256 threads
// whose tile and head flags fit 44 KiB of shared memory (under the 48 KiB a
// block gets without opting in).
inline bool v3_tile_legal(int64_t e, int64_t tile_windows) {
  return tile_windows > 0 && tile_windows % kThreads == 0 &&
         tile_windows * (e + 1) <= 44 * 1024;
}

}  // namespace

// dense u8[dense_len] coded symbols, idx i32[num_windows * e] (16-byte
// aligned), seg i32[num_windows] -> grid u8[num_windows * e] (plain levels,
// 16-byte aligned).  tile_windows: a multiple of 256 with
// tile_windows * (e + 1) <= 44 KiB (the tile and its head flags in shared
// memory, under the 48 KiB a block gets without opting in).  scratch: i32[num_tiles * (bands + 1)],
// num_tiles = ceil(num_windows / tile_windows).
FPTC_EXPORT int fptc_v3_expand_unpredict(const void* dense, int64_t dense_len,
                                         const void* idx, const void* seg,
                                         int64_t num_windows, int64_t e,
                                         int64_t bands, int64_t pred_id,
                                         int64_t tile_windows, void* grid,
                                         void* scratch, void* stream) {
  if (num_windows <= 0 || e <= 0) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(grid) % 16 == 0;
  if (dense_len <= 0 || bands < 0 || bands > e || !aligned ||
      !v3_tile_legal(e, tile_windows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pred_id == 0) bands = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (num_windows + tile_windows - 1) / tile_windows;
  uint32_t* agg = static_cast<uint32_t*>(scratch);
  int32_t* lead = static_cast<int32_t*>(scratch) + tiles * bands;
  const int pred2 = pred_id == 2;
  const size_t smem = static_cast<size_t>(tile_windows) * (e + 1);
  uint8_t* out = static_cast<uint8_t*>(grid);
  v3_tile<<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
      static_cast<const uint8_t*>(dense), dense_len,
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(seg),
      num_windows, static_cast<int>(e), static_cast<int>(bands), pred2,
      static_cast<int>(tile_windows), out, agg, lead);
  FPTC_CHECK_LAUNCH();
  if (bands == 0 || tiles == 1) return 0;
  v3_carry_scan<<<static_cast<unsigned>(bands), kCarryThreads, 0, s>>>(
      agg, tiles, static_cast<int>(bands));
  FPTC_CHECK_LAUNCH();
  v3_carry_apply<<<static_cast<unsigned>(tiles - 1), kThreads, 0, s>>>(
      out, agg, lead, static_cast<int>(e), static_cast<int>(bands), pred2,
      static_cast<int>(tile_windows));
  FPTC_CHECK_LAUNCH();
  return 0;
}

// levels u8[num_windows, e], lut f32[e, 256], basis f32[e, n]
// -> out f32[num_windows, n].  rw: the register tile's windows a thread, 0
// to pick it (idct_tile_shape), 4 or 8 to force it; a refused rw returns
// cudaErrorInvalidValue.
FPTC_EXPORT int fptc_lut_idct(const void* levels, int64_t num_windows,
                              int64_t e, int64_t n, const void* lut,
                              const void* basis, void* out, int64_t rw,
                              void* stream) {
  fptc::LutDequant dq{static_cast<const float*>(lut)};
  return fptc::launch_dequant_idct(
      static_cast<const uint8_t*>(levels), num_windows, static_cast<int>(e),
      static_cast<int>(n), static_cast<const float*>(basis), dq,
      static_cast<float*>(out), static_cast<int>(rw),
      static_cast<cudaStream_t>(stream));
}

// The launch shapes the two launchers above accept, for the tuner: the
// tuning cache offers and keeps only what these accept
// (repro_torch/tuning/autotune.py; repro_torch/kernels/tiles.py mirrors
// them for machines without the library, held to these by a card test).
// fptc_idct_tile: the tile fptc_lut_idct launches at (e, n) for rw (0: its
// own pick) under max_smem bytes of shared memory a block (0: the current
// device's opt-in maximum): out i64[4] = {rw, bw, aw, smem}; a refused rw
// returns cudaErrorInvalidValue.
FPTC_EXPORT int fptc_idct_tile(int64_t e, int64_t n, int64_t rw,
                               int64_t max_smem, int64_t* out) {
  if (max_smem <= 0) {
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    max_smem = optin;
  }
  fptc::IdctTile t;
  if (!fptc::idct_tile_shape(static_cast<int>(e), static_cast<int>(n),
                             static_cast<size_t>(max_smem),
                             static_cast<int>(rw), &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = t.rw;
  out[1] = t.bw;
  out[2] = t.aw;
  out[3] = static_cast<int64_t>(fptc::idct_carve(static_cast<int>(e), t)
                                    .total);
  return 0;
}

// 1 where fptc_v3_expand_unpredict accepts tile_windows at e bands, else 0.
FPTC_EXPORT int fptc_v3_tile_ok(int64_t e, int64_t tile_windows) {
  return v3_tile_legal(e, tile_windows) ? 1 : 0;
}
