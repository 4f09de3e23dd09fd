// The forward DCT + 3-zone quantize kernel of K4's first stage
// (encode_fused.cu: encode_levels and encode_levels_gather) and of K5
// (dct_quant.cu), with K4's v3 prediction and zero planes:
//
//   level[w, k] = quantize(sum_j x[w, j] * basis[j, k], k)
//
// x f32[rows, N], basis f32[N, E], N, E <= 128.  Design for the H100
// (levels_kernel): one persistent CTA of 256 threads per resident slot
// stages the basis (as [N][ep], ep = E rounded up to 4, the pad columns
// zero and never stored) and the quant table once, then walks a contiguous
// range of (row, block of bw windows) tiles.  Each tile's windows arrive in
// shared memory by cp.async into one of two buffers while the CTA
// transforms the other (stage_windows_async).  Every thread owns an RW x 4
// register tile of (window, band) outputs: per 4 j-steps it reads RW
// float4s of x and 4 float4 rows of the basis and does 16 RW FMAs
// (fma_tile).  Where the band groups divide the 8 warps, a warp holds one
// band group (tile_coords), so its lanes take one branch of the quantizer
// (zones are per band), which quantizes a band at a time with the
// thread's RW outputs interleaved (quantize_tile).  Windows lie at a stride
// of 4 (ceil(N / 4) | 1) floats: 16-byte aligned, and an odd number of
// 16-byte groups, so the 32 consecutive windows a warp reads fill the
// banks evenly.  The levels go to a shared tile (or, with no v3 coding,
// straight to the tile's grid bytes), the prediction is done 4 bands a
// word, and the grid is written 16 bytes a store.
//
// What bounds it on the H100: bytes for E <= 8 (the f32 input read once);
// the quantizer (two IEEE divisions and a log1pf an output in zone 0, one
// division in zone 1) and the FMAs (2 N E a window) for E >= 16, where
// they take longer than the bytes.
//
// The bit contract.  Every output is one fp32 FMA chain from 0.0f over j in
// ascending order: the float4 reads and the register tile change where the
// operands come from, not the order of the chain (no TF32, no tensor
// cores, no split sums).  The quantizer must equal the port's plain
// repro_torch/core/quantize.py::quantize bit for bit when given the same
// coefficient, and PyTorch rounds after every elementwise op:
//  * torch.round rounds half to even: rintf here, never roundf;
//  * nvcc would contract `(c - d1) / denom * 126 + 0.5` (and `a - alpha1 *
//    a`) into FMAs, which round once where torch rounds twice, so every
//    such line is written with __fsub_rn / __fdiv_rn / __fmul_rn /
//    __fadd_rn, which are never contracted (the shared nvcc flags keep
//    -fmad=true for the decode kernels);
//  * log1p(mu) is log1pf of the f32 mu, computed once per CTA, as the plain
//    version's torch.log1p(mu) on the f32 mu tensor is; a band's d1 and
//    denom are computed once per CTA by the same ops.
// The DCT itself sums in another order than the plain version's cuBLAS
// product, so a coefficient within an ulp of a cell boundary can land one
// level away; the quantizer alone is exact (an identity basis makes the
// coefficients the inputs).
//
// Alignment.  A tile is copied 16 bytes a cp.async where N % 4 == 0 and its
// first sample is 16-byte aligned (every window then starts on a 16-byte
// boundary in both memories: a dense row at row * Wp * N floats, a gathered
// one at starts[r] plus whole windows), else 4 bytes a cp.async.  Samples
// at or past the readable count (a gathered row's length) are zero-filled
// by cp.async's src-size operand and never read.  The grid bytes are
// written 4 a store into shared memory where E % 4 == 0 and the tile's
// grid offset is 4-aligned, a byte a store otherwise, then copied out 16
// bytes a store between single bytes at the tile's unaligned edges.
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace fptc {

constexpr int kDctMaxDim = 128;
constexpr int kDctThreads = 256;
// the two staging buffers stay under this many bytes, so two CTAs of the
// archive's shapes share an SM (the register tiles allow no more)
constexpr int kStageBudget = 80 * 1024;

// The quantizer's per-band table and scalars, staged in shared memory.
struct QuantArgs {
  const int32_t* zone;  // [E]
  const float* scale;   // [E]
  const float* mu;      // [1], read on the device (no host sync)
  const float* alpha1;  // [1]
};

// Floats of shared memory the staged table takes: zone[E] (as int bits),
// scale[E], then mu, alpha1, log1p(mu).
__host__ __device__ inline int quant_table_floats(int e) { return 2 * e + 3; }

__device__ __forceinline__ void stage_quant(float* s, const QuantArgs& q,
                                            int e) {
  int* s_zone = reinterpret_cast<int*>(s);
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    s_zone[i] = q.zone[i];
    s[e + i] = q.scale[i];
  }
  if (threadIdx.x == 0) {
    const float mu = *q.mu;
    s[2 * e] = mu;
    s[2 * e + 1] = *q.alpha1;
    s[2 * e + 2] = log1pf(mu);
  }
}

// One band's quantizer constants, held in registers.
struct Band {
  int zone;
  float a;      // scale
  float d1;     // alpha1 * a
  float denom;  // max(a - d1, 1e-12)
};

__device__ __forceinline__ Band load_band(const float* s, int e, int k) {
  Band b;
  b.zone = reinterpret_cast<const int*>(s)[k];
  b.a = s[e + k];
  b.d1 = __fmul_rn(s[2 * e + 1], b.a);
  b.denom = fmaxf(__fsub_rn(b.a, b.d1), 1e-12f);
  return b;
}

// repro_torch/core/quantize.py::quantize, op for op in fp32, one zone at a
// time and without branches, so that a thread's outputs of one band (one
// zone) interleave: the level as a float before the clamp.
__device__ __forceinline__ float mulaw_level(float c, float a, float mu,
                                             float log1p_mu) {
  const float x = fminf(__fdiv_rn(fabsf(c), a), 1.0f);
  const float q01 = __fdiv_rn(log1pf(__fmul_rn(mu, x)), log1p_mu);
  const bool pos = c > 0.0f;
  const float r = rintf(__fmul_rn(q01, pos ? 126.0f : 127.0f));
  const float lvl = pos ? __fadd_rn(129.0f, r) : __fsub_rn(127.0f, r);
  return c == 0.0f ? 128.0f : lvl;  // exact zeros land on the zero bin
}

__device__ __forceinline__ float deadzone_level(float c, const Band& b) {
  const float cc = fmaxf(fminf(c, b.a), -b.a);
  const bool pos = cc > b.d1;
  // cc - d1 above the deadzone, |cc| - d1 below it
  const float t = __fmul_rn(
      __fdiv_rn(__fsub_rn(pos ? cc : fabsf(cc), b.d1), b.denom),
      pos ? 126.0f : 127.0f);
  const float f = floorf(__fadd_rn(t, 0.5f));
  return pos ? __fadd_rn(129.0f, f)
             : cc < -b.d1 ? __fsub_rn(127.0f, f) : 128.0f;
}

__device__ __forceinline__ uint32_t level_byte(float lvl) {
  return static_cast<uint32_t>(fminf(fmaxf(lvl, 0.0f), 255.0f));
}

// The level of one coefficient of a band (zone 2: aggressive zeroing).
__device__ __forceinline__ uint8_t quantize_level(float c, const Band& b,
                                                  float mu, float log1p_mu) {
  if (b.zone == 0) return level_byte(mulaw_level(c, b.a, mu, log1p_mu));
  if (b.zone == 1) return level_byte(deadzone_level(c, b));
  return 128;
}

// The levels of a thread's RW x 4 tile, 4 bands packed a word per window:
// a band at a time (its zone's branch once), its RW outputs interleaved.
template <int RW>
__device__ __forceinline__ void quantize_tile(const float (&acc)[RW][4],
                                              const Band (&band)[4], float mu,
                                              float log1p_mu,
                                              uint32_t (&out)[RW]) {
#pragma unroll
  for (int i = 0; i < RW; ++i) out[i] = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t lv[RW];
    if (band[c].zone == 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        lv[i] = level_byte(mulaw_level(acc[i][c], band[c].a, mu, log1p_mu));
      }
    } else if (band[c].zone == 1) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        lv[i] = level_byte(deadzone_level(acc[i][c], band[c]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < RW; ++i) lv[i] = 128;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) out[i] |= lv[i] << (8 * c);
  }
}

// The block shape of a DCT launch, chosen on the host per (N, E).
struct DctTile {
  int kg;      // band groups of 4: ceil(E / 4)
  int wg;      // window groups in use (threads wg * kg of the CTA)
  int rw;      // windows a thread (its register tile is rw x 4)
  int bw;      // windows a block: wg * rw
  int stride;  // floats between staged windows
  int ep;      // basis row stride in shared memory: 4 * kg
};

// rw = 4 and every thread busy, halved (rw, then wg) until the two staging
// buffers of bw + 2 windows (a block and its history) fit kStageBudget.  A
// forced `rw` (1, 2 or 4; 0 picks as above; the tuning cache's choice,
// repro_torch/tuning/autotune.py) skips the halving of rw: it must fit with
// every thread busy, except rw = 1, which halves wg as the pick does.
// Returns false for an rw it refuses (the tuning cache's legality rule,
// mirrored in repro_torch/kernels/tiles.py).
inline bool dct_tile_shape(int n, int e, int rw, DctTile* out) {
  if (rw != 0 && rw != 1 && rw != 2 && rw != 4) return false;
  DctTile t;
  t.kg = (e + 3) / 4;
  t.ep = 4 * t.kg;
  t.stride = 4 * (((n + 3) / 4) | 1);
  t.wg = kDctThreads / t.kg;
  t.rw = rw != 0 ? rw : 4;
  while (2L * (t.wg * t.rw + 2) * t.stride * 4 > kStageBudget) {
    if (t.rw > 1) {
      if (rw != 0) return false;  // a forced rw > 1 that does not fit
      t.rw /= 2;
    } else {
      t.wg /= 2;
    }
  }
  t.bw = t.wg * t.rw;
  *out = t;
  return true;
}

// The thread's band group `kg` and window group `wg`.  Where the band
// groups divide the CTA's 8 warps, each warp holds one band group and its
// lanes 32 consecutive window groups, so a warp's lanes take the same
// quantizer branch (zones are per band); else lanes alternate band groups.
__device__ __forceinline__ void tile_coords(const DctTile& t, int* kg,
                                            int* wg) {
  const int warps = kDctThreads / kWarp;
  const int warp = threadIdx.x / kWarp;
  if (warps % t.kg == 0) {
    *kg = warp % t.kg;
    *wg = threadIdx.x % kWarp + kWarp * (warp / t.kg);
  } else {
    *kg = threadIdx.x % t.kg;
    *wg = threadIdx.x / t.kg;
  }
}

// Start copying `count` windows of N samples into shared memory at `dst`,
// window w at dst + w * stride: sample p of the block (from 0) is src[p]
// for p < avail and an exact zero past it, and no sample at or past avail
// is read.  The caller commits the group.
__device__ __forceinline__ void stage_windows_async(float* dst,
                                                    const float* src,
                                                    int count, int n,
                                                    int stride,
                                                    int64_t avail) {
  const bool wide =
      (n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  Walk at(wide ? n >> 2 : n);  // copy c: unit at.j of window at.r
  for (int c = threadIdx.x; c < count * at.per; c += blockDim.x, at.step()) {
    float* d = dst + at.r * stride;
    if (wide) {
      const int64_t left = avail - 4 * static_cast<int64_t>(c);
      const int bytes =
          left >= 4 ? 16 : left > 0 ? 4 * static_cast<int>(left) : 0;
      cp_async16(d + 4 * at.j, src + (bytes ? 4 * c : 0), bytes);
    } else {
      const bool in = c < avail;
      cp_async4(d + at.j, src + (in ? c : 0), in ? 4 : 0);
    }
  }
}

// Stage basis f32[N, E] as [N][ep] with zero pad columns, and the table.
__device__ __forceinline__ void stage_basis_quant(float* s_basis,
                                                  float* s_quant,
                                                  const float* basis,
                                                  const QuantArgs& q, int n,
                                                  int e, int ep) {
  for (int i = threadIdx.x; i < n * ep; i += blockDim.x) {
    const int j = i / ep;
    const int k = i - j * ep;
    s_basis[i] = k < e ? basis[j * e + k] : 0.0f;
  }
  stage_quant(s_quant, q, e);
}

// One output by the same chain, for the few outputs outside a register
// tile (K4's halo windows): x the window, b the band's column.
__device__ __forceinline__ float dct_one(const float* x, const float* b,
                                         int ep, int n) {
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc = fmaf(x[j], b[j * ep], acc);
  return acc;
}

// The v3 coding of encode_levels (trivial for K5).
struct Coding {
  int pred_id;  // 0 none, 1 delta, 2 linear2
  int bands;    // predict_bands
  int zplanes;  // zero-plane suppression
};

// levels_kernel's shared memory: byte offsets of its parts (16-aligned).
struct LevelsCarve {
  size_t quant, x, nz, rz, lv, carry, g, total;
};

// Bytes between the rows of the shared level tile: E rounded up to 4, an
// odd number of words, so lanes on consecutive windows hit distinct banks.
__host__ __device__ inline int level_stride(const DctTile& t) {
  return 4 * (t.kg | 1);
}

__host__ __device__ inline LevelsCarve levels_carve(int n, int e,
                                                    const DctTile& t) {
  const size_t ls = level_stride(t);
  LevelsCarve c;
  c.quant = align16(sizeof(float) * n * t.ep);  // the basis [N, ep] first
  c.x = c.quant + align16(sizeof(float) * quant_table_floats(e));
  c.nz = c.x + sizeof(float) * 2 * (t.bw + 2) * t.stride;
  c.rz = c.nz + align16(sizeof(int) * (e + 2));
  c.lv = c.rz + align16(t.bw);
  c.carry = c.lv + align16((t.bw + 2) * ls);
  c.g = c.carry + align16(2 * ls);
  c.total = c.g + static_cast<size_t>(t.bw) * e + 16;
  return c;
}

// DCT + quantize (+ the v3 prediction and zero planes) of K rows of Wp
// windows: signals -> grid u8[K, Wp, E] (and ncoded, zrow, zcol).  kGather:
// row r's samples are the run [starts[r], starts[r] + lens[r]) of the flat
// tensor `signals`, exact zero past lens[r]; otherwise row r is
// signals[r * wp * n, (r + 1) * wp * n).  A tile is (row, block of t.bw
// windows); CTA c walks tiles [c * tiles / G, (c + 1) * tiles / G) in
// order, so a tile's history (the two windows before its block) is the
// tile before's last two levels, carried in shared memory; only a CTA's
// first tile recomputes them.  Per tile: the register tiles' levels go to
// a shared tile (with no v3 coding, straight to the tile's grid bytes);
// then the prediction a word (4 bands) a thread where E % 4 == 0, a byte
// else; then the grid bytes are written 16 a store.  With zero planes the
// totals of a row's run of tiles in this CTA go to the row's scratch once,
// at the run's end.  `counts` is read, and `zrow`, `zcol`, `ncoded`,
// `scratch` written, only under a v3 coding.
template <bool kGather, int RW>
__global__ void __launch_bounds__(kDctThreads, 2)
    levels_kernel(const float* __restrict__ signals,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ counts, int64_t k_rows,
                  int64_t wp, int n, int e, DctTile t,
                  const float* __restrict__ basis, QuantArgs q, Coding coding,
                  uint8_t* __restrict__ grid, uint8_t* __restrict__ zrow,
                  uint8_t* __restrict__ zcol, int32_t* __restrict__ ncoded,
                  int32_t* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const LevelsCarve cv = levels_carve(n, e, t);
  const int ls = level_stride(t);
  float* s_basis = reinterpret_cast<float*>(base);  // [N, ep]
  float* s_quant = reinterpret_cast<float*>(base + cv.quant);
  float* s_x = reinterpret_cast<float*>(base + cv.x);  // [2][bw + 2][stride]
  // [E] nonzero bands of the true windows of the CTA's run of a row's
  // tiles, then the run's kept windows and the row-finished flag
  int* s_nz = reinterpret_cast<int*>(base + cv.nz);
  uint8_t* s_rz = reinterpret_cast<uint8_t*>(base + cv.rz);  // [bw] nonzero
  // [bw + 2][ls]: row b holds the levels of window w0 - 2 + b
  uint8_t* s_lv = reinterpret_cast<uint8_t*>(base + cv.lv);
  uint8_t* s_carry = reinterpret_cast<uint8_t*>(base + cv.carry);  // [2][ls]
  uint8_t* s_g = reinterpret_cast<uint8_t*>(base + cv.g);  // the tile's grid

  const int buf_floats = (t.bw + 2) * t.stride;
  const int64_t nblk = (wp + t.bw - 1) / t.bw;  // blocks a row
  const int64_t tiles = k_rows * nblk;
  const int64_t first = blockIdx.x * tiles / gridDim.x;
  const int64_t last = (blockIdx.x + 1) * tiles / gridDim.x;
  const bool predict = coding.pred_id != 0 && coding.bands > 0;
  // copy the windows w0 - halo .. w0 + rows - 1 of (row, blk) into buffer
  // rows 2 - halo .. of `buf`; a CTA's first tile past its row's first
  // block stages its history (halo 2), the others carry it
  auto issue = [&](int64_t row, int64_t blk, int halo, int buf) {
    const int64_t w0 = blk * t.bw;
    const int count =
        static_cast<int>(min(static_cast<int64_t>(t.bw), wp - w0)) + halo;
    const int64_t p0 = (w0 - halo) * n;  // the first staged sample
    float* dst = s_x + buf * buf_floats + (2 - halo) * t.stride;
    if constexpr (kGather) {
      stage_windows_async(dst, signals + starts[row] + p0, count, n,
                          t.stride, lens[row] - p0);
    } else {
      stage_windows_async(dst, signals + row * wp * n + p0, count, n,
                          t.stride, static_cast<int64_t>(count) * n);
    }
    cp_async_commit();
  };
  int64_t row = first / nblk;
  int64_t blk = first - row * nblk;
  const int halo0 =
      predict ? static_cast<int>(min(static_cast<int64_t>(2), blk * t.bw))
              : 0;
  if (first < last) issue(row, blk, halo0, 0);
  stage_basis_quant(s_basis, s_quant, basis, q, n, e, t.ep);
  __syncthreads();

  int kg, wg;
  tile_coords(t, &kg, &wg);
  const bool active = wg < t.wg;
  Band band[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    band[c] = load_band(s_quant, e, min(4 * kg + c, e - 1));
  }
  const float mu = s_quant[2 * e];
  const float log1p_mu = s_quant[2 * e + 2];

  int buf = 0;
  for (int64_t tile = first; tile < last; ++tile, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the block has landed; the other buffer is free
    const bool next_row = blk + 1 == nblk;
    if (tile + 1 < last) {
      issue(next_row ? row + 1 : row, next_row ? 0 : blk + 1, 0, buf ^ 1);
    }
    const int64_t w0 = blk * t.bw;
    const int rows = static_cast<int>(min(static_cast<int64_t>(t.bw),
                                          wp - w0));
    const int halo = tile == first ? halo0 : 0;
    const float* xb = s_x + buf * buf_floats;
    // the tile's grid bytes go to s_g at the grid's alignment mod 16; with
    // no prediction or zero planes the levels are the grid bytes, and go
    // there straight from the registers, a word a window and band group
    uint8_t* g_out = grid + (row * wp + w0) * e;
    const int total = rows * e;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g_out) & 15);
    uint8_t* sg = s_g + mis;
    const bool words = (e & 3) == 0 && (mis & 3) == 0;
    const bool direct = words && !predict && !coding.zplanes;
    if (active) {
      float acc[RW][4];
      fma_tile<RW>(xb + (2 + wg) * t.stride, t.wg * t.stride,
                   s_basis + 4 * kg, t.ep, n, acc);
      uint32_t lv[RW];
      quantize_tile<RW>(acc, band, mu, log1p_mu, lv);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int w = wg + t.wg * i;
        // bands past E land in the row's pad bytes
        if (w < rows) {
          *reinterpret_cast<uint32_t*>(
              direct ? sg + w * e + 4 * kg : s_lv + (2 + w) * ls + 4 * kg) =
              lv[i];
        }
      }
    }
    if (predict) {  // s_lv rows 0 and 1: the history
      for (int i = threadIdx.x; i < 2 * e; i += blockDim.x) {
        const int b = i >= e;
        const int k = i - b * e;
        uint8_t h = 128;  // before window 0: the virtual all-128 one
        if (halo > 0 && b >= 2 - halo) {  // staged and recomputed
          h = quantize_level(dct_one(xb + b * t.stride, s_basis + k, t.ep, n),
                             load_band(s_quant, e, k), mu, log1p_mu);
        } else if (halo == 0 && w0 > 0) {  // carried from the tile before
          h = s_carry[b * ls + k];
        }
        s_lv[b * ls + k] = h;
      }
    }
    if (coding.zplanes) {  // a row's run of tiles starts: zero its totals
      if ((tile == first || blk == 0) && threadIdx.x < e + 2) {
        s_nz[threadIdx.x] = 0;
      }
      for (int w = threadIdx.x; w < rows; w += blockDim.x) s_rz[w] = 0;
    }
    __syncthreads();
    // the v3 prediction: residuals mod 256 against the previous window
    // (delta) or 2 * prev - prev2 (linear2) on bands k < predict_bands,
    // into s_g; with zero planes, flags of the nonzero windows and of the
    // nonzero bands of true windows
    const int64_t nvalid = coding.zplanes ? counts[row] / e : 0;
    auto level = [&](int r, int k) -> int { return s_lv[r * ls + k]; };
    auto word = [&](int r, int k0) {
      return *reinterpret_cast<const uint32_t*>(s_lv + r * ls + k0);
    };
    if (words && !direct) {  // a word (4 bands) a step, bytewise mod 256
      Walk it(e >> 2);
      for (int x = threadIdx.x; x < total >> 2; x += blockDim.x, it.step()) {
        const int w = it.r;
        const int k0 = 4 * it.j;
        const uint32_t cur = word(w + 2, k0);
        uint32_t g = cur;
        if (predict && k0 < coding.bands) {
          const uint32_t p1 = word(w + 1, k0);
          const uint32_t pred = coding.pred_id == 1
                                    ? p1
                                    : __vsub4(__vadd4(p1, p1), word(w, k0));
          const uint32_t res = __vadd4(__vsub4(cur, pred), 0x80808080u);
          const int nb = coding.bands - k0;  // predicted bytes of the word
          const uint32_t m = nb >= 4 ? 0xffffffffu : (1u << (8 * nb)) - 1u;
          g = (res & m) | (cur & ~m);
        }
        *reinterpret_cast<uint32_t*>(sg + 4 * x) = g;
        if (coding.zplanes && g != 0x80808080u) {
          s_rz[w] = 1;
          if (w0 + w < nvalid) {
            for (int b = 0; b < 4; ++b) {
              if (((g >> (8 * b)) & 255) != 128) s_nz[k0 + b] = 1;
            }
          }
        }
      }
    } else if (!words) {  // a byte a step
      Walk it(e);
      for (int x = threadIdx.x; x < total; x += blockDim.x, it.step()) {
        const int w = it.r;
        const int k = it.j;
        int g = level(w + 2, k);
        if (predict && k < coding.bands) {
          const int p1 = level(w + 1, k);
          const int pred = coding.pred_id == 1 ? p1 : 2 * p1 - level(w, k);
          g = (g - pred + 128) & 255;
        }
        sg[x] = static_cast<uint8_t>(g);
        if (coding.zplanes && g != 128) {
          s_rz[w] = 1;
          if (w0 + w < nvalid) s_nz[k] = 1;
        }
      }
    }
    if (predict) {  // the next tile's history: this tile's last two rows
      for (int i = threadIdx.x; i < 2 * ls; i += blockDim.x) {
        s_carry[i] = s_lv[rows * ls + i];
      }
    }
    if (!direct) __syncthreads();
    // the grid bytes, 16 a store where aligned, single bytes at the edges
    const int head = min(total, (16 - mis) & 15);
    const int quads = (total - head) >> 4;
    for (int x = threadIdx.x; x < total - 16 * quads; x += blockDim.x) {
      const int i = x < head ? x : x + 16 * quads;
      g_out[i] = sg[i];
    }
    for (int qd = threadIdx.x; qd < quads; qd += blockDim.x) {
      const int i = head + 16 * qd;
      *reinterpret_cast<uint4*>(g_out + i) =
          *reinterpret_cast<const uint4*>(sg + i);
    }
    const int64_t this_row = row;
    const int64_t this_blk = blk;
    // the tiles of this row that this CTA has walked, this one included
    const int run = static_cast<int>(min(tile - first + 1, blk + 1));
    const bool run_ends = next_row || tile + 1 == last;
    blk = next_row ? 0 : blk + 1;
    row = next_row ? row + 1 : row;
    if (!coding.zplanes) {
      if (ncoded != nullptr && this_blk == 0 && threadIdx.x == 0) {
        ncoded[this_row] = counts[this_row];
      }
      continue;
    }
    // zrow over every window, padding included
    int kept = 0;
    for (int w = threadIdx.x; w < rows; w += blockDim.x) {
      const bool nz = s_rz[w] != 0;
      zrow[this_row * wp + w0 + w] = nz ? 0 : 1;
      kept += nz && w0 + w < nvalid;
    }
    kept = __reduce_add_sync(0xffffffffu, kept);
    if ((threadIdx.x & (kWarp - 1)) == 0 && kept) atomicAdd(s_nz + e, kept);
    if (!run_ends) continue;
    __syncthreads();
    // the run's totals into the row's scratch [E + 2]: nonzero bands (zcol
    // covers the row's true windows only), kept windows, and the count of
    // finished tiles; the CTA that finishes the row's last tiles writes
    // zcol and ncoded
    int32_t* acc = scratch + this_row * (e + 2);
    if (threadIdx.x < e && s_nz[threadIdx.x]) atomicOr(acc + threadIdx.x, 1);
    if (threadIdx.x == 0 && s_nz[e]) atomicAdd(acc + e, s_nz[e]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_nz[e + 1] =
          atomicAdd(acc + e + 1, run) + run == static_cast<int>(nblk);
    }
    __syncthreads();
    if (s_nz[e + 1]) {
      __threadfence();
      bool kept_col = false;
      if (threadIdx.x < e) {
        kept_col = atomicOr(acc + threadIdx.x, 0) != 0;
        zcol[this_row * e + threadIdx.x] = kept_col ? 0 : 1;
      }
      const int cols = __syncthreads_count(kept_col);
      if (threadIdx.x == 0) ncoded[this_row] = atomicAdd(acc + e, 0) * cols;
    }
  }
}

// The block shape, shared memory and resident CTAs of levels_kernel at one
// (N, E).
struct LevelsGeometry {
  DctTile t;
  size_t smem;
  int64_t resident;
};

template <bool kGather>
using LevelsKernel = void (*)(const float*, const int32_t*, const int32_t*,
                              const int32_t*, int64_t, int64_t, int, int,
                              DctTile, const float*, QuantArgs, Coding,
                              uint8_t*, uint8_t*, uint8_t*, int32_t*,
                              int32_t*);

template <bool kGather>
inline LevelsKernel<kGather> levels_kernel_for(int rw) {
  return rw == 4   ? levels_kernel<kGather, 4>
         : rw == 2 ? levels_kernel<kGather, 2>
                   : levels_kernel<kGather, 1>;
}

// The block shape, its shared memory and the resident-CTA count, once per
// (device, kernel, N, E) and arm.  `rw` as dct_tile_shape takes it; a
// refused rw is cudaErrorInvalidValue.  A kernel serves one RW, and at one
// (N, E) a forced RW gives the tile the pick gives for that RW, so the
// cache's key needs no rw of its own.
template <bool kGather>
inline cudaError_t levels_geometry(int n, int e, int rw, LevelsGeometry* g) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (!dct_tile_shape(n, e, rw, &g->t)) return cudaErrorInvalidValue;
  g->smem = levels_carve(n, e, g->t).total;
  const void* k =
      reinterpret_cast<const void*>(levels_kernel_for<kGather>(g->t.rw));
  // keyed by the kernel too: a process that loads two builds of these
  // kernels shares this cache between them
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, int64_t> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, k, n, e);
  auto it = cache.find(key);
  if (it != cache.end()) {
    g->resident = it->second;
    return cudaSuccess;
  }
  err = allow_smem(k, g->smem);
  if (err != cudaSuccess) return err;
  err = resident_ctas(k, kDctThreads, g->smem, &g->resident);
  if (err != cudaSuccess) return err;
  cache.emplace(key, g->resident);
  return cudaSuccess;
}

// Launch levels_kernel over k rows of wp windows: one CTA per resident
// slot, or one per tile where there are fewer tiles.  `rw`: 0 picks the
// register tile, 1, 2 or 4 forces it.
template <bool kGather>
inline int launch_levels(const float* signals, const int32_t* starts,
                         const int32_t* lens, const int32_t* counts,
                         int64_t k, int64_t wp, int n, int e,
                         const float* basis, QuantArgs q, Coding coding,
                         uint8_t* grid, uint8_t* zrow, uint8_t* zcol,
                         int32_t* ncoded, int32_t* scratch, int rw,
                         cudaStream_t stream) {
  LevelsGeometry g;
  cudaError_t err = levels_geometry<kGather>(n, e, rw, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = k * ((wp + g.t.bw - 1) / g.t.bw);
  const int64_t ctas = tiles < g.resident ? tiles : g.resident;
  levels_kernel_for<kGather>(g.t.rw)<<<static_cast<unsigned>(ctas),
                                       kDctThreads, g.smem, stream>>>(
      signals, starts, lens, counts, k, wp, n, e, g.t, basis, q, coding, grid,
      zrow, zcol, ncoded, scratch);
  FPTC_CHECK_LAUNCH();
  return 0;
}

}  // namespace fptc
