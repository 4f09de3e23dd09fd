// The dequant + inverse-DCT kernel shared by K2's last stage (lut_idct: the
// LUT dequant) and K3 (idct_dequant: the inline 3-zone dequant):
//
//   out[w, j] = sum_k dequant(k, levels[w, k]) * basis[k, j]
//
// levels u8[W, E], basis f32[E, N], out f32[W, N]; E, N <= 128.
//
// What bounds it on the H100: the f32 output write (4 N bytes a window
// against E level bytes read) at the memory rate; the FMAs (E N a window)
// come second, at E = N = 32 nearly as long as the write at the fp32 rate.
//
// Design for the H100 (dequant_idct_kernel), one line per decision:
//  1. Persistent CTAs, independent warps: one CTA of 256 threads per
//     resident slot stages the basis (as [E][np], np = 4 * cgt, zero pad
//     columns, never stored) and the dequant table once, then walks a
//     contiguous range of tiles of bw windows.  A tile is `sets` window
//     sets of sw windows; each (set, column block) is one warp's task, and
//     a warp stages, dequantizes and transforms its sets in buffers of its
//     own, so after the staging no barrier joins the warps: they drift
//     apart, and one warp's table reads and stores overlap another's FMAs.
//  2. Staged level sets: each set's sw * E level bytes arrive by cp.async,
//     16 bytes a copy from the first 16-byte boundary on (the last copy
//     zero-filled past the set, so nothing past it is read) and single
//     bytes by plain loads before that boundary (a levels base off a 16-byte
//     boundary), into one of the warp's two buffers while it transforms the
//     other (stage_levels_async).  A buffer keeps the source's offset mod 16.
//  3. Dequant from a table, four levels a step (dequant_set): one 32-bit
//     read of four bands of a window where E % 4 == 0 and the set is
//     4-byte aligned (single bytes else), four table reads, and one float4
//     store of the coefficients, window-major at ep = 4 * (ceil(E / 4) | 1)
//     floats a window (an odd count of 16-byte units, so the 8 consecutive
//     windows a warp reads hit distinct banks).  The table is [E][257]
//     floats: the odd row stride puts one level of different bands (most
//     bands sit at the zero bin 128) in different banks.  lut_idct copies
//     its LUT (16 bytes a load); K3 builds the table on the device once a
//     CTA by calling ZoneDequant::apply, unchanged and __noinline__, for
//     every (k, level), so the table holds what the inline dequant
//     computed; it is built from zone/scale/mu/alpha1 (quant_grid differs
//     from them by up to 5 ulp).
//  4. Register-tiled FMA chains (fma_tile in common.cuh): a thread owns RW
//     windows x 4 columns; per 4 k-steps it reads RW float4s of
//     coefficients and 4 float4 rows of the basis and issues 16 RW FFMAs.
//     A warp holds wgw windows a row x cgw column groups (cgw 8 where the
//     column groups allow, so a warp's basis read is one 128-byte
//     wavefront and its coefficient read one more): at RW = 8, 12 shared
//     wavefronts a warp per 128 FFMAs.  RW is 8 where the buffers fit,
//     else 4 (idct_tile_shape); the caller may force RW = 4 or 8 (the
//     tuning cache's choice, repro_torch/tuning/autotune.py), and a forced
//     RW = 8 that does not fit with every warp buffered is refused.
//  5. Stores: each (window, column group) a float4 streaming store
//     (__stcs), so a warp writes whole rows (cgw = 8: 4 windows of 128
//     bytes at N = 32); N % 4 != 0 (or an output off a 16-byte boundary)
//     takes scalar stores of the columns < N.
//  6. Geometry: the tile shape, shared memory and resident CTAs are cached
//     per (device, kernel, E, N) (idct_geometry): keyed by the kernel, since
//     a process that loads two builds of the library shares this template's
//     static state between them.  Every 1 <= E, N <= 128 launches: at E =
//     N = 128 the table (128.5 KiB) and basis (64 KiB) stay in shared
//     memory, RW = 4 and two warps of the CTA keep buffers (one CTA an SM).
//
// The bit contract.  Every output is one fp32 FMA chain from 0.0f over k
// ascending, acc = fmaf(dq(k, level[w, k]), basis[k, j], acc), with dq the
// LUT entry (lut_idct) or ZoneDequant::apply (K3), so any tiling of the
// kernel gives the same bits (chip_smoke.py compares builds by digest).  No
// TF32, no tensor cores, no split sums.
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace fptc {

constexpr int kIdctThreads = 256;
constexpr int kIdctWarps = kIdctThreads / kWarp;
constexpr int kMaxDim = 128;
constexpr int kTableStride = 257;  // floats a band of the dequant table

// Dequant by exact selection from the 256-level reconstruction LUT
// (quant_grid): lut f32[E, 256], copied into the table.
struct LutDequant {
  const float* lut;
  // 16 bytes a load where the LUT is 16-byte aligned, else a float a load
  __device__ void build(float* table, float*, int e) const {
    if ((reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
      const float4* lut4 = reinterpret_cast<const float4*>(lut);
#pragma unroll 4
      for (int i = threadIdx.x; i < e * 64; i += blockDim.x) {
        const float4 v = __ldg(lut4 + i);
        float* d = table + (i >> 6) * kTableStride + 4 * (i & 63);
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
      return;
    }
    for (int i = threadIdx.x; i < e * 256; i += blockDim.x) {
      table[(i >> 8) * kTableStride + (i & 255)] = lut[i];
    }
  }
};

// Inline 3-zone dequant (repro/kernels/idct_dequant.py::_kernel, lines
// 46-74, op for op in fp32): mu-law expm1/log1p in zone 0, linear deadzone
// in zone 1, zero in zone 2.  Staged parameters: zone[E] (as float),
// scale[E], then mu, alpha1, log1p(mu).
struct ZoneDequant {
  const int32_t* zone;
  const float* scale;
  const float* mu;
  const float* alpha1;
  __device__ void stage(float* s, int e) const {
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      s[i] = static_cast<float>(zone[i]);
      s[e + i] = scale[i];
    }
    if (threadIdx.x == 0) {
      s[2 * e] = *mu;
      s[2 * e + 1] = *alpha1;
      s[2 * e + 2] = log1pf(*mu);
    }
  }
  // one instruction sequence for every (k, level): never inlined
  __device__ __noinline__ float apply(const float* s, int e, int k,
                                      uint8_t level) const {
    const float lvl = static_cast<float>(level);
    const int zone_k = static_cast<int>(s[k]);
    const float a = s[e + k];
    const bool pos = lvl > 128.0f;
    const bool neg = lvl < 128.0f;
    if (zone_k == 0) {
      float q01 = pos ? (lvl - 129.0f) / 126.0f : (127.0f - lvl) / 127.0f;
      q01 = fminf(fmaxf(q01, 0.0f), 1.0f);
      const float mag0 = a * (expm1f(q01 * s[2 * e + 2]) / s[2 * e]);
      if (lvl == 128.0f) return 0.0f;
      return pos ? mag0 : -mag0;
    }
    if (zone_k == 1) {
      const float d1 = s[2 * e + 1] * a;
      const float span = a - d1;
      const float mag1 = pos ? d1 + (lvl - 129.0f) / 126.0f * span
                             : d1 + (127.0f - lvl) / 127.0f * span;
      return pos ? mag1 : (neg ? -mag1 : 0.0f);
    }
    return 0.0f;
  }
  // the table [E][257]: the parameters staged in `scratch`, then every
  // (k, level) by apply
  __device__ void build(float* table, float* scratch, int e) const {
    stage(scratch, e);
    __syncthreads();
    for (int i = threadIdx.x; i < e * 256; i += blockDim.x) {
      table[(i >> 8) * kTableStride + (i & 255)] =
          apply(scratch, e, i >> 8, static_cast<uint8_t>(i & 255));
    }
  }
};

// The block shape of a launch, chosen on the host per (E, N).
struct IdctTile {
  int cgt;   // column groups of 4: ceil(N / 4), padded to 1, 2, 4 or 4 m
  int np;    // basis row stride in shared memory: 4 * cgt
  int cgw;   // column groups a warp holds: 8 where cgt % 8 == 0, else <= 4
  int wgw;   // windows a warp holds a row: 32 / cgw
  int cb;    // column blocks (warps across the columns): cgt / cgw
  int rw;    // windows a thread (its register tile is rw x 4)
  int sw;    // windows a set: wgw * rw
  int sets;  // window sets a tile: a task each per column block
  int bw;    // windows a tile: sets * sw
  int aw;    // warps with buffers (the rest idle): 8 where memory allows
  int ep;    // floats between windows of a coefficient buffer
};

// Byte offsets of the parts of the kernel's shared memory (16-aligned).
struct IdctCarve {
  size_t basis, coef, lv, lv_bytes, total;
};

__host__ __device__ inline IdctCarve idct_carve(int e, const IdctTile& t) {
  IdctCarve c;
  c.basis = align16(sizeof(float) * e * kTableStride);  // the table first
  c.coef = c.basis + align16(sizeof(float) * e * t.np);
  // a coefficient buffer [sw][ep] a warp
  c.lv = c.coef + sizeof(float) * t.aw * t.sw * t.ep;
  // a level buffer: a set at its source offset mod 16; two a warp
  c.lv_bytes = align16(static_cast<size_t>(t.sw) * e + 16);
  c.total = c.lv + 2 * t.aw * c.lv_bytes;
  return c;
}

// rw = 8, 8 warps with buffers, and a task (window set, column block) per
// warp a tile; rw halved, then the warps with buffers, until the shared
// memory fits `max_smem`.  The coefficient buffers (sw >= 16 windows of
// ep >= E floats) always hold ZoneDequant's 2 E + 3 staged parameters.
// A forced `rw` (4 or 8; 0 picks as above) skips the halving of rw: a
// forced 8 must fit with all 8 warps buffered, a forced 4 halves the warps
// with buffers as the pick does.  Returns false for an rw it refuses (the
// tuning cache's legality rule, mirrored in repro_torch/kernels/tiles.py).
inline bool idct_tile_shape(int e, int n, size_t max_smem, int rw,
                            IdctTile* out) {
  if (rw != 0 && rw != 4 && rw != 8) return false;
  IdctTile t;
  const int cg = (n + 3) / 4;
  t.cgt = cg <= 2 ? cg : 4 * ((cg + 3) / 4);
  t.cgw = t.cgt % 8 == 0 ? 8 : t.cgt < 4 ? t.cgt : 4;
  t.wgw = kWarp / t.cgw;
  t.cb = t.cgt / t.cgw;
  t.np = 4 * t.cgt;
  t.ep = 4 * (((e + 3) / 4) | 1);
  t.rw = rw != 0 ? rw : 8;
  t.sets = kIdctWarps / t.cb > 1 ? kIdctWarps / t.cb : 1;
  t.aw = kIdctWarps;
  for (;;) {
    t.sw = t.wgw * t.rw;
    t.bw = t.sets * t.sw;
    if (idct_carve(e, t).total <= max_smem) break;
    if (t.rw > 4) {
      if (rw != 0) return false;  // a forced 8 that does not fit
      t.rw = 4;
    } else if (t.aw > 1) {
      t.aw /= 2;
    } else {
      break;  // the launch reports the shared memory it cannot get
    }
  }
  *out = t;
  return true;
}

// Start copying the `bytes` level bytes at `src` into `buf` at
// buf + (src % 16), by the lanes of one warp: single bytes up to src's
// first 16-byte boundary, then 16 bytes a cp.async.  The caller commits
// the group.
__device__ __forceinline__ void stage_levels_async(uint8_t* buf,
                                                   const uint8_t* src,
                                                   int bytes, int lane) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(bytes, (16 - mis) & 15);
  uint8_t* dst = buf + mis;
  if (lane < head) dst[lane] = src[lane];
  const int rest = bytes - head;
  for (int c = lane; 16 * c < rest; c += kWarp) {
    const int left = rest - 16 * c;
    cp_async16(dst + head + 16 * c, src + head + 16 * c,
               left >= 16 ? 16 : left);
  }
}

// One coefficient: the table row of its band, `tk`, at its level.
__device__ __forceinline__ float dequant_one(const float* tk, uint32_t lvl) {
  return tk[lvl];
}

// A set's coefficients, by the lanes of one warp: coef[w * ep + k] =
// table[k * 257 + lv[w * e + k]] for w < rows, k < e (the pad bands of the
// last 4-band group zero).
__device__ __forceinline__ void dequant_set(const uint8_t* lv, int rows,
                                            int e, int ep, const float* table,
                                            float* coef, int lane) {
  const int kq = (e + 3) >> 2;  // 4-band groups a window
  // one 32-bit read of four bands where they lie in one aligned word
  const bool words =
      (e & 3) == 0 && (reinterpret_cast<uintptr_t>(lv) & 3) == 0;
  Walk it(kq, lane, kWarp);  // item x: window it.r, band group it.j
  for (int x = lane; x < rows * kq; x += kWarp, it.step()) {
    const int k0 = 4 * it.j;
    const uint8_t* src = lv + it.r * e + k0;
    const float* tk = table + k0 * kTableStride;
    float4 v;
    if (words) {
      const uint32_t q = *reinterpret_cast<const uint32_t*>(src);
      v.x = dequant_one(tk, q & 255);
      v.y = dequant_one(tk + kTableStride, (q >> 8) & 255);
      v.z = dequant_one(tk + 2 * kTableStride, (q >> 16) & 255);
      v.w = dequant_one(tk + 3 * kTableStride, q >> 24);
    } else {
      v.x = dequant_one(tk, src[0]);
      v.y = k0 + 1 < e ? dequant_one(tk + kTableStride, src[1]) : 0.0f;
      v.z = k0 + 2 < e ? dequant_one(tk + 2 * kTableStride, src[2]) : 0.0f;
      v.w = k0 + 3 < e ? dequant_one(tk + 3 * kTableStride, src[3]) : 0.0f;
    }
    *reinterpret_cast<float4*>(coef + it.r * ep + k0) = v;
  }
}

// Dequant + iDCT of levels u8[num_windows, e] -> out f32[num_windows, n].
// Tiles are blocks of t.bw windows; CTA c walks tiles [c * tiles / G,
// (c + 1) * tiles / G) in order, warp w taking tasks w, w + aw, ... of
// each (task s * cb + b: set s, column block b), the next task's levels in
// flight while it transforms this one.  vec: n % 4 == 0 and out 16-byte
// aligned.
template <class Dequant, int RW>
__global__ void __launch_bounds__(kIdctThreads, 2)
    dequant_idct_kernel(const uint8_t* __restrict__ levels,
                        int64_t num_windows, int e, int n, IdctTile t,
                        int vec, const float* __restrict__ basis, Dequant dq,
                        float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const IdctCarve cv = idct_carve(e, t);
  float* s_table = reinterpret_cast<float*>(base);  // [E][257]
  float* s_basis = reinterpret_cast<float*>(base + cv.basis);  // [E][np]
  float* s_coef = reinterpret_cast<float*>(base + cv.coef);  // [aw][sw][ep]
  // [aw][2][lv_bytes]
  uint8_t* s_lv = reinterpret_cast<uint8_t*>(base + cv.lv);

  const int64_t tiles = (num_windows + t.bw - 1) / t.bw;
  const int64_t first = blockIdx.x * tiles / gridDim.x;
  const int64_t last = (blockIdx.x + 1) * tiles / gridDim.x;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(levels) & 15);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int ntask = t.sets * t.cb;
  const bool busy = warp < t.aw && warp < ntask;
  float* w_coef = s_coef + warp * t.sw * t.ep;
  uint8_t* w_lv = s_lv + warp * 2 * cv.lv_bytes;
  // a task: (tile, task index); its set's first window and its rows
  int64_t tile = first;
  int task = warp;
  auto set0 = [&](int64_t tl, int tk) {
    return tl * t.bw + static_cast<int64_t>(tk / t.cb) * t.sw;
  };
  auto rows_of = [&](int64_t tl, int tk) {
    const int64_t left = num_windows - set0(tl, tk);
    return static_cast<int>(left < 0 ? 0 : left < t.sw ? left : t.sw);
  };
  auto issue = [&](int64_t tl, int tk, int buf) {
    stage_levels_async(w_lv + buf * cv.lv_bytes, levels + set0(tl, tk) * e,
                       rows_of(tl, tk) * e, lane);
    cp_async_commit();
  };
  if (busy && tile < last) issue(tile, task, 0);
  for (int i = threadIdx.x; i < e * t.np; i += blockDim.x) {
    const int k = i / t.np;
    const int j = i - k * t.np;
    s_basis[i] = j < n ? basis[k * n + j] : 0.0f;
  }
  dq.build(s_table, s_coef, e);  // the coefficient buffers are its scratch
  __syncthreads();  // the only barrier: the basis and table are staged
  if (!busy) return;

  const int cgl = lane % t.cgw;
  const int wg = lane / t.cgw;
  for (int buf = 0; tile < last; buf ^= 1) {
    int64_t next_tile = tile;
    int next_task = task + t.aw;
    if (next_task >= ntask) {
      next_task = warp;
      ++next_tile;
    }
    if (next_tile < last) {
      issue(next_tile, next_task, buf ^ 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncwarp();  // this task's levels have landed
    const int rows = rows_of(tile, task);
    dequant_set(w_lv + buf * cv.lv_bytes + mis, rows, e, t.ep, s_table,
                w_coef, lane);
    __syncwarp();
    const int cg = (task % t.cb) * t.cgw + cgl;
    float acc[RW][4];
    fma_tile<RW>(w_coef + wg * t.ep, t.wgw * t.ep, s_basis + 4 * cg, t.np, e,
                 acc);
    float* o = out + (set0(tile, task) + wg) * n + 4 * cg;
    // the stores: a float4 a window where vec, else the columns < n
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (wg + t.wgw * i >= rows || 4 * cg >= n) continue;
      float* oi = o + static_cast<int64_t>(t.wgw) * i * n;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(oi),
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (4 * cg + c < n) __stcs(oi + c, acc[i][c]);
        }
      }
    }
    __syncwarp();  // the coefficients are read before the next dequant
    tile = next_tile;
    task = next_task;
  }
}

template <class Dequant>
using IdctKernel = void (*)(const uint8_t*, int64_t, int, int, IdctTile, int,
                            const float*, Dequant, float*);

template <class Dequant>
inline IdctKernel<Dequant> idct_kernel_for(int rw) {
  return rw == 8 ? dequant_idct_kernel<Dequant, 8>
                 : dequant_idct_kernel<Dequant, 4>;
}

// The launch geometry for one (E, N) on the current device: the tile shape,
// its shared memory, and the most CTAs the device holds at once.
struct IdctGeometry {
  IdctTile t;
  size_t smem;
  int64_t resident;
};

// Computed once per (device, kernel, E, N), raising the kernel's dynamic
// shared-memory limit on the device where it needs more than 48 KiB.  `rw`
// as idct_tile_shape takes it; a refused rw is cudaErrorInvalidValue.  A
// kernel serves one RW, and at one (E, N) a forced RW gives the tile the
// pick gives for that RW, so the cache's key needs no rw of its own.
template <class Dequant>
inline cudaError_t idct_geometry(int e, int n, int rw, IdctGeometry* g) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (!idct_tile_shape(e, n, static_cast<size_t>(max_smem), rw, &g->t)) {
    return cudaErrorInvalidValue;
  }
  g->smem = idct_carve(e, g->t).total;
  const void* k = reinterpret_cast<const void*>(idct_kernel_for<Dequant>(
      g->t.rw));
  // keyed by the kernel too: a process that loads two builds of these
  // kernels shares this cache between them
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, int64_t> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, k, e, n);
  auto it = cache.find(key);
  if (it != cache.end()) {
    g->resident = it->second;
    return cudaSuccess;
  }
  err = allow_smem(k, g->smem);
  if (err != cudaSuccess) return err;
  err = resident_ctas(k, kIdctThreads, g->smem, &g->resident);
  if (err != cudaSuccess) return err;
  cache.emplace(key, g->resident);
  return cudaSuccess;
}

// Launch over `levels` u8[num_windows, e] -> out f32[num_windows, n] on the
// current device: one CTA per resident slot, or one per tile where there
// are fewer tiles.  `rw`: 0 picks the register tile, 4 or 8 forces it.
template <class Dequant>
int launch_dequant_idct(const uint8_t* levels, int64_t num_windows, int e,
                        int n, const float* basis, Dequant dq, float* out,
                        int rw, cudaStream_t stream) {
  if (e < 1 || n < 1 || e > kMaxDim || n > kMaxDim ||
      (rw != 0 && rw != 4 && rw != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_windows <= 0) return 0;
  IdctGeometry g;
  cudaError_t err = idct_geometry<Dequant>(e, n, rw, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (num_windows + g.t.bw - 1) / g.t.bw;
  const int64_t ctas = tiles < g.resident ? tiles : g.resident;
  const int vec =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 1 : 0;
  idct_kernel_for<Dequant>(g.t.rw)<<<static_cast<unsigned>(ctas),
                                     kIdctThreads, g.smem, stream>>>(
      levels, num_windows, e, n, g.t, vec, basis, dq, out);
  FPTC_CHECK_LAUNCH();
  return 0;
}

}  // namespace fptc
