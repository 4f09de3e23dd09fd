#!/usr/bin/env python3
"""Profile K4's SymLen pack kernel (``symlen_pack``) on one NVIDIA GPU.

    python3 pack_profile.py [--seed 0]

Run from the root of a checkout.  On three archive buckets of
``chip_smoke.py``'s shape (128 rows of 2**18 samples: seismic v2, e = 32;
biomedical v2, e = 16; meteorological v3 linear2 with zero planes, e = 8),
their grids made by ``encode_levels`` on the card, it prints one JSON line
per bucket and mode (1024-symbol chunks over the 128 rows; exact mode over
4 rows):

  * ``ms`` — the kernel as the port launches it (CUDA events, mean of 20
    after a warm-up), and ``equal_plain`` — its outputs against
    ``symlen_pack_plain`` (chunked mode);
  * ``no_stores_ms`` — the same kernel with every global store of the parts
    left out (the outputs are then wrong: a measure of how far the bytes
    bound it);
  * ``cycles_per_tile`` — a ``clock64`` breakdown by phase (lane 0 after a
    warp sync, summed over the CTAs, divided by their tiles), and
    ``final_cycles`` (the zero fill) per CTA, from a build with phase marks
    (the marks add syncs and registers: read the shares, not the sums).

The two variants are built with ``nvcc`` from the kernel's text in
``src/repro_torch/kernels/csrc/encode_fused.cu`` (marks and a store switch
added at named places; the script stops if a place is not found) into the
kernels' gitignored build directory.  The card's name and power limit come
last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
BUILD = os.path.join(HERE, "src", "repro_torch", "kernels", "build",
                     "pack_profile")
PHASES = ("load+valid", "len+scan", "walk", "word scans", "or",
          "segmented scan", "emit+carry")
# (text in the kernel, what goes before it): a phase mark ends each phase
MARKS = [
    ("    // (2) bit offsets", "    PHASE(0);\n"),
    ("    // (3) the word starts", "    PHASE(1);\n"),
    ("    // (4) each slot's word", "    PHASE(2);\n"),
    ("    // the lane's codewords: a word that starts", "    PHASE(3);\n"),
    ("    // segmented OR scan of the tails", "    PHASE(4);\n"),
    ("    // (5) words [0, nst) are finished", "    PHASE(5);\n"),
]


def variant_source() -> str:
    """The pack kernel as a template on <kProf, kStores> with a launcher."""
    src = open(os.path.join(CSRC, "encode_fused.cu")).read()
    a = src.index("// Up to 8 grid bytes at src")
    b = src.index("template <bool kGather>\nint launch_encode_levels(")
    kern = src[a:b]

    def sub(old, new):
        nonlocal kern
        if old not in kern:
            sys.exit(f"pack_profile: kernel text changed, not found: {old!r}")
        kern = kern.replace(old, new, 1)

    sub("__global__ void __launch_bounds__(fptc::kWarp, 32)\n"
        "    symlen_pack_kernel(",
        "template <bool kProf, bool kStores>\n"
        "__global__ void __launch_bounds__(fptc::kWarp, 32)\n"
        "    symlen_pack_kernel(unsigned long long* prof, ")
    sub("  const int lane = threadIdx.x;\n",
        "  const int lane = threadIdx.x;\n"
        "  long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long tc = clock64();\n"
        "#define PHASE(k) if constexpr (kProf) { __syncwarp(); if (lane == 0)"
        " { const long long t_ = clock64(); tp[k] += t_ - tc; tc = t_; } }\n")
    for text, mark in MARKS:
        sub(text, mark + text)
    sub("    __syncwarp();  // every lane has read the words before the next "
        "tile\n",
        "    __syncwarp();  // every lane has read the words before the next "
        "tile\n    PHASE(6);\n")
    sub("      o_hi[w_open + w] = s_hi[w];",
        "      if (!kStores) continue;\n      o_hi[w_open + w] = s_hi[w];")
    sub("  if (open && lane == 0) {", "  if (kStores && open && lane == 0) {")
    sub("  zero_parts(o_hi, o_lo, o_sl, w_open + open, chunk, lane);",
        "  if (kStores) zero_parts(o_hi, o_lo, o_sl, w_open + open, chunk, "
        "lane);")
    sub("  if (__any_sync(kAll, gap) && check_gaps && lane == 0) bad[row] = 1;"
        "\n}",
        "  if (__any_sync(kAll, gap) && check_gaps && lane == 0) bad[row] = 1;"
        "\n  PHASE(7);\n  if (kProf && lane == 0) {\n"
        "    for (int k = 0; k < 8; ++k) atomicAdd(prof + k,"
        " static_cast<unsigned long long>(tp[k]));\n  }\n}")
    launch = """
FPTC_EXPORT int profile_symlen_pack(
    int variant, void* prof, const void* grid, const void* zrow,
    const void* zcol, const void* counts, int64_t k, int64_t wp, int64_t e,
    int64_t num_chunks, int64_t chunk, int64_t v3, const void* codes,
    const void* lengths, int64_t check_gaps, void* hi, void* lo, void* sl,
    void* wpc, void* bad, void* stream) {
  const unsigned total = static_cast<unsigned>(k * num_chunks);
  auto* p = static_cast<unsigned long long*>(prof);
#define PACK_ARGS p, static_cast<const uint8_t*>(grid), \\
      static_cast<const uint8_t*>(zrow), static_cast<const uint8_t*>(zcol), \\
      static_cast<const int32_t*>(counts), wp, static_cast<int>(e), \\
      num_chunks, chunk, static_cast<int>(v3 != 0), \\
      static_cast<const int64_t*>(codes), \\
      static_cast<const int32_t*>(lengths), static_cast<int>(check_gaps), \\
      static_cast<uint32_t*>(hi), static_cast<uint32_t*>(lo), \\
      static_cast<int32_t*>(sl), static_cast<int32_t*>(wpc), \\
      static_cast<uint8_t*>(bad)
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    symlen_pack_kernel<false, false><<<total, fptc::kWarp, 0, st>>>(PACK_ARGS);
  } else {
    symlen_pack_kernel<true, true><<<total, fptc::kWarp, 0, st>>>(PACK_ARGS);
  }
  FPTC_CHECK_LAUNCH();
  return 0;
}
"""
    head = ("#include <climits>\n#include \"common.cuh\"\nnamespace {\n"
            "constexpr int kPackPer = 8;\n"
            "constexpr int kPackTile = fptc::kWarp * kPackPer;\n")
    return head + kern + "}  // namespace\n" + launch


def build() -> ctypes.CDLL:
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, "pack_variants.cu")
    so = os.path.join(BUILD, "pack_variants.so")
    with open(cu, "w") as f:
        f.write(variant_source())
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-std=c++17", "-O3",
                    "-gencode=arch=compute_90a,code=sm_90a", "-Xcompiler",
                    "-fPIC", "-shared", "-I", CSRC, "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.profile_symlen_pack.argtypes = [ctypes.c_int, P, P, P, P, P, I, I, I,
                                        I, I, I, P, P, I, P, P, P, P, P, P]
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("pack_profile: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, dct
    from repro_torch.data import make_signal
    from repro_torch.kernels import encode_fused as ef

    lib = build()

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    samples = 1 << 18
    for dom, ds, pred in (("seismic", "seismic", None),
                          ("biomedical", "mitbih", None),
                          ("meteorological", "temperature", "linear2")):
        cfg = DOMAIN_DEFAULTS[dom]
        if pred:
            cfg = cfg.replace(predictor=pred, predict_bands=2,
                              zero_planes=True)
        tab = calibrate(make_signal(ds, samples, seed=args.seed), cfg)
        sigs = [make_signal(ds, samples, seed=args.seed + 10 + i)
                for i in range(4)]
        x = torch.from_numpy(np.stack(sigs * 32)).cuda()
        dt = tab.device_tables("cuda")
        wp = samples // cfg.n
        counts = torch.full((128,), wp * cfg.e, dtype=torch.int32,
                            device="cuda")
        grid = ef.encode_levels(x, counts, dt.quant,
                                dct.dct_basis(cfg.n, cfg.e, device="cuda"),
                                n=cfg.n, e=cfg.e, coding=cfg.coding)[:3]
        for chunk, rows in ((1024, 128), (wp * cfg.e, 4)):
            ins = [None if t is None else t[:rows].contiguous()
                   for t in grid]
            cnt = counts[:rows].contiguous()
            kw = dict(chunk_size=chunk, coding=cfg.coding, check_gaps=False)
            got = ef.symlen_pack(*ins, cnt, dt.codes, dt.lengths, **kw)
            res = {"bucket": f"{dom} e={cfg.e} coding={cfg.coding}",
                   "chunk": chunk, "rows": rows,
                   "words": int(got[3].sum()),
                   "ms": ms(lambda: ef.symlen_pack(*ins, cnt, dt.codes,
                                                   dt.lengths, **kw))}
            if chunk == 1024:
                want = ef.symlen_pack_plain(*ins, cnt, dt.codes, dt.lengths,
                                            **kw)
                res["equal_plain"] = all(torch.equal(a, b)
                                         for a, b in zip(got, want))
            nch = got[3].shape[1]
            outs = [torch.empty_like(t) for t in got[:4]] + [
                torch.zeros_like(got[4])]
            prof = torch.zeros(8, dtype=torch.int64, device="cuda")

            def run(variant):
                rc = lib.profile_symlen_pack(
                    variant, prof.data_ptr(), ins[0].data_ptr(),
                    *(None if t is None else t.data_ptr() for t in ins[1:]),
                    cnt.data_ptr(), rows, wp, cfg.e, nch, chunk,
                    int(cfg.coding != (0, 0, False)), dt.codes.data_ptr(),
                    dt.lengths.data_ptr(), 0,
                    *(t.data_ptr() for t in outs),
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    sys.exit(f"pack_profile: launch failed ({rc})")

            res["no_stores_ms"] = ms(lambda: run(0))
            prof.zero_()
            run(1)
            torch.cuda.synchronize()
            res["equal_marked"] = all(torch.equal(a, b)
                                      for a, b in zip(outs[:4], got[:4]))
            ctas = rows * nch
            tiles = ctas * -(-min(chunk, wp * cfg.e) // 256)
            cyc = prof.tolist()
            res["cycles_per_tile"] = {p: round(c / tiles)
                                      for p, c in zip(PHASES, cyc)}
            res["final_cycles"] = round(cyc[7] / ctas)
            print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
