#!/usr/bin/env python3
"""Profile the DCT + quantize kernel (``levels_kernel`` in
``src/repro_torch/kernels/csrc/dct_quant.cuh``: K4's ``encode_levels``
and K5's ``dct_quant``) on one NVIDIA GPU.

    python3 levels_profile.py [--seed 0] [--reps 10]

Run from the root of a checkout.  On ``chip_smoke.py``'s 8 archive encode
buckets (128 rows of 2**18 samples; the four archival domains in v2 and in
v3 with prediction and zero planes) and a KV block of 2**21 windows of 16
samples, it times (CUDA events, mean of ``--reps`` after a warm-up) four
builds of the kernel, made with ``nvcc`` from the kernel's text with edits
at named places of ``dct_quant.cuh`` and ``common.cuh`` (the script stops
if a place is not found) into the kernels' gitignored build directory:

  * ``as_built`` — the kernel as the port builds it; its outputs are held
    against the port's own library (they must be equal);
  * ``no_quantizer`` — each level is the low bits of its coefficient in
    place of the 3-zone quantizer (the outputs are then wrong);
  * ``no_fma`` — the DCT chain stops after its first 4 samples;
  * ``neither`` — both: what is left is the copies, the prediction, the
    zero planes and the stores.

One JSON line per build: ms per bucket and summed (``encode_levels`` on
the dense rows), and K5's ms.  Before them, the time of ``torch.sum`` and
``clone`` of one bucket's rows, the card's practical read and copy rates
for those bytes.  The card's name and power limit come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
BUILD = os.path.join(HERE, "src", "repro_torch", "kernels", "build",
                     "levels_profile")
ARCHIVAL = [("biomedical", "mitbih", "delta"), ("seismic", "seismic", "delta"),
            ("power", "load_power", "linear2"),
            ("meteorological", "temperature", "linear2")]
# (file, its text, the replacement) for each edit
NO_QUANTIZER = [(
    "dct_quant.cuh",
    "#pragma unroll\n  for (int i = 0; i < RW; ++i) out[i] = 0;\n",
    "#pragma unroll\n  for (int i = 0; i < RW; ++i) out[i] = 0;\n"
    "  if (mu > -1.0f) {\n#pragma unroll\n    for (int i = 0; i < RW; ++i) {\n"
    "      out[i] = __float_as_uint(acc[i][0] + acc[i][1] + acc[i][2] +"
    " acc[i][3]);\n    }\n    return;\n  }\n")]
NO_FMA = [("common.cuh", "  for (; j + 4 <= n; j += 4) {",
           "  for (; j + 4 <= 4; j += 4) {"),
          ("common.cuh", "  for (; j < n; ++j) {  // n % 4 tail",
           "  for (; j < 0; ++j) {  // n % 4 tail")]
VARIANTS = {"as_built": [], "no_quantizer": NO_QUANTIZER, "no_fma": NO_FMA,
            "neither": NO_QUANTIZER + NO_FMA}


def build(name: str, edits, ops) -> ctypes.CDLL:
    """dct_quant.cu and encode_fused.cu with `edits` made to a copy of the
    sources, as one shared library."""
    out = os.path.join(BUILD, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    for fname, old, new in edits:
        path = os.path.join(out, fname)
        text = open(path).read()
        if old not in text:
            sys.exit("levels_profile: kernel text changed, not found in "
                     f"{fname}: {old!r}")
        open(path, "w").write(text.replace(old, new, 1))
    so = os.path.join(out, f"levels_{name}.so")
    subprocess.run([ops._nvcc(), *ops._FLAGS, "-shared", "-o", so,
                    os.path.join(out, "dct_quant.cu"),
                    os.path.join(out, "encode_fused.cu")],
                   check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    for fn in ("fptc_encode_levels", "fptc_dct_quant"):
        getattr(lib, fn).argtypes = ops._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("levels_profile: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, dct
    from repro_torch.data import make_signal
    from repro_torch.kernels import dct_quant as dq
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import ops

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    # the archive encode buckets of chip_smoke.py, and a KV block
    samples, buckets = 1 << 18, []
    for d, (dom, ds, pred) in enumerate(ARCHIVAL):
        strip = make_signal(ds, samples, seed=args.seed * 1000 + d)
        sigs = [make_signal(ds, samples, seed=args.seed * 1000 + 100 + 8 * d
                            + i) for i in range(4)]
        x = torch.from_numpy(np.stack(sigs * 32)).cuda()
        for v3 in (False, True):
            cfg = DOMAIN_DEFAULTS[dom]
            if v3:
                cfg = cfg.replace(predictor=pred, predict_bands=2,
                                  zero_planes=True)
            tab = calibrate(strip, cfg, domain_id=d, seed=args.seed)
            buckets.append(dict(
                name=f"{dom} e={cfg.e} {'v3' if v3 else 'v2'}", x=x, cfg=cfg,
                q=tab.device_tables("cuda").quant,
                basis=dct.dct_basis(cfg.n, cfg.e, device="cuda"),
                counts=torch.full((128,), samples // cfg.n * cfg.e,
                                  dtype=torch.int32, device="cuda")))
    rng = np.random.default_rng(args.seed)
    kv = np.cumsum(rng.standard_normal((8192, 4096), dtype=np.float32),
                   axis=1) * np.float32(0.05)
    kv_tab = calibrate(kv.ravel(), DOMAIN_DEFAULTS["kv"], domain_id=8,
                       seed=args.seed)
    kv_win = torch.from_numpy(kv).cuda().reshape(-1, 16)
    kv_q = kv_tab.device_tables("cuda").quant
    kv_basis = dct.dct_basis(16, 16, device="cuda")

    x0 = buckets[0]["x"]
    print(json.dumps({"torch_sum_ms": ms(lambda: x0.sum(dim=1)),
                      "torch_clone_ms": ms(lambda: x0.clone()),
                      "bytes": 4 * x0.numel()}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def levels(lib, b):
        k, wp = b["x"].shape[0], b["x"].shape[1] // b["cfg"].n
        pred_id, bands, zplanes = b["cfg"].coding
        out = [torch.empty(k, wp, b["cfg"].e, dtype=torch.uint8,
                           device="cuda")]
        if zplanes:
            out += [torch.empty(k, wp, dtype=torch.bool, device="cuda"),
                    torch.empty(k, b["cfg"].e, dtype=torch.bool,
                                device="cuda"),
                    torch.empty(k, dtype=torch.int32, device="cuda")]
        scratch = torch.zeros(k, b["cfg"].e + 2, dtype=torch.int32,
                              device="cuda")

        def run():
            if zplanes:
                scratch.zero_()
            ptrs = [t.data_ptr() for t in out] + [None] * (4 - len(out))
            q = b["q"]
            rc = lib.fptc_encode_levels(
                b["x"].data_ptr(), b["counts"].data_ptr(), k, wp,
                b["cfg"].n, b["cfg"].e, b["basis"].data_ptr(),
                q.zone.data_ptr(), q.scale.data_ptr(), q.mu.data_ptr(),
                q.alpha1.data_ptr(), pred_id, bands, int(zplanes), *ptrs,
                scratch.data_ptr() if zplanes else None, 0, stream)
            if rc != 0:
                sys.exit(f"levels_profile: launch failed ({rc})")
        return run, out

    for name, edits in VARIANTS.items():
        lib = build(name, edits, ops)
        res, total = {"build": name, "encode_levels_ms": {}}, 0.0
        for b in buckets:
            run, out = levels(lib, b)
            t = ms(run)
            res["encode_levels_ms"][b["name"]] = t
            total += t
            if name == "as_built":
                want = ef.encode_levels(b["x"], b["counts"], b["q"],
                                        b["basis"], n=b["cfg"].n,
                                        e=b["cfg"].e, coding=b["cfg"].coding)
                same = torch.equal(out[0], want[0]) and (
                    len(out) == 1 or all(torch.equal(g, w) for g, w in zip(
                        out[1:], (want[1], want[2], want[3]))))
                res.setdefault("equal_port", []).append(same)
        res["encode_levels_total_ms"] = total
        k5 = torch.empty(kv_win.shape[0], 16, dtype=torch.uint8,
                         device="cuda")

        def run_k5():
            rc = lib.fptc_dct_quant(
                kv_win.data_ptr(), kv_win.shape[0], 16, 16,
                kv_basis.data_ptr(), kv_q.zone.data_ptr(),
                kv_q.scale.data_ptr(), kv_q.mu.data_ptr(),
                kv_q.alpha1.data_ptr(), k5.data_ptr(), stream)
            if rc != 0:
                sys.exit(f"levels_profile: launch failed ({rc})")
        res["dct_quant_ms"] = ms(run_k5)
        if name == "as_built":
            res["dct_quant_equal_port"] = bool(torch.equal(
                k5, dq.dct_quant(kv_win, kv_q, e=16, basis=kv_basis)))
        print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
