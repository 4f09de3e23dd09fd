#!/usr/bin/env python3
"""Profile the dequant + iDCT kernel (``dequant_idct_kernel`` in
``src/repro_torch/kernels/csrc/dequant_idct.cuh``: K2's ``lut_idct`` and
K3's ``idct_dequant``) on one NVIDIA GPU.

    python3 idct_profile.py [--seed 0] [--reps 10]

Run from the root of a checkout.  On ``chip_smoke.py``'s 8 archive decode
buckets (2**20 windows of N = 32 each: the levels of 128 rows of 2**18
samples under each of the four archival domains' plans, in v2 and in v3)
and its KV block (2**21 windows of 16: one layer's K cache), it times (CUDA
events, mean of ``--reps`` after a warm-up) four builds of the kernel, made
with ``nvcc`` from the kernels' text with edits at named places of
``dequant_idct.cuh`` and ``common.cuh`` (the script stops if a place is not
found) into the kernels' gitignored build directory:

  * ``as_built`` — the kernel as the port builds it; its outputs are held
    against the port's own library (they must be equal);
  * ``no_dequant`` — each coefficient is its level cast to float in place
    of the table read (``dequant_one``; the outputs are then wrong);
  * ``no_fma`` — the FMA chains stop after their first 4 bands;
  * ``no_stores`` — every output is computed and none is stored.

The port's library is loaded first and every variant beside it, in one
process: the case for which the kernel's geometry cache is keyed by the
kernel.  One JSON line per build: ``lut_idct``'s ms per bucket and summed,
K3's ms on the KV block, and ``lut_idct``'s there with the KV table's LUT
(K3 less that: the cost of building its table on the device).  Before
them, the ``ptxas`` registers and spills of each instantiation of the
template, and the time of ``zero_`` and ``clone`` of one bucket's output
(128 MiB), the card's practical write and copy rates for those bytes.  The
card's name and power limit come last.
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
                     "idct_profile")
ARCHIVAL = [("biomedical", "mitbih", "delta"), ("seismic", "seismic", "delta"),
            ("power", "load_power", "linear2"),
            ("meteorological", "temperature", "linear2")]
# (file, its text, the replacement) for each edit
NO_DEQUANT = [("dequant_idct.cuh", "  return tk[lvl];\n",
               "  return static_cast<float>(lvl);\n")]
NO_FMA = [("common.cuh", "  for (; j + 4 <= n; j += 4) {",
           "  for (; j + 4 <= 4; j += 4) {"),
          ("common.cuh", "  for (; j < n; ++j) {  // n % 4 tail",
           "  for (; j < 0; ++j) {  // n % 4 tail")]
# store only a NaN payload that no chain gives, so the chains stay live
NO_STORES = [("dequant_idct.cuh",
              "      if (wg + t.wgw * i >= rows || 4 * cg >= n) continue;\n",
              "      if (wg + t.wgw * i >= rows || 4 * cg >= n ||\n"
              "          __float_as_uint(acc[i][0]) != 0x7fc00001u) {\n"
              "        continue;\n      }\n")]
VARIANTS = {"as_built": [], "no_dequant": NO_DEQUANT, "no_fma": NO_FMA,
            "no_stores": NO_STORES}
EXPORTS = ("fptc_lut_idct", "fptc_idct_dequant")


def build(name: str, edits, ops):
    """decode_fused.cu and idct_dequant.cu with `edits` made to a copy of
    the sources, as one shared library; and nvcc's output."""
    out = os.path.join(BUILD, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    for fname, old, new in edits:
        path = os.path.join(out, fname)
        text = open(path).read()
        if old not in text:
            sys.exit("idct_profile: kernel text changed, not found in "
                     f"{fname}: {old!r}")
        open(path, "w").write(text.replace(old, new, 1))
    so = os.path.join(out, f"idct_{name}.so")
    res = subprocess.run([ops._nvcc(), *ops._FLAGS, "-shared", "-o", so,
                          os.path.join(out, "decode_fused.cu"),
                          os.path.join(out, "idct_dequant.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"idct_profile: nvcc failed on {name}:\n{res.stdout}"
                 f"{res.stderr}")
    lib = ctypes.CDLL(so)
    for fn in EXPORTS:
        getattr(lib, fn).argtypes = ops._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, res.stdout + res.stderr


def ptxas_lines(log: str):
    """Per instantiation of dequant_idct_kernel: its mangled name and
    ptxas's lines on it (stack, spills, registers, shared memory)."""
    found, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if "dequant_idct_kernel" not in name:
                name = None
            else:
                found.append({"kernel": name, "ptxas": []})
        elif name and ("spill" in line or "registers" in line):
            found[-1]["ptxas"].append(line.split(":", 1)[-1].strip())
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("idct_profile: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, dct
    from repro_torch.core.quantize import quant_grid
    from repro_torch.data import make_signal
    from repro_torch.kernels import dct_quant as dq
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import idct_dequant as idq
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False

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

    ops.library()  # the port's build, loaded before the variants
    # the archive decode buckets of chip_smoke.py: each plan's levels of 4
    # distinct 2**18-sample signals x 32, and a KV block
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
            q = calibrate(strip, cfg, domain_id=d,
                          seed=args.seed).device_tables("cuda").quant
            counts = torch.full((128,), samples // cfg.n * cfg.e,
                                dtype=torch.int32, device="cuda")
            levels = ef.encode_levels(x, counts, q, dct.dct_basis(
                cfg.n, cfg.e, device="cuda"), n=cfg.n, e=cfg.e)[0]
            buckets.append(dict(
                name=f"{dom} e={cfg.e} {'v3' if v3 else 'v2'}",
                levels=levels.reshape(-1, cfg.e), n=cfg.n, e=cfg.e,
                lut=quant_grid(q)[0].contiguous(),
                basis=dct.idct_basis(cfg.n, cfg.e, device="cuda")))
        del x
    rng = np.random.default_rng(args.seed)
    kv = np.cumsum(rng.standard_normal((8192, 4096), dtype=np.float32),
                   axis=1) * np.float32(0.05)
    kv += rng.standard_normal((8192, 1)).astype(np.float32)
    kv_tab = calibrate(kv.ravel(), DOMAIN_DEFAULTS["kv"], domain_id=8,
                       seed=args.seed)
    kv_q = kv_tab.device_tables("cuda").quant
    kv_levels = dq.dct_quant(torch.from_numpy(kv).cuda().reshape(-1, 16),
                             kv_q, e=16,
                             basis=dct.dct_basis(16, 16, device="cuda"))
    kv_basis = dct.idct_basis(16, 16, device="cuda")
    kv_bucket = dict(levels=kv_levels, e=16, n=16, basis=kv_basis,
                     lut=quant_grid(kv_q)[0].contiguous())

    out0 = torch.empty(buckets[0]["levels"].shape[0], buckets[0]["n"],
                       device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def lut_run(lib, b, out):
        def run():
            rc = lib.fptc_lut_idct(
                b["levels"].data_ptr(), b["levels"].shape[0], b["e"],
                b["n"], b["lut"].data_ptr(), b["basis"].data_ptr(),
                out.data_ptr(), 0, stream)
            if rc != 0:
                sys.exit(f"idct_profile: lut_idct launch failed ({rc})")
        return run

    def k3_run(lib, out):
        def run():
            rc = lib.fptc_idct_dequant(
                kv_levels.data_ptr(), kv_levels.shape[0], 16, 16,
                kv_q.zone.data_ptr(), kv_q.scale.data_ptr(),
                kv_q.mu.data_ptr(), kv_q.alpha1.data_ptr(),
                kv_basis.data_ptr(), out.data_ptr(), stream)
            if rc != 0:
                sys.exit(f"idct_profile: idct_dequant launch failed ({rc})")
        return run

    first = True
    for name, edits in VARIANTS.items():
        lib, log = build(name, edits, ops)
        if first:
            print(json.dumps({"ptxas": ptxas_lines(log)}), flush=True)
            print(json.dumps({"torch_zero_ms": ms(lambda: out0.zero_()),
                              "torch_clone_ms": ms(lambda: out0.clone()),
                              "bytes": 4 * out0.numel()}), flush=True)
            first = False
        res, total = {"build": name, "lut_idct_ms": {}}, 0.0
        for b in buckets:
            out = torch.empty(b["levels"].shape[0], b["n"], device="cuda")
            t = ms(lut_run(lib, b, out))
            res["lut_idct_ms"][b["name"]] = t
            total += t
            if name == "as_built":
                res.setdefault("equal_port", []).append(bool(torch.equal(
                    out, df.lut_idct(b["levels"], b["lut"], b["basis"]))))
            del out
        res["lut_idct_total_ms"] = total
        k3 = torch.empty(kv_levels.shape[0], 16, device="cuda")
        res["idct_dequant_ms"] = ms(k3_run(lib, k3))
        if name == "as_built":
            res["idct_dequant_equal_port"] = bool(torch.equal(
                k3, idq.idct_dequant(kv_levels, kv_q, kv_basis)))
        res["lut_idct_kv_ms"] = ms(lut_run(lib, kv_bucket, k3))
        print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
