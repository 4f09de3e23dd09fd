#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched decode path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it builds the CUDA decode kernels from
``src/repro_torch/kernels/csrc`` on first use.  Phases, one JSON line each:

  1. device — the card (and, on its own line, ``nvidia-smi``'s name and
     power limit); fails when no CUDA device is present;
  2. build  — the ``nvcc`` build of the kernel library, in seconds;
  3. data   — per archival domain, tables calibrated on a 2**18-sample
     strip, and 4 distinct 2**18-sample signals host-encoded per plan key
     for 8 plan keys (the four domains in v2, plus v3 with delta or
     linear2 prediction and zero planes), replicated to 128 containers per
     key: 1024 containers, 2**28 samples, 1 GiB of f32 output in 8 buckets;
     plus one layer's K cache of an 8B-class model (batch 8 x 8 KV heads x
     128 head dims at 4096 tokens) as fixed-rate levels u8[8192, 256, 16];
  4. check  — every CUDA kernel against its plain PyTorch version on the
     card, at the main path's shapes: K1's symbols and the v3 stage's levels
     exactly, the LUT-iDCT's and K3's floats within ``max|d| <= 1e-5 *
     max|plain|``; then K2 as a whole (its three kernels in a row);
  5. main   — with every launch counter set to 0: ``BatchDecoder().decode
     (archive).to_host()`` and ``decode_fixed`` of the KV block, then the
     counters (K2's ``symlen_decode`` and ``lut_idct`` once per bucket,
     ``v3_unpredict`` once per v3 bucket, K3's ``idct_dequant`` once), and
     the decoded signals against the host reference ``codec.decode``;
  6. times  — per kernel, CUDA-event ms after warm-up beside the plain
     version's ms and the card's bound for the same work.

Then the ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
...}``.  Any failed check exits non-zero before the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (H100 SXM data sheet): device-memory rate and
# fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
REL_TOL = 1e-5  # floats: max|kernel - plain| <= REL_TOL * max|plain|

ARCHIVAL = [  # (domain, dataset, v3 predictor)
    ("biomedical", "mitbih", "delta"),
    ("seismic", "seismic", "delta"),
    ("power", "load_power", "linear2"),
    ("meteorological", "temperature", "linear2"),
]
# the CUDA kernels, each under its launch counter's name: K1's decode (also
# K2's first stage), K2's two later stages, and K3
SOURCES = {
    "symlen_decode": ("src/repro_torch/kernels/csrc/symlen_decode.cu",
                      "src/repro/kernels/huffman_decode.py:297"),
    "v3_unpredict": ("src/repro_torch/kernels/csrc/decode_fused.cu",
                     "src/repro/kernels/decode_fused.py:305"),
    "lut_idct": ("src/repro_torch/kernels/csrc/decode_fused.cu",
                 "src/repro/kernels/decode_fused.py:305"),
    "idct_dequant": ("src/repro_torch/kernels/csrc/idct_dequant.cu",
                     "src/repro/kernels/idct_dequant.py:104"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean ms per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def int_err(a, b) -> float:
    """max|a - b| of two integer tensors (0 when they are equal)."""
    return float((a.int() - b.int()).abs().max()) if a.numel() else 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # -- 1. device -----------------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    import numpy as np

    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, decode, encode
    from repro_torch.core import dct, quantize
    from repro_torch.data import make_signal
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import huffman_decode as hd
    from repro_torch.kernels import idct_dequant as idq
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchDecoder, streams_from_containers
    from repro_torch.serving.engine import symlen_bucket

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    ops.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "log_lines": len(ops.build_log().splitlines())})

    # -- 3. data ---------------------------------------------------------------
    t0 = time.perf_counter()
    samples, distinct, replicas = 1 << 18, 4, 32
    tables, keys, pool = {}, [], {}
    for d, (dom, ds, pred) in enumerate(ARCHIVAL):
        strip = make_signal(ds, samples, seed=args.seed * 1000 + d)
        sigs = [make_signal(ds, samples, seed=args.seed * 1000 + 100 + 8 * d + i)
                for i in range(distinct)]
        for v3, did in ((False, d), (True, d + len(ARCHIVAL))):
            cfg = DOMAIN_DEFAULTS[dom]
            if v3:
                cfg = cfg.replace(predictor=pred, predict_bands=2,
                                  zero_planes=True)
            tab = calibrate(strip, cfg, domain_id=did, seed=args.seed)
            tables[did] = tab
            cs = [encode(s, tab) for s in sigs]
            keys.append(cs[0].plan_key)
            pool[did] = (cs, sigs)
    # the archive interleaves the plan keys: 8 keys x 4 signals x 32
    archive, source = [], []
    for _ in range(replicas):
        for did, (cs, _) in pool.items():
            for i, c in enumerate(cs):
                archive.append(c)
                source.append((did, i))
    n_out = sum(c.signal_length for c in archive)
    # one layer's K cache: [batch 8, kv heads 8, head dim 128, 4096 tokens]
    rng = np.random.default_rng(args.seed)
    tokens, channels = 4096, 8 * 8 * 128
    kv = np.cumsum(rng.standard_normal((channels, tokens), dtype=np.float32),
                   axis=1) * np.float32(0.05)
    kv += rng.standard_normal((channels, 1)).astype(np.float32)
    kv_tab = calibrate(kv.ravel(), DOMAIN_DEFAULTS["kv"], domain_id=8,
                       seed=args.seed)
    kv_gpu = torch.from_numpy(kv).cuda()
    kv_coef = dct.forward_dct(dct.window_signal(kv_gpu, 16), 16)
    kv_levels = quantize.quantize(kv_coef, kv_tab.quant.to("cuda"))
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "containers": len(archive), "plan_keys": len(keys),
          "samples_out": n_out, "bytes_out": 4 * n_out,
          "archive_bytes": sum(c.compressed_bytes for c in archive),
          "kv_levels": list(kv_levels.shape)})

    # -- 4. kernels vs plain, at the main path's shapes -------------------------
    t0 = time.perf_counter()
    groups, _ = streams_from_containers(archive)
    dec = BatchDecoder()
    by_key = {c.plan_key: c for c in archive}
    buckets = []
    for grp in groups:
        plan = dec.plan_for(by_key[grp.plan_key], tables)
        nw = dec.scheduler.round(grp.total_windows)
        v3 = None
        if grp.v3_idx is not None:
            v3 = (torch.from_numpy(grp.v3_idx).cuda(),
                  torch.from_numpy(grp.v3_seg).cuda())
        buckets.append(dict(
            grp=grp, plan=plan, v3=v3, nw=nw,
            words=grp.words.cuda(), symlen=grp.symlen.cuda(),
            ms=symlen_bucket(grp.max_symlen),
        ))
    # each CUDA kernel against its plain version on the same inputs, then K2
    # (its three kernels in a row) against its plain version as a whole
    checks = {"symlen_decode": [], "v3_unpredict": [], "lut_idct": [],
              "decode_fused": [], "idct_dequant": []}
    for b in buckets:
        p, kw = b["plan"], dict(l_max=b["plan"].l_max, max_symlen=b["ms"])
        key = str(b["grp"].plan_key)
        nsym = b["nw"] * p.e
        k1 = hd.huffman_decode_dense(b["words"], b["symlen"], p.tables,
                                     num_symbols=nsym, **kw)
        k1p = hd.huffman_decode_plain(b["words"], b["symlen"], p.tables,
                                      num_symbols=nsym, **kw)
        lv_kw = dict(num_windows=b["nw"], e=p.e, coding=p.coding, **kw)
        lvp = df.bucket_levels_plain(b["words"], b["symlen"], p.tables,
                                     b["v3"], **lv_kw)
        if b["v3"] is not None:
            v3_kw = dict(num_windows=b["nw"], e=p.e, pred_id=p.coding[0],
                         bands=p.coding[1])
            un = df.v3_expand_unpredict_cuda(k1p, *b["v3"], **v3_kw)
            unp = df.v3_expand_unpredict_plain(k1p, *b["v3"], **v3_kw)
            cv = {"plan_key": key, "equal": bool(torch.equal(un, unp)),
                  "max_abs_err": int_err(un, unp)}
            checks["v3_unpredict"].append(cv)
            check(cv["equal"], f"v3 levels differ from plain: {cv}")
        li = df.lut_idct(lvp, p.lut, p.basis)
        lip = df.lut_idct_plain(lvp, p.lut, p.basis)
        lv = df.bucket_levels(b["words"], b["symlen"], p.tables, b["v3"],
                              **lv_kw)
        f_kw = dict(n=p.n, **lv_kw)
        k2 = df.decode_fused(b["words"], b["symlen"], p.tables, p.lut,
                             p.basis, b["v3"], **f_kw)
        k2p = df.decode_fused_plain(b["words"], b["symlen"], p.tables, p.lut,
                                    p.basis, b["v3"], **f_kw)
        torch.cuda.synchronize()
        c1 = {"plan_key": key, "symbols": nsym,
              "equal": bool(torch.equal(k1, k1p)),
              "max_abs_err": int_err(k1, k1p)}
        cl = {"plan_key": key, "max_abs_err": float((li - lip).abs().max()),
              "rel_err": rel_err(li, lip),
              "finite": bool(torch.isfinite(li).all())}
        c2 = {"plan_key": key,
              "levels_equal": bool(torch.equal(lv, lvp)),
              "max_abs_err": float((k2 - k2p).abs().max()),
              "rel_err": rel_err(k2, k2p),
              "finite": bool(torch.isfinite(k2).all())}
        checks["symlen_decode"].append(c1)
        checks["lut_idct"].append(cl)
        checks["decode_fused"].append(c2)
        check(c1["equal"], f"K1 symbols differ from plain: {c1}")
        check(cl["finite"] and cl["rel_err"] <= REL_TOL,
              f"LUT-iDCT differs from plain: {cl}")
        check(c2["levels_equal"] and c2["finite"]
              and c2["rel_err"] <= REL_TOL, f"K2 differs from plain: {c2}")
    kv_flat = kv_levels.reshape(-1, 16)
    kv_q = kv_tab.device_tables("cuda").quant
    kv_basis = dct.idct_basis(16, 16, device="cuda")
    k3 = idq.idct_dequant(kv_flat, kv_q, kv_basis)
    k3p = idq.idct_dequant_plain(kv_flat, kv_q, kv_basis)
    torch.cuda.synchronize()
    c3 = {"shape": list(kv_levels.shape),
          "max_abs_err": float((k3 - k3p).abs().max()),
          "rel_err": rel_err(k3, k3p), "finite": bool(torch.isfinite(k3).all())}
    checks["idct_dequant"].append(c3)
    check(c3["finite"] and c3["rel_err"] <= REL_TOL,
          f"K3 differs from plain: {c3}")
    emit({"phase": "check", "seconds": time.perf_counter() - t0,
          "tolerance": f"max|d| <= {REL_TOL} * max|plain|", **checks})
    del k1, k1p, lv, lvp, li, lip, k2, k2p, k3, k3p

    # -- 5. the main path ----------------------------------------------------------
    torch.cuda.synchronize()
    ops.reset_launches()
    up0, disp0 = dec.executor.stats.upload_s, dec.executor.stats.dispatch_s
    t0 = time.perf_counter()
    batch = dec.decode(archive, tables)
    t_decode = time.perf_counter() - t0
    out = batch.to_host()
    wall = time.perf_counter() - t0
    upload_s = dec.executor.stats.upload_s - up0
    dispatch_s = dec.executor.stats.dispatch_s - disp0
    t1 = time.perf_counter()
    kv_out = dec.decode_fixed(kv_levels, kv_tab, length=tokens)
    torch.cuda.synchronize()
    kv_wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    n_buckets = len(keys)
    n_v3 = sum(1 for k in keys if tuple(k[4]) != (0, 0, False))
    # K2 is symlen_decode, then v3_unpredict (v3 buckets), then lut_idct:
    # each once per bucket; K3 once for the KV block
    want = {"symlen_decode": n_buckets, "v3_unpredict": n_v3,
            "lut_idct": n_buckets, "idct_dequant": 1}
    check(launches == want, f"launch counts {launches} != expected {want}")
    # the distinct signals against the host reference decode; every replica
    # equal to its first copy; every v3 decode equal to its v2 twin
    ref, errs = {}, []
    for did, (cs, _) in pool.items():
        for i, c in enumerate(cs):
            ref[(did, i)] = decode(c, tables[did])
    first = {}
    for o, key in zip(out, source):
        check(o.shape == ref[key].shape and bool(np.isfinite(o).all()),
              f"bad output for {key}: shape {o.shape}")
        if key not in first:
            first[key] = o
            r = ref[key]
            err = float(np.abs(o - r).max()) / max(float(np.abs(r).max()), 1e-30)
            errs.append(err)
            check(err <= REL_TOL, f"signal {key} vs host decode: rel {err}")
        else:
            check(np.array_equal(o, first[key]), f"replica of {key} differs")
    v3_same = all(np.array_equal(first[(d, i)], first[(d + 4, i)])
                  for d in range(4) for i in range(distinct))
    check(v3_same, "a v3 decode differs from its v2 twin")
    kv_rel = float(torch.linalg.vector_norm(kv_out - kv_gpu)
                   / torch.linalg.vector_norm(kv_gpu))
    check(bool(torch.isfinite(kv_out).all()) and kv_rel < 0.05,
          f"KV fixed-rate reconstruction off: relative rms {kv_rel}")
    warm = []
    for _ in range(2):  # the same decode again: plans cached, allocator warm
        t0 = time.perf_counter()
        dec.decode(archive, tables).to_host()
        warm.append(time.perf_counter() - t0)
    emit({"phase": "main", "containers": len(archive), "buckets": n_buckets,
          "wall_s": wall, "decode_call_s": t_decode,
          "to_host_s": wall - t_decode, "upload_s": upload_s,
          "dispatch_s": dispatch_s, "warm_wall_s": warm,
          "containers_per_s": len(archive) / wall,
          "decoded_GB_per_s": 4 * n_out / wall / 1e9,
          "kv_decode_fixed_s": kv_wall, "kv_rel_rms_err": kv_rel,
          "launches": launches, "max_rel_err_vs_host": max(errs),
          "v3_equals_v2": v3_same})

    # -- 6. times -------------------------------------------------------------------
    # per kernel: [ms, plain ms, bytes moved, operations], summed over the
    # buckets; K2 as a whole (its three kernels in a row) beside them
    acc = {k: [0.0, 0.0, 0.0, 0.0] for k in
           ("symlen_decode", "v3_unpredict", "lut_idct", "decode_fused")}

    def add(name, ms, plain_ms, nbytes, ops_):
        for i, v in enumerate((ms, plain_ms, nbytes, ops_)):
            acc[name][i] += v

    for b in buckets:
        p, kw = b["plan"], dict(l_max=b["plan"].l_max, max_symlen=b["ms"])
        nsym, nw, w = b["nw"] * p.e, b["nw"], b["words"].shape[0]
        f_kw = dict(n=p.n, num_windows=nw, e=p.e, coding=p.coding, **kw)
        args1 = (b["words"], b["symlen"], p.tables)
        add("symlen_decode",
            cuda_ms(lambda: hd.huffman_decode_dense(
                *args1, num_symbols=nsym, **kw)),
            cuda_ms(lambda: hd.huffman_decode_plain(
                *args1, num_symbols=nsym, **kw), reps=2),
            9 * w + nsym, 0.0)
        dense = hd.huffman_decode_dense(*args1, num_symbols=nsym, **kw)
        if b["v3"] is not None:
            v3_kw = dict(num_windows=nw, e=p.e, pred_id=p.coding[0],
                         bands=p.coding[1])
            add("v3_unpredict",
                cuda_ms(lambda: df.v3_expand_unpredict_cuda(
                    dense, *b["v3"], **v3_kw)),
                cuda_ms(lambda: df.v3_expand_unpredict_plain(
                    dense, *b["v3"], **v3_kw), reps=2),
                nsym + 4 * nsym + 4 * nw + nsym, 0.0)
        levels = df.bucket_levels(*args1, b["v3"], num_windows=nw, e=p.e,
                                  coding=p.coding, **kw)
        lut_bytes = nsym + 4 * p.e * 256 + 4 * p.e * p.n + 4 * nw * p.n
        add("lut_idct",
            cuda_ms(lambda: df.lut_idct(levels, p.lut, p.basis)),
            cuda_ms(lambda: df.lut_idct_plain(levels, p.lut, p.basis)),
            lut_bytes, 2.0 * nw * p.e * p.n)
        args2 = (*args1, p.lut, p.basis, b["v3"])
        v3_bytes = 4 * (nsym + nw) if b["v3"] is not None else 0
        add("decode_fused",
            cuda_ms(lambda: df.decode_fused(*args2, **f_kw)),
            cuda_ms(lambda: df.decode_fused_plain(*args2, **f_kw), reps=2),
            9 * w + v3_bytes + lut_bytes - nsym, 2.0 * nw * p.e * p.n)
    rows = kv_flat.shape[0]
    acc["idct_dequant"] = [
        cuda_ms(lambda: idq.idct_dequant(kv_flat, kv_q, kv_basis)),
        cuda_ms(lambda: idq.idct_dequant_plain(kv_flat, kv_q, kv_basis)),
        rows * 16 + 4 * 16 * 16 + 8 * 16 + 4 * rows * 16,
        2.0 * rows * 16 * 16,
    ]
    times = {k: (ms, plain, *bound_ms(nb, fl))
             for k, (ms, plain, nb, fl) in acc.items()}
    emit({"phase": "times", "what": "ms summed over the 8 archive buckets "
          "(v3_unpredict over the 4 v3 buckets) and for the KV block "
          "(idct_dequant); CUDA events, mean of repeats after a warm-up; "
          "decode_fused is K2 as a whole: symlen_decode, v3_unpredict and "
          "lut_idct in a row",
          **{k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
                 "bound_by": v[3]} for k, v in times.items()}})

    # -- 7. the kernels line, and the last line ----------------------------------
    kernels = []
    for name, (srcfile, replaces) in SOURCES.items():
        ms, plain, bnd, by = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": srcfile,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
        })
    dec.close()
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
