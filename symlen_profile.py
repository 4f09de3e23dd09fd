#!/usr/bin/env python3
"""Profile the SymLen word decode (K1 ``symlen_decode`` and K6
``symlen_tile``, ``src/repro_torch/kernels/csrc/symlen_{decode,tile}.cu``)
on one NVIDIA GPU.

    python3 symlen_profile.py [--seed 0] [--reps 50] [--src DIR]
                              [--variants]

Run from the root of a checkout.  On ``chip_smoke.py``'s 8 archive decode
buckets (the host-encoded containers of 4 distinct 2**18-sample signals per
plan key, replicated to 128 per key, staged as the engine stages them) it
prints one JSON line per wrapper (``huffman_decode_dense``, K1, and
``huffman_decode_tile``, K6), summed over the buckets and per bucket:

  * ``device_us`` — device time per call by kernel name (CUDA kernels and
    memsets), from ``torch.profiler`` (``key_averages()``) over ``--reps``
    calls a bucket;
  * ``host_us`` — the wrapper's host time per call: ``perf_counter`` around
    ``--reps`` calls with no synchronization between them;
  * ``events_us`` — CUDA events around ``--reps`` back-to-back calls, as
    ``chip_smoke.py`` times them (host gaps included where the host is
    slower than the device);
  * ``queued_us`` — the same with the queue kept ahead of the device (a
    ``torch.cuda._sleep`` first, so the calls are all enqueued before the
    device reaches them; ``queued_ahead`` says whether they were): the
    device's time with no host gap.

``--src`` drives the ``repro_torch`` of another checkout's ``src`` (e.g.
the parent commit unpacked under the gitignored ``build/``).  With
``--variants`` it also builds, with ``nvcc``, variants of this checkout's
kernels from their text with edits at named places (the script stops if a
place is not found) into the kernels' gitignored build directory, loads
them beside the port's library, and times each by CUDA events with the
queue kept ahead:

  * ``as_built`` — the kernels as the port builds them; outputs held
    against the port's (they must be equal);
  * ``k1_cta_table`` — K1's decode CTAs build the decode table themselves
    (``build_lut`` in each CTA) in place of staging the one its first
    kernel built: the choice between a table per call and a table per CTA;
  * ``k6_table_twice`` — K6's CTAs build their table twice: the second
    build's time is the table's cost;
  * ``no_stores`` — K1 stores no output byte and K6 no slot (both outputs
    are then wrong): how far the stores bound them;
  * ``k1_lane_words_2`` / ``k1_lane_words_8`` — K1's lanes take 2 or 8
    consecutive words of a warp tile in place of 4; ``k1_six_ctas`` — K1's
    decode held to 40 registers, 6 CTAs an SM in place of 4.

The card's name and power limit come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
BUILD = os.path.join(HERE, "src", "repro_torch", "kernels", "build",
                     "symlen_profile")
ARCHIVAL = [("biomedical", "mitbih", "delta"), ("seismic", "seismic", "delta"),
            ("power", "load_power", "linear2"),
            ("meteorological", "temperature", "linear2")]
SLEEP_CYCLES = 40_000_000  # about 20 ms of device time at 1.98 GHz
# (file, its text, the replacement) for each edit; K1's decode kernel
# takes the decode tables for its own build of the table
K1_CTA_TABLE = [("symlen_decode.cu",
                 "const uint16_t* __restrict__ g_lut, int l_max,",
                 "const uint16_t* __restrict__ g_lut, DecodeTables dt, "
                 "int l_max,"),
                ("symlen_decode.cu",
                 "static_cast<const uint16_t*>(lut), static_cast<int>(l_max)",
                 "static_cast<const uint16_t*>(lut), dt, "
                 "static_cast<int>(l_max)"),
                ("symlen_decode.cu", "  stage_lut(s_lut, g_lut, l_max);\n",
                 "  {\n    __shared__ fptc::SymlenTables tab;\n"
                 "    fptc::load_symlen_tables(&tab, dt.limit, dt.first, "
                 "dt.rank, dt.syms, l_max);\n    __syncthreads();\n"
                 "    fptc::build_lut(s_lut, tab, l_max, threadIdx.x, "
                 "blockDim.x);\n  }\n")]
K6_TABLE_TWICE = [("symlen_tile.cu",
                   "  fptc::build_lut(s_lut, tab, l_max, threadIdx.x, "
                   "blockDim.x);\n",
                   "  fptc::build_lut(s_lut, tab, l_max, threadIdx.x, "
                   "blockDim.x);\n  __syncthreads();\n"
                   "  fptc::build_lut(s_lut, tab, l_max, threadIdx.x, "
                   "blockDim.x);\n")]
# K6 stores only a symbol no table holds, so its chains stay live
NO_STORES = [("symlen_decode.cu",
              "        store_run(out, base, end, sp, base, lane, "
              "fptc::kWarp);\n", ""),
             ("symlen_tile.cu",
              "        if (w < num_words) __stcs(row + w, "
              "static_cast<int32_t>(sym));\n",
              "        if (w < num_words && sym == static_cast<uint32_t>("
              "max_symlen) + 256u) {\n"
              "          __stcs(row + w, static_cast<int32_t>(sym));\n"
              "        }\n")]
# K1 with 2 or 8 consecutive words a lane in place of 4, and at 6 CTAs an
# SM in place of 4 (40 registers a thread)
K1_LANE_WORDS_2 = [("symlen_decode.cu", "constexpr int kLaneWords = 4;",
                    "constexpr int kLaneWords = 2;")]
K1_LANE_WORDS_8 = [("symlen_decode.cu", "constexpr int kLaneWords = 4;",
                    "constexpr int kLaneWords = 8;")]
K1_SIX_CTAS = [("symlen_decode.cu", "__launch_bounds__(kThreads, 4)",
                "__launch_bounds__(kThreads, 6)")]
VARIANTS = {"as_built": [], "k1_cta_table": K1_CTA_TABLE,
            "k6_table_twice": K6_TABLE_TWICE, "no_stores": NO_STORES,
            "k1_lane_words_2": K1_LANE_WORDS_2,
            "k1_lane_words_8": K1_LANE_WORDS_8, "k1_six_ctas": K1_SIX_CTAS}
EXPORTS = ("fptc_symlen_decode", "fptc_symlen_tile")


def build(name: str, edits, ops):
    """symlen_decode.cu and symlen_tile.cu with `edits` made to a copy of
    the sources, as one shared library; and nvcc's output."""
    out = os.path.join(BUILD, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    for fname, old, new in edits:
        path = os.path.join(out, fname)
        text = open(path).read()
        if old not in text:
            sys.exit("symlen_profile: kernel text changed, not found in "
                     f"{fname}: {old!r}")
        open(path, "w").write(text.replace(old, new, 1))
    so = os.path.join(out, f"symlen_{name}.so")
    res = subprocess.run([ops._nvcc(), *ops._FLAGS, "-shared", "-o", so,
                          os.path.join(out, "symlen_decode.cu"),
                          os.path.join(out, "symlen_tile.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"symlen_profile: nvcc failed on {name}:\n{res.stdout}"
                 f"{res.stderr}")
    lib = ctypes.CDLL(so)
    for fn in EXPORTS:
        getattr(lib, fn).argtypes = ops._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, res.stdout + res.stderr


def variant_calls(lib, b, stream, hd):
    """Calls of a variant build's K1 and K6 launchers on bucket `b`, each
    with its output: {name: (call, output)}."""
    import torch

    t, n = b["tables"], b["words"].numel()
    ptrs = (t.dec_limit.data_ptr(), t.dec_first.data_ptr(),
            t.dec_rank.data_ptr(), t.dec_syms.data_ptr())
    out1 = torch.empty(b["nsym"], dtype=torch.uint8, device="cuda")
    ws = torch.empty(hd.WORKSPACE_BYTES, dtype=torch.uint8, device="cuda")
    out6 = torch.empty(b["ms"], n, dtype=torch.int32, device="cuda")

    def k1():
        rc = lib.fptc_symlen_decode(
            b["words"].data_ptr(), b["symlen"].data_ptr(), n, *ptrs,
            b["l_max"], b["ms"], ws.data_ptr(), ws.numel(), out1.data_ptr(),
            b["nsym"], stream)
        if rc != 0:
            sys.exit(f"symlen_profile: symlen_decode launch failed ({rc})")

    def k6():
        rc = lib.fptc_symlen_tile(b["words"].data_ptr(), n, *ptrs,
                                  b["l_max"], b["ms"], out6.data_ptr(),
                                  stream)
        if rc != 0:
            sys.exit(f"symlen_profile: symlen_tile launch failed ({rc})")

    return {"symlen_decode": (k1, out1), "symlen_tile": (k6, out6)}


def ptxas_lines(log: str):
    """Per kernel of the two sources: its name and ptxas's lines on it
    (stack, spills, registers, shared memory)."""
    found, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found.append({"kernel": name, "ptxas": []})
        elif name and ("spill" in line or "registers" in line):
            found[-1]["ptxas"].append(line.split(":", 1)[-1].strip())
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("symlen_profile: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import DOMAIN_DEFAULTS, calibrate, encode
    from repro_torch.data import make_signal
    from repro_torch.kernels import huffman_decode as hd
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchDecoder, streams_from_containers
    from repro_torch.serving.engine import symlen_bucket

    reps = args.reps
    ops.library()
    # -- the archive decode buckets of chip_smoke.py -------------------------
    samples, archive, tables = 1 << 18, [], {}
    for d, (dom, ds, pred) in enumerate(ARCHIVAL):
        strip = make_signal(ds, samples, seed=args.seed * 1000 + d)
        sigs = [make_signal(ds, samples, seed=args.seed * 1000 + 100 + 8 * d
                            + i) for i in range(4)]
        for v3, did in ((False, d), (True, d + len(ARCHIVAL))):
            cfg = DOMAIN_DEFAULTS[dom]
            if v3:
                cfg = cfg.replace(predictor=pred, predict_bands=2,
                                  zero_planes=True)
            tab = calibrate(strip, cfg, domain_id=did, seed=args.seed)
            tables[did] = tab
            archive += [encode(s, tab) for s in sigs] * 32
    groups, _ = streams_from_containers(archive)
    dec = BatchDecoder()
    by_key = {c.plan_key: c for c in archive}
    buckets = []
    for grp in groups:
        p = dec.plan_for(by_key[grp.plan_key], tables)
        nw = dec.scheduler.round(grp.total_windows)
        buckets.append(dict(
            key=str(grp.plan_key), words=grp.words.cuda(),
            symlen=grp.symlen.cuda(), tables=p.tables, l_max=p.l_max,
            ms=symlen_bucket(grp.max_symlen), nsym=nw * p.e))
    wrappers = {
        "symlen_decode": lambda b: hd.huffman_decode_dense(
            b["words"], b["symlen"], b["tables"], l_max=b["l_max"],
            max_symlen=b["ms"], num_symbols=b["nsym"]),
        "symlen_tile": lambda b: hd.huffman_decode_tile(
            b["words"], b["tables"], l_max=b["l_max"], max_symlen=b["ms"]),
    }

    def events_us(fn, sleep: bool):
        """us per call of `reps` back-to-back calls under CUDA events, and
        whether the host enqueued them all before the device reached them
        (with `sleep`)."""
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        c = torch.cuda.Event(enable_timing=True)
        if sleep:
            c.record()
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = None
        if sleep:
            ahead = not a.query()  # the sleep still runs: queue ahead
        b.synchronize()
        return 1e3 * a.elapsed_time(b) / reps, ahead

    def device_us(fn):
        """Device us per call by kernel name, from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            dev = str(getattr(ev, "device_type", ""))
            if t and "CUDA" in dev:
                out[ev.key[:120]] = t / reps
        return out

    for name, wrap in wrappers.items():
        res = {"wrapper": name, "reps": reps, "by_bucket": []}
        tot = {"device_us": {}, "host_us": 0.0, "events_us": 0.0,
               "queued_us": 0.0}
        ahead_all = True
        for b in buckets:
            fn = (lambda b=b: wrap(b))
            dev = device_us(fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = 1e6 * (time.perf_counter() - t0) / reps
            torch.cuda.synchronize()
            ev, _ = events_us(fn, sleep=False)
            q, ahead = events_us(fn, sleep=True)
            ahead_all &= bool(ahead)
            res["by_bucket"].append({
                "plan_key": b["key"], "words": int(b["words"].numel()),
                "max_symlen": b["ms"], "num_symbols": b["nsym"],
                "device_us": dev, "device_total_us": sum(dev.values()),
                "host_us": host, "events_us": ev, "queued_us": q,
                "queued_ahead": ahead})
            for k, v in dev.items():
                tot["device_us"][k] = tot["device_us"].get(k, 0.0) + v
            tot["host_us"] += host
            tot["events_us"] += ev
            tot["queued_us"] += q
        tot["device_total_us"] = sum(tot["device_us"].values())
        res.update(total=tot, queued_ahead=ahead_all)
        print(json.dumps(res), flush=True)

    if args.variants:
        stream = torch.cuda.current_stream().cuda_stream
        first = True
        for vname, edits in VARIANTS.items():
            lib, log = build(vname, edits, ops)
            if first:
                print(json.dumps({"ptxas": ptxas_lines(log)}), flush=True)
                first = False
            res = {"build": vname, "symlen_decode_us": {},
                   "symlen_tile_us": {}}
            for b in buckets:
                got = variant_calls(lib, b, stream, hd)
                for kname, (call, out) in got.items():
                    us, _ = events_us(call, sleep=True)
                    res[f"{kname}_us"][b["key"]] = us
                    if vname == "as_built":
                        want = wrappers[kname](b)
                        res.setdefault(f"{kname}_equal_port", []).append(
                            bool(torch.equal(out, want)))
                del got
            for kname in ("symlen_decode", "symlen_tile"):
                res[f"{kname}_total_us"] = sum(res[f"{kname}_us"].values())
            print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
