#!/usr/bin/env python3
"""Profile the port's serving frontend on one NVIDIA GPU: where a request's
host time goes at loads near the knee.

    python3 serve_profile.py [--rates 400,800] [--top 12]

Run from the root of a checkout.  It serves ``chip_smoke.py``'s serve
configuration (``build_domain_tables()``, the decode 0.6 / encode 0.3 /
transcode 0.1 mix, log-normal sizes, SLO 250 ms, flush slack 50 ms,
``max_batch`` 64, the sweep's stream for each rate) after the same 0.5 s
warm-up, three times per rate, and prints one JSON line per run:

  * ``timers`` — the replay's p50/p99 and achieved requests/s, and the
    seconds each thread spent in its part: admission (``_admit``, on the
    replaying thread), the dispatcher's engine calls (``_dispatch_batch``:
    staging, plans, kernel launches), the drain worker (``_drain``:
    ``to_host`` and completing the futures; ``chip_smoke.py``'s serve
    phase times the device-to-host starts inside it); the engines' own
    ``upload_s`` / ``dispatch_s``;
  * ``device`` — CUDA kernel time by kernel name and in all, from
    ``torch.profiler`` over the same replay, and its share of the wall:
    the device's busy share (a lower bound: the profiler's host-side
    recording lengthens the wall);
  * ``cprofile`` — the top functions by own time over the whole process
    (``cProfile`` on Python 3.12 sees every thread: the replaying thread,
    the dispatcher, the drain worker and the engines' staging workers;
    it slows Python-heavy code more than native code, so read the
    ranking, not the seconds).

The card's name and power limit come last.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def top_functions(prof: cProfile.Profile, n: int) -> list:
    """``[file:line(function), own s, cumulative s, calls]`` for the ``n``
    functions with the most own time."""
    stats = pstats.Stats(prof)
    rows = []
    for (path, line, name), (_, calls, own, cum, _) in stats.stats.items():
        rows.append([f"{os.path.basename(path)}:{line}({name})", own, cum,
                     calls])
    rows.sort(key=lambda r: -r[1])
    return rows[:n]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rates", default="400,800")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("serve_profile: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.serving import (
        BatchDecoder,
        BatchEncoder,
        FrontendConfig,
        ServingFrontend,
        TrafficConfig,
        Transcoder,
        build_domain_tables,
        generate,
        replay,
    )

    tables = build_domain_tables()
    dec, enc = BatchDecoder(), BatchEncoder()
    engines = {"decoder": dec, "encoder": enc,
               "transcoder": Transcoder(decoder=dec, encoder=enc)}
    config = FrontendConfig(max_batch=64, max_queue_depth=1024,
                            default_slo_ms=cs.SERVE_SLO_MS,
                            flush_slack_ms=cs.SERVE_SLACK_MS)

    def stream(rps, duration_s=2.0, seed=None):
        return generate(TrafficConfig(
            rate=rps, duration_s=duration_s,
            seed=42 + int(rps) if seed is None else seed,
            **cs.SERVE_TRAFFIC), tables)

    with ServingFrontend(tables, config=config, **engines) as fe:
        replay(fe, stream(800.0, 0.5, seed=99))

    # per-thread timers around the frontend's parts (class attributes,
    # restored after each run)
    spent = {}
    lock = threading.Lock()

    def timed(owner, name, key):
        orig = getattr(owner, name)

        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                with lock:
                    spent[key] = spent.get(key, 0.0) + (
                        time.perf_counter() - t)
        return orig, wrapper

    patches = [(ServingFrontend, "_admit", "admit_s"),
               (ServingFrontend, "_dispatch_batch", "dispatch_batch_s"),
               (ServingFrontend, "_drain", "drain_s")]

    def run(reqs, wrap=False):
        spent.clear()
        saved = []
        if wrap:
            for owner, name, key in patches:
                orig, wrapper = timed(owner, name, key)
                saved.append((owner, name, orig))
                setattr(owner, name, wrapper)
        stats0 = [(e.executor.stats.upload_s, e.executor.stats.dispatch_s)
                  for e in (dec, enc)]
        try:
            t0 = time.perf_counter()
            with ServingFrontend(tables, config=config, **engines) as fe:
                rep = replay(fe, reqs)
                st = fe.stats_snapshot()
            wall = time.perf_counter() - t0
        finally:
            for owner, name, orig in saved:
                setattr(owner, name, orig)
        out = {"wall_s": wall, "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
               "achieved_rps": rep.achieved_rps, "completed": rep.completed,
               "batches": st.batches, "mean_batch": st.mean_batch_size}
        for e, name, (u0, d0) in zip((dec, enc), ("decoder", "encoder"),
                                     stats0):
            out[f"{name}_upload_s"] = e.executor.stats.upload_s - u0
            out[f"{name}_dispatch_s"] = e.executor.stats.dispatch_s - d0
        return out

    for rps in [float(r) for r in args.rates.split(",")]:
        reqs = stream(rps)
        line = run(reqs, wrap=True)
        line.update(spent)
        print(json.dumps({"rate_rps": rps, "mode": "timers", **line}),
              flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            line = run(reqs)
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
        busy = sum(kernels.values())
        print(json.dumps({
            "rate_rps": rps, "mode": "device", **line,
            "device_ms": busy, "device_busy_share": busy / 1e3 / line[
                "wall_s"],
            "kernel_ms": dict(sorted(kernels.items(),
                                     key=lambda kv: -kv[1])[:args.top])}),
            flush=True)
        prof = cProfile.Profile()
        line = prof.runcall(run, reqs)
        print(json.dumps({"rate_rps": rps, "mode": "cprofile", **line,
                          "top": top_functions(prof, args.top)}), flush=True)
    engines["transcoder"].close()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
