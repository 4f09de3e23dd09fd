#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with its serve phase observed for stalls of the
whole interpreter.

    python3 serve_gc_probe.py [--no-settle] [--out chiprun_out/gc_probe.json]

Run from the root of a checkout, on the card.  Around ``chip_smoke.py``'s
serve phase a probe thread wakes every millisecond and records each gap
over 10 ms between its wake-ups (the interpreter stalled: a garbage
collection, or a native call that holds the interpreter lock), and every
replay's report is kept: its late admissions (over 10 ms) and its garbage
collections over 5 ms, on the replay's clock (``time.monotonic``).  It
writes them to ``--out`` beside the heap's tracked objects at the phase's
start.  ``--no-settle`` leaves out the serve phase's ``settle_heap()``
(freezing the warm heap before the replays), so the two arms compare the
full collections' pauses with and without it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-settle", action="store_true",
                    help="serve without freezing the warm heap")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "gc_probe.json"))
    args = ap.parse_args()
    sys.argv = [sys.argv[0]]  # chip_smoke's own arguments: the defaults
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke
    from repro_torch import serving

    reports = []
    replay = serving.replay

    def kept_replay(fe, requests, **kw):
        rep = replay(fe, requests, **kw)
        reports.append(rep)
        return rep

    serving.replay = kept_replay
    if args.no_settle:
        serving.settle_heap = lambda: 0
    stalls, stop = [], threading.Event()

    def probe() -> None:
        last = time.monotonic()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.monotonic()
            if now - last > 0.010:
                stalls.append((last, now))
            last = now

    serve_phase = chip_smoke.serve_phase

    def observed(smi):
        heap = len(gc.get_objects())
        th = threading.Thread(target=probe, daemon=True)
        th.start()
        try:
            return serve_phase(smi)
        finally:
            stop.set()
            th.join()
            out = {"settle": not args.no_settle, "heap_objects": heap,
                   "stalls": stalls, "replays": [{
                       "started_at": r.started_at,
                       "offered_rps": r.offered_rps, "p99_ms": r.p99_ms,
                       "timings": r.timings(),
                       "late": [(r.started_at + t, lag) for t, lag in zip(
                           r.admit_at_s, r.admit_lag_ms) if lag > 10.0],
                       "gc": [(r.started_at + t, ms, g)
                              for t, ms, g in r.gc_pauses if ms > 5.0],
                   } for r in reports]}
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(out, f)

    chip_smoke.serve_phase = observed
    chip_smoke.main()


if __name__ == "__main__":
    main()
