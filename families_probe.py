#!/usr/bin/env python3
"""Serve some of ``chip_smoke.py``'s families on the card, each through
its ``family_run``, with a prompt of one's choosing.

    python3 families_probe.py [ARCH[:PROMPT] ...]

ARCH is an entry of ``chip_smoke.FAMILIES`` (all of them when none is
given), PROMPT its prompt tokens in place of the phase's (say,
``rwkv6-3b:2048``); batch, depth and generated tokens stay the phase's.
Runs with the phase's precision (TF32 and bf16 reduced-precision
reductions off), weights drawn from seed 0, and the phase's checks.
Every run's JSON lands in ``chiprun_out/families.json`` as it ends; a
summary line per run (ms against the bounds, kernels and idle share per
call, consistency, the KV cache's launches and drift, seconds by part)
goes to stdout.  Needs the card.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))


def main(argv) -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    plan = {f[0]: f for f in cs.FAMILIES}
    wanted = [a.split(":") for a in argv] or [[a] for a in plan]
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    runs = []
    with cs.exact_bf16_sums():
        for name, *prompt in wanted:
            arch, layers, b, s, gen = plan[name]
            s = int(prompt[0]) if prompt else s
            r = cs.family_run(arch, cs.family_config(arch, layers), b, s,
                              gen, 0)
            runs.append({"nvidia_smi": smi, **r})
            with open(os.path.join(out, "families.json"), "w") as f:
                json.dump(runs, f)
            kv = r["kv"]
            print(json.dumps({
                "arch": arch, "batch": b, "prompt": s,
                "prefill_ms": r["prefill_ms"],
                "prefill_bound_ms": r["prefill_bound"]["ms"],
                "decode_ms": r["decode_ms_per_token"],
                "decode_bound_ms": r["decode_bound"]["ms"],
                "kernels": {k: p["kernels"] for k, p in r["profile"].items()},
                "idle_share": {k: p["idle_share"]
                               for k, p in r["profile"].items()},
                "peak_bytes": r["max_memory_allocated"],
                "consistency": r["consistency_rel_l2"],
                "kv_launches": kv["launches"],
                "kv_drift": kv.get("drift_rel_l2"),
                "seconds_by_part": r["seconds_by_part"]}), flush=True)


if __name__ == "__main__":
    t0 = time.time()
    main(sys.argv[1:])
    print(f"seconds {time.time() - t0:.1f}")
