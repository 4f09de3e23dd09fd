#!/usr/bin/env python3
"""How well-conditioned a random-weight granite-8b is, by depth and draw.

    PYTHONPATH=src python3 lm_conditioning.py [--layers 4,8,16,36]
        [--device cuda|cpu] [--batch 8] [--prompt 4096] [--seed 0]

For each depth (granite-8b's width, its first L layers) and each way of
drawing the layer weights, one JSON line with two numbers:

  * ``consistency``: relative L2 of the last token's logits, ``prefill(S)``
    against ``prefill(S - 1)`` + one ``decode_step`` (chip_smoke's lm
    phase holds the same at 36 layers);
  * ``drift``: relative L2 of one ``decode_step``'s logits on the cache
    after every layer's prefilled K and V block went through
    ``KVCacheCodec`` and back, with a table per block (``serve_lm.
    compress_cache``) and with one table per k/v calibrated on layer 0
    and shared by every layer (the reference example's flow).

Draws: ``layer`` is the port's (each layer from its own specs: a matrix's
fan-in is its leading axis); ``stacked`` is the reference's, which draws a
stacked ``[L, ...]`` leaf whole, so every layer matrix has std
``1 / sqrt(L)``.  On the CPU keep the depth and the prompt small (each
layer of granite-8b holds 218 M parameters).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="4,8,16,36")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve_lm import compress_cache
    from repro_torch.models import build_model
    from repro_torch.models.api import spec_leaves
    from repro_torch.serving import KVCacheCodec

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device: pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"

    def rel(a, b) -> float:
        return float(torch.linalg.vector_norm((a - b).float())
                     / torch.linalg.vector_norm(b.float()))

    b, s = args.batch, args.prompt
    for n_layers in (int(x) for x in args.layers.split(",")):
        cfg = get_arch("granite-8b").replace(num_layers=n_layers)
        for draw in ("layer", "stacked"):
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            model = build_model(cfg, device=dev, generator=gen)
            if draw == "stacked":  # every layer leaf at the stacked std
                stacked = model.param_specs()["group0"]
                with torch.no_grad():
                    for _, _, layer in model.layers():
                        for path, spec in spec_leaves(stacked):
                            p = layer
                            for k in path:
                                p = p[k]
                            if spec.init == "normal":
                                p.copy_(torch.randn(
                                    p.shape, generator=gen, device=dev)
                                    .mul_(spec.std).to(p.dtype))
            rng = np.random.default_rng(args.seed)
            tokens = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
            with torch.inference_mode():
                logits, cache = model.prefill({"tokens": tokens}, s + 1)
                _, part = model.prefill({"tokens": tokens[:, :s - 1]}, s + 1)
                step, _ = model.decode_step(part, tokens[:, s - 1:], s - 1)
                consistency = rel(step, logits)
                del part, step
                first = logits.argmax(-1, keepdim=True)
                want, _ = model.decode_step(cache, first, s)
                drift = {}
                for tables in ("per_block", "layer0"):
                    new = {g: {k: t.clone() for k, t in c.items()}
                           for g, c in cache.items()}
                    if tables == "per_block":
                        compress_cache(KVCacheCodec(device=dev), new, s)
                    else:
                        codec = KVCacheCodec(device=dev)
                        for g, c in new.items():
                            for k, kv in c.items():
                                codec.calibrate(kv[0, :, :s], layer=(g, k))
                                for blk in kv:
                                    blk[:, :s] = codec.decompress(
                                        codec.compress(blk[:, :s],
                                                       layer=(g, k)),
                                        layer=(g, k))
                    got, _ = model.decode_step(new, first, s)
                    drift[tables] = rel(got, want)
                    del new, got
            print(json.dumps({
                "layers": n_layers, "draw": draw, "device": smi,
                "batch": b, "prompt": s, "consistency": consistency,
                "drift": drift, "seconds": time.perf_counter() - t0}),
                flush=True)
            del model, cache, logits, want
            if dev.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
