#!/usr/bin/env python3
"""How well-conditioned a random-weight LM is, by depth and draw.

    PYTHONPATH=src python3 lm_conditioning.py [--arch granite-8b]
        [--layers 4,8,16,36] [--draws layer,stacked]
        [--device cuda|cpu] [--batch 8] [--prompt 4096] [--seed 0]
        [--decode-conv reference|taps]

For each depth (the architecture's width, its first L layers) and each
way of drawing the layer weights, one JSON line with two numbers:

  * ``consistency``: relative L2 of the last token's logits, ``prefill(S)``
    against ``prefill(S - 1)`` + one ``decode_step`` (chip_smoke's lm
    phase holds the same at 36 layers);
  * ``drift``: relative L2 of one ``decode_step``'s logits on the cache
    after every layer's prefilled cache block (``serve_lm.cache_blocks``:
    K and V, MLA's latents, the hybrid's ring) went through
    ``KVCacheCodec`` and back, with a table per block (``serve_lm.
    compress_cache``) and with one table per key calibrated on layer 0
    and shared by every layer (the reference example's flow).

  * ``moe`` (MoE models): for each MoE layer, the (token, k) pairs its
    prefill of S tokens dropped and the experts it reached, the mean
    cosine of its input rows to their mean row, and the same three for
    the embeddings (normalized by the layer's ``ln2``) fed to its MoE
    directly: how far the layers before it have pulled the tokens
    together.

``--decode-conv taps`` is an experiment on the hybrid's SSM: the decode
step's conv sums its bf16 taps from tap 0 as the prefill's
``_causal_conv`` does, instead of the reference's fp32 sum (R11).

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
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", default="4,8,16,36")
    ap.add_argument("--draws", default="layer,stacked")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-conv", default="reference",
                    choices=("reference", "taps"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve_lm import cache_blocks, compress_cache
    from repro_torch.models import build_model
    from repro_torch.models import ssm
    from repro_torch.models.api import spec_leaves
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import _norm_offset, moe_apply
    from repro_torch.serving import KVCacheCodec

    if args.decode_conv == "taps":
        ssm._decode_conv = lambda p, window: ssm._causal_conv(
            p, window, window.shape[1])[:, -1]

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

    def cos_to_mean(x) -> float:
        rows = x.reshape(-1, x.shape[-1]).float()
        return float(torch.nn.functional.cosine_similarity(
            rows, rows.mean(0, keepdim=True), dim=-1).mean())

    b, s = args.batch, args.prompt
    for n_layers in (int(x) for x in args.layers.split(",")):
        cfg = get_arch(args.arch).replace(num_layers=n_layers)
        for draw in args.draws.split(","):
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            model = build_model(cfg, device=dev, generator=gen)
            if draw == "stacked":  # every layer leaf at the stacked std
                specs = model.param_specs()
                with torch.no_grad():
                    for g, _, layer in model.layers():
                        for path, spec in spec_leaves(specs[g]):
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
            moe, hooks = {}, []

            def first_input(key):  # the layer's input in the first prefill
                def hook(mod, inp):
                    moe[key].setdefault("input_cos_to_mean",
                                        cos_to_mean(inp[0]))
                return hook

            for g, li, layer in model.layers():
                if layer.kind == "moe":
                    layer.moe_stats = {}
                    moe[f"{g}.{li}"] = {}
                    hooks.append(layer.register_forward_pre_hook(
                        first_input(f"{g}.{li}")))
            with torch.inference_mode():
                logits, cache = model.prefill({"tokens": tokens}, s + 1)
                emb = model._embed(tokens)
                for g, li, layer in model.layers():
                    if layer.kind != "moe":
                        continue
                    row = moe[f"{g}.{li}"]
                    row.update({k: int(v) for k, v in
                                layer.moe_stats.items()})
                    row["pairs"] = b * s * cfg.moe_top_k
                    fed = {}
                    h = rms_norm(emb, layer["ln2"], offset=_norm_offset(cfg))
                    moe_apply(cfg, layer["ffn"], h, fed)
                    row["embeddings"] = {"cos_to_mean": cos_to_mean(emb),
                                         **{k: int(v) for k, v in
                                            fed.items()}}
                    del h
                del emb
                for hook in hooks:
                    hook.remove()
                _, part = model.prefill({"tokens": tokens[:, :s - 1]}, s + 1)
                step, _ = model.decode_step(part, tokens[:, s - 1:], s - 1)
                consistency = rel(step, logits)
                del part, step
                first = logits.argmax(-1, keepdim=True)

                def clone(c):  # a decode step advances an SSM state
                    return {g: {k: t.clone() for k, t in grp.items()}
                            for g, grp in c.items()}

                want, _ = model.decode_step(clone(cache), first, s)
                drift = {}
                for tables in ("per_block", "layer0"):
                    new = clone(cache)
                    if tables == "per_block":
                        compress_cache(KVCacheCodec(device=dev), new, s)
                    else:
                        codec = KVCacheCodec(device=dev)
                        for (g, k, layer), blk in cache_blocks(new, s):
                            if layer == 0:
                                codec.calibrate(blk, layer=(g, k))
                            blk.copy_(codec.decompress(codec.compress(
                                blk, layer=(g, k)), layer=(g, k)))
                    got, _ = model.decode_step(new, first, s)
                    drift[tables] = rel(got, want)
                    del new, got
            print(json.dumps({
                "arch": args.arch, "layers": n_layers, "draw": draw,
                "decode_conv": args.decode_conv, "device": smi,
                "batch": b, "prompt": s, "consistency": consistency,
                "drift": drift, **({"moe": moe} if moe else {}),
                "seconds": time.perf_counter() - t0}),
                flush=True)
            del model, cache, logits, want
            if dev.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
