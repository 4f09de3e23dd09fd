"""LM serving driver: batched prefill + greedy decode loop on one device.
Port of ``repro/launch/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen1.5-4b \
      --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu] \
      [--kv-compress]

The reference's flags, plus ``--device`` (default: the card; ``cpu`` runs
the same arithmetic on the host), ``--seed`` (weights and prompts) and
``--kv-compress``: after prefill, every layer's prefilled attention-cache
block (``cache_blocks``: k and v ``[:, :S]``, the hybrid's ring over its
valid slots, MLA's latents, whisper's cross-attention k/v over the
frames) is compressed (K5) and decompressed (K3) in place through
``KVCacheCodec``, each on a table calibrated on that block, and the
cache's bytes before and after are printed; each prompt-indexed block's
length must be a multiple of the ``kv`` domain's window, while a cross
block compresses its whole windows and keeps its tail raw.  The hybrid's
SSM state and RWKV's state stay raw (RWKV has no block: the line says
so).  Whisper's frames are zeros, as the reference feeds them.  Decode
starts at position ``S`` (a VLM's patch prefix included) and the cache
holds ``S + gen`` slots.
"""
from __future__ import annotations

import argparse
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.distributed.train import MULTI_DEVICE, make_serve_fns
from repro_torch.models import build_model
from repro_torch.models.api import CROSS_KEYS, STATE_KEYS
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.workloads import KVCacheCodec

__all__ = ["main", "compress_cache", "cache_blocks", "compressible"]



def _entries(cache):
    """``(name prefix, key, tensor)`` of a cache nested by group or flat."""
    for g, grp in cache.items():
        if isinstance(grp, torch.Tensor):
            yield (), g, grp
        else:
            for key, t in grp.items():
                yield (g,), key, t


def cache_blocks(cache, s: int):
    """``(name, block)`` of every attention-cache block a prefill of ``s``
    slots filled, each a ``[B, s', H, D]`` view of one layer, named
    ``(group, key, layer)`` (``(key, layer)`` in a flat cache): ``k``/
    ``v`` ``[:, :s]``, the hybrid's ring over its ``min(s, T)`` valid
    slots, MLA's ``ckv``/``kr`` latents as one-head blocks, whisper's
    ``ck``/``cv`` over all their frames.  A state (the hybrid's ``conv``,
    ``ssm``; RWKV's ``shift1``, ``shift2``, ``wkv``) is not a token axis
    and stays raw."""
    for prefix, key, t in _entries(cache):
        if key in STATE_KEYS:
            continue
        for layer, kv in enumerate(t):
            if kv.dim() == 3:  # [B, T, R] latent
                kv = kv.unsqueeze(2)
            valid = kv.shape[1] if key in CROSS_KEYS else min(s,
                                                              kv.shape[1])
            yield prefix + (key, layer), kv[:, :valid]


def compressible(name, block: torch.Tensor, n: int) -> torch.Tensor:
    """The part of ``cache_blocks``' block ``name`` that the kv domain's
    windows of ``n`` tokens cover: a cross block's whole windows (its
    last ``T % n`` slots stay raw), any other block whole, its length a
    multiple of ``n`` (else ``ValueError``)."""
    if name[-2] in CROSS_KEYS:
        return block[:, :block.shape[1] - block.shape[1] % n]
    if block.shape[1] % n:
        raise ValueError(
            f"{name}: {block.shape[1]} prefilled slots: the kv domain "
            f"compresses windows of {n} tokens, so S must be a multiple "
            f"of {n}")
    return block


def compress_cache(codec: KVCacheCodec, cache, s: int) -> Tuple[int, int]:
    """Compress and decompress every block of ``cache_blocks(cache, s)``
    in place through ``codec``, each on a table calibrated on that block
    (one per block: a table shared across a group's layers clips the
    deeper layers' token-axis DC, whose range layer 0 does not reach).  A
    cross block goes through in its whole windows of the kv domain's n
    tokens; its last ``T % n`` slots stay raw (whisper's 1500 frames: 93
    windows and 12 raw slots; ``compressible``).  Returns the compressed
    slots' raw bytes and their compressed bytes (0, 0 when the cache has
    no block)."""
    raw = comp = 0
    for name, block in cache_blocks(cache, s):
        block = compressible(name, block, codec.config.n)
        codec.calibrate(block, layer=name)
        ckv = codec.compress(block, layer=name)
        block.copy_(codec.decompress(ckv, layer=name))
        raw += ckv.raw_nbytes()
        comp += ckv.nbytes
    return raw, comp


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-compress", action="store_true")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model_par != 1:
        raise NotImplementedError(
            f"--data {args.data} --model-par {args.model_par}: the port "
            f"serves on one device; see {MULTI_DEVICE}")

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    prefill_fn, decode_fn = make_serve_fns(model, dev)

    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)))}
    s = args.prompt_len
    if cfg.family == "vlm" and cfg.vision_prefix:
        batch["patch_embeds"] = torch.zeros(
            (args.batch, cfg.vision_prefix, cfg.d_model), dtype=torch.bfloat16)
        s += cfg.vision_prefix
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16)
    max_len = s + args.gen

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(batch, max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    if args.kv_compress:
        with torch.inference_mode():
            raw, comp = compress_cache(KVCacheCodec(device=dev), cache, s)
        if raw:
            print(f"kv cache: {raw} B -> {comp} B (ratio {comp / raw:.3f})")
        else:
            print("kv cache: nothing compressed (no token-axis block)")

    tok = logits.argmax(-1, keepdim=True)
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = decode_fn(cache, tok, s + i)
        tok = logits.argmax(-1, keepdim=True)
        outs.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    generated = torch.cat(outs, dim=1).cpu().numpy()
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({args.batch * (args.gen - 1) / max(t_decode, 1e-9):.0f} tok/s)")
    print("sample generations (first 12 token ids):")
    for row in generated[:4]:
        print("  ", row[:12].tolist())
    return generated


if __name__ == "__main__":
    main()
