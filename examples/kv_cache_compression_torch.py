"""FPTC KV-cache compression for long-context serving, on the PyTorch port.
The twin of ``examples/kv_cache_compression.py``.

Prefills a ``configs/`` model (its smoke size), calibrates the ``kv``
domain on its cache (one table per layer's k or v block: the reference
shares layer 0's table across layers, which clips deeper layers' caches,
see ``lm_conditioning.py``), then compresses every layer's block through
``KVCacheCodec``'s fixed-rate mode (K5: windowed token-axis DCT +
calibrated 3-zone quantization to uint8, no entropy coding, so blocks
stay fixed-size) and decompresses it (K3).
On the card the whole sweep runs under ``torch.cuda.set_sync_debug_mode
("error")``: no host sync mid-pipeline.  Reports bytes saved,
reconstruction error, decode-logit drift and the per-block compress +
decompress time into ``BENCH_workloads.json`` (``write_workloads_report``).

  PYTHONPATH=src python examples/kv_cache_compression_torch.py \
      [--smoke] [--device cpu] [--report PATH]
"""
import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import build_model
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.workloads import KVCacheCodec, write_workloads_report


@contextlib.contextmanager
def no_host_sync(dev: torch.device):
    """The twin of JAX's transfer guard: a host sync raises on the card."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: fewer timing repeats")
    ap.add_argument("--model", default="granite_8b")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="the card when omitted, 'cpu' for the plain "
                    "PyTorch versions")
    ap.add_argument("--report", default=None,
                    help="the report file (default: write_workloads_report's)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke(args.model)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    b, s = 2, args.tokens
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    with torch.inference_mode():
        logits, cache = model.prefill({"tokens": tokens}, s + 8)

    # quantization only (the "kv" domain default has n == e): uint8 levels
    # halve a bf16 cache, with no per-block sidecar (scales live in the
    # tables)
    codec = KVCacheCodec(device=dev)
    for gname, group in cache.items():
        for key in ("k", "v"):
            for layer, kv in enumerate(group[key]):
                codec.calibrate(kv[:, :s], layer=(gname, key, layer))

    # -- compress + decompress every layer's block, on the device ---------
    lk = ("group0", "k", 0)
    one = cache["group0"]["k"][0][:, :s]
    codec.decompress(codec.compress(one, layer=lk), layer=lk)  # warm
    sync(dev)
    with no_host_sync(dev):
        compressed = {
            (g, key): [codec.compress(kv[:, :s], layer=(g, key, layer))
                       for layer, kv in enumerate(group[key])]
            for g, group in cache.items() for key in ("k", "v")}
        restored = {(g, key): [codec.decompress(c, layer=(g, key, layer))
                               for layer, c in enumerate(blocks)]
                    for (g, key), blocks in compressed.items()}
    sync(dev)

    # -- accounting + reconstruction error ---------------------------------
    raw_bytes = comp_bytes = 0
    max_rel = 0.0
    new_cache = {}
    for (g, key), blocks in compressed.items():
        kv = cache[g][key]
        out = torch.zeros_like(kv)
        for layer, (ckv, rec) in enumerate(zip(blocks, restored[(g, key)])):
            block = kv[layer][:, :s].float()
            rel = float(torch.linalg.vector_norm(rec.float() - block)
                        / (torch.linalg.vector_norm(block) + 1e-9))
            max_rel = max(max_rel, rel)
            raw_bytes += ckv.raw_nbytes()
            comp_bytes += ckv.nbytes
            out[layer][:, :s] = rec
        new_cache.setdefault(g, {})[key] = out
    print(f"KV cache: {raw_bytes/1e6:.2f} MB -> {comp_bytes/1e6:.2f} MB "
          f"(CR {raw_bytes/comp_bytes:.2f}x), worst block rel err "
          f"{max_rel:.4f}")

    # -- effect on decode logits ---------------------------------------------
    tok = logits.argmax(-1, keepdim=True)
    with torch.inference_mode():
        lg_ref, _ = model.decode_step(cache, tok, s)
        lg_cmp, _ = model.decode_step(new_cache, tok, s)
    agree = float((lg_ref.argmax(-1) == lg_cmp.argmax(-1)).float().mean())
    drift = float((torch.log_softmax(lg_ref.float(), -1)
                   - torch.log_softmax(lg_cmp.float(), -1)).abs().max())
    print(f"decode with compressed cache: top-1 agreement {agree*100:.0f}%, "
          f"max log-prob drift {drift:.3f}")

    # -- per-step overhead: compress + decompress one block, steady state ----
    repeats = 3 if args.smoke else 20
    codec.decompress(codec.compress(one, layer=lk), layer=lk)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        codec.decompress(codec.compress(one, layer=lk), layer=lk)
    sync(dev)
    per_block_ms = (time.perf_counter() - t0) / repeats * 1e3
    print(f"compress+decompress one block: {per_block_ms:.3f} ms "
          f"({dev.type})")

    path = write_workloads_report("kv_cache", {
        "model": args.model,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "tokens": s,
        "raw_bytes": int(raw_bytes),
        "compressed_bytes": int(comp_bytes),
        "bytes_saved": int(raw_bytes - comp_bytes),
        "ratio": comp_bytes / raw_bytes,
        "max_rel_error": max_rel,
        "top1_agreement": agree,
        "max_logprob_drift": drift,
        "per_block_roundtrip_ms": per_block_ms,
        "encode_dispatches": codec.encoder.stats.dispatches,
    }, path=args.report)
    print(f"report -> {path}")


if __name__ == "__main__":
    main()
