"""The serving half of ``repro/distributed/train.py``: ``make_serve_fns``.

One device and no mesh, so no sharding and no ``jit``: the functions are
the model's own, run under ``torch.inference_mode()``.  The train step,
its optimizer and the gradient compressor's collective come with the
training slice (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import torch

from repro_torch.serving.engine import resolve_device

__all__ = ["make_serve_fns"]


def make_serve_fns(model, device=None):
    """``(prefill_fn, decode_fn)`` for ``model`` on ``device`` (None: where
    the model lives; another device moves the model there).

    ``prefill_fn(batch, max_len)`` returns (last-token logits, cache) and
    ``decode_fn(cache, tokens, pos)`` (logits, cache), the cache written in
    place.  Inputs are moved to the device.  The cache is made in
    inference mode, so code that writes into it outside these functions
    runs under ``torch.inference_mode()`` too."""
    dev = model.device if device is None else resolve_device(device)
    model.to(dev)

    @torch.inference_mode()
    def prefill_fn(batch, max_len: int):
        return model.prefill({k: v.to(dev) for k, v in batch.items()},
                             max_len)

    @torch.inference_mode()
    def decode_fn(cache, tokens, pos):
        return model.decode_step(cache, tokens.to(dev), pos)

    return prefill_fn, decode_fn
