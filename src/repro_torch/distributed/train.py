"""Train and serve step factories on one device.
Port of ``repro/distributed/train.py``.

One device and no mesh: no sharding, no ``jit``.  The train step is the
reference's uncompressed ``step_inner``: the loss and its gradients
(``Model.loss`` under autograd, each layer rematerialized), then
``AdamW.update``, which writes the model's weights and the optimizer's m
and v in place (the reference's step donates them).  It returns the loss
and the gradients' global norm as 0-d tensors on the device; nothing in it
syncs the host.

The pod-compressed mode (parameters replicated over a ``pod`` axis, the
cross-pod gradient sum through ``GradCompressor.replica_sum`` with
per-replica error feedback in ``OptState.residual``) needs more than one
replica; on one device the reference leaves the compressor off (its mesh
has no ``pod`` axis), and so does the port: ``compression=`` is accepted
and ``TrainStep.compressor`` is None.  The mode comes with the
multi-device layer (ROADMAP queue 1, item 6, M10d).

``make_serve_fns`` gives the serving functions, run in inference mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.compression import CompressionConfig
from repro_torch.distributed.optimizer import AdamW, OptState
from repro_torch.serving.engine import resolve_device

__all__ = ["TrainStep", "make_train_step", "make_serve_fns"]


@dataclasses.dataclass
class TrainStep:
    # (opt_state, batch) -> (opt_state, {"loss", "grad_norm"}); the model's
    # weights are updated in place
    step_fn: Callable[[OptState, Dict[str, torch.Tensor]],
                      Tuple[OptState, Dict[str, torch.Tensor]]]
    model: Any
    optimizer: AdamW
    compressor: Optional[Any] = None  # the pod-compressed mode: M10d

    def init(self) -> OptState:
        """The optimizer's zero state for the model's weights, keyed by
        their ``named_parameters`` names."""
        return self.optimizer.init(dict(self.model.named_parameters()))


def make_train_step(model, optimizer: AdamW, device=None, *,
                    compression: Optional[CompressionConfig] = None
                    ) -> TrainStep:
    """A train step for ``model`` on ``device`` (None: where the model
    lives; another device moves the model there).  The model's weights are
    made to take gradients.  Batches are dicts of tensors (moved to the
    device): tokens and labels ``int[B, S]``, a VLM's ``patch_embeds``,
    the audio family's ``frames``."""
    del compression  # one device: no pod axis, no compressor
    dev = model.device if device is None else resolve_device(device)
    model.to(dev)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    leaves = list(params.values())

    def step_fn(opt_state: OptState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves)
        _, new_state, gnorm = optimizer.update(
            params, opt_state, dict(zip(params, grads)), opt_state.residual)
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStep(step_fn=step_fn, model=model, optimizer=optimizer)


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
