"""Model API: one interface over all ten architectures.
Port of ``repro/models/api.py``.

``build_model(cfg)`` returns a :class:`Model`, an ``nn.Module`` holding its
weights, with:
  * ``param_specs()``      — the reference's ParamSpec tree (layers stacked)
  * ``loss(batch)``        — next-token CE loss (its backward: the train
                             step, ``distributed/train.py``)
  * ``prefill(batch, max_len)`` — full-sequence forward + decode cache
  * ``decode_step(cache, tokens, pos)`` — one-token serve step
  * ``cache_specs(batch, max_len)`` — ParamSpec tree for the decode cache
  * ``batch_specs(batch, seq)`` — ParamSpec tree for input batches

Batches are dicts: tokens/labels int[B, S]; VLM adds patch_embeds
[B, P, d]; audio adds frames [B, encoder_seq, d].  The weights' stacks are
the reference's: ``group<i>`` (one ``DecoderLayer`` a layer), RWKV's
``layers``, whisper's ``encoder`` and ``decoder``.  The decode cache is
laid out as the reference lays it out, its tensors stacked on a leading
layer axis.  The transformer families' is ``{"group<i>": {...}}``: bf16
``"k"``/``"v"`` ``[L, B, T, KV, hd]``; MLA's latent ``"ckv"`` ``[L, B, T,
kv_lora]`` and ``"kr"`` ``[L, B, T, rope]``; the hybrid family's k/v are a
ring of ``min(max_len, window)`` slots (position p in slot ``p % T``)
beside its SSM state, ``"conv"`` bf16 ``[L, B, k-1, d_in]`` and ``"ssm"``
fp32 ``[L, B, d_in, N]``.  RWKV's and whisper's are flat dicts: RWKV's
state ``"shift1"``/``"shift2"`` bf16 ``[L, B, d]`` and ``"wkv"`` fp32
``[L, B, h, hd, hd]`` (no token axis: ``max_len`` is ignored); whisper's
self-attention ``"k"``/``"v"`` ``[L, B, T, KV, hd]`` and its
cross-attention ``"ck"``/``"cv"`` ``[L, B, encoder_seq, KV, hd]``.
``decode_step`` writes the cache in place and returns it.  The weights are
built without gradients (the serving path); ``model.requires_grad_(True)``
makes them take gradients, as ``make_train_step`` does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import encdec, rwkv, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    ParamSpec,
    Params,
    rms_norm,
    rope,
    rounded,
)
from repro_torch.models.config import ArchConfig

PyTree = Any

__all__ = ["Model", "build_model", "stack_specs", "spec_leaves",
           "STATE_KEYS", "CROSS_KEYS"]

RWKV_STATE = ("shift1", "shift2", "wkv")  # RWKV's cache, a layer's state
STATE_KEYS = ("conv", "ssm") + RWKV_STATE  # cache entries with no token axis
CROSS_KEYS = ("ck", "cv")  # whisper's cross-attention k/v, over the frames


def stack_specs(count: int, tree: PyTree) -> PyTree:
    if isinstance(tree, ParamSpec):
        return ParamSpec((count,) + tree.shape, ("layers",) + tree.names,
                         dtype=tree.dtype, init=tree.init, scale=tree.scale)
    return {k: stack_specs(count, s) for k, s in tree.items()}


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in fp32; logits [B, S, V], labels int [B, S]."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def spec_leaves(specs: PyTree, prefix=()):
    """(path, spec) of every leaf, in the tree's key order."""
    for k, s in specs.items():
        if isinstance(s, ParamSpec):
            yield prefix + (k,), s
        else:
            yield from spec_leaves(s, prefix + (k,))


def _layer_out(layer, x, sin, cos) -> torch.Tensor:
    return layer(x, sin, cos)[0]


def _decoder_out(layer, x, enc_out, sin, cos) -> torch.Tensor:
    return layer(x, enc_out, sin, cos)[0]


def _rwkv_out(layer, x) -> torch.Tensor:
    return layer(x)[0]


def _resolve(device):
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    from repro_torch.serving.engine import resolve_device

    return resolve_device(device)


def _stacks(cfg: ArchConfig, dev) -> List[Tuple[str, List[nn.Module]]]:
    """``(name, layers)`` of each stack of layers, named as the reference's
    parameter tree names it."""
    if cfg.family == "ssm":
        return [("layers", [rwkv.RWKVLayer(cfg, dev)
                            for _ in range(cfg.num_layers)])]
    if cfg.family == "audio":
        return [("encoder", [encdec.EncoderLayer(cfg, dev)
                             for _ in range(cfg.encoder_layers)]),
                ("decoder", [encdec.CrossDecoderLayer(cfg, dev)
                             for _ in range(cfg.num_layers)])]
    return [(f"group{gi}", [tfm.DecoderLayer(cfg, g.kind, w, dev)
                            for w in g.windows])
            for gi, g in enumerate(tfm.layer_groups(cfg))]


def _top_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The embedding, the final norm and the unembedding."""
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ParamSpec(
            (v, d), ("vocab", "embed_fsdp"), dtype=torch.bfloat16,
            init="embed", scale=0.02,
        ),
        "final_norm": ParamSpec((d,), (None,), dtype=torch.bfloat16,
                                init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec(
            (d, v), ("hidden", "vocab"), dtype=torch.bfloat16,
            scale=1.0 / math.sqrt(d),
        )
    return specs


class Model(Params):
    """One architecture's weights and its serving functions.

    ``device=None`` is the card (and raises without one); ``"cpu"`` runs
    the same arithmetic on the host; ``"meta"`` allocates nothing (the
    reference's ``abstract_params``).  Weights are drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 when None)
    one layer at a time, so no stacked fp32 transient exists
    (:meth:`init_weights`).  A stack of layers is an ``nn.ModuleList``
    reached as ``model[name]`` (RWKV's ``"layers"`` shares its name with
    :meth:`layers`)."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        dev = _resolve(device)
        specs = self.param_specs_of(cfg)
        super().__init__({k: s for k, s in specs.items()
                          if isinstance(s, ParamSpec)}, dev)
        self.cfg = cfg
        for name, layers in _stacks(cfg, dev):
            self._modules[name] = nn.ModuleList(layers)
        if dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            self.init_weights(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------------------------------------------- specs
    @staticmethod
    def param_specs_of(cfg: ArchConfig) -> PyTree:
        specs = _top_specs(cfg)
        if cfg.family == "ssm":
            specs["layers"] = stack_specs(cfg.num_layers,
                                          rwkv.rwkv_layer_specs(cfg))
            return specs
        if cfg.family == "audio":
            d = cfg.d_model
            specs["pos_embed"] = ParamSpec(
                (40960, d), (None, "embed_fsdp"), dtype=torch.bfloat16,
                init="embed", scale=0.01)
            specs["enc_pos_embed"] = ParamSpec(
                (cfg.encoder_seq, d), (None, "embed_fsdp"),
                dtype=torch.bfloat16, init="embed", scale=0.01)
            specs["enc_final_norm"] = ParamSpec(
                (d,), (None,), dtype=torch.bfloat16, init="ones")
            specs["encoder"] = stack_specs(
                cfg.encoder_layers, encdec.encoder_layer_specs(cfg))
            specs["decoder"] = stack_specs(
                cfg.num_layers, encdec.decoder_layer_specs(cfg))
            return specs
        for gi, g in enumerate(tfm.layer_groups(cfg)):
            specs[f"group{gi}"] = stack_specs(
                g.count, tfm.layer_specs(cfg, g.kind)
            )
        return specs

    def param_specs(self) -> PyTree:
        return self.param_specs_of(self.cfg)

    def batch_specs(self, batch: int, seq: int) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        b: Dict[str, ParamSpec] = {
            "tokens": ParamSpec((batch, seq), ("batch", None),
                                dtype=torch.int32),
            "labels": ParamSpec((batch, seq), ("batch", None),
                                dtype=torch.int32),
        }
        if cfg.family == "vlm" and cfg.vision_prefix:
            b["patch_embeds"] = ParamSpec(
                (batch, cfg.vision_prefix, cfg.d_model),
                ("batch", None, None), dtype=torch.bfloat16,
            )
        if cfg.family == "audio":
            b["frames"] = ParamSpec(
                (batch, cfg.encoder_seq, cfg.d_model),
                ("batch", None, None), dtype=torch.bfloat16,
            )
        return b

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every leaf on the model's device, each layer's from that
        layer's own specs (``layer.specs``), so a normal matrix's fan-in
        is its leading axis, and each expert of an ``experts`` leaf from
        that expert's own matrix (fan-in d for ``wi``/``wg``, the expert
        width for ``wo``; no fp32 copy of the whole stack).  The reference
        draws a stacked ``[L, ...]`` leaf whole, which makes its fan-in
        the layer count L, and an expert stack's the expert count (ROADMAP
        queue 3, R7)."""
        dev = self.device
        for name, spec in self.param_specs().items():
            if isinstance(spec, ParamSpec):
                self[name].copy_(spec.initializer(generator, dev))
        for _, _, layer in self.layers():
            for path, s in spec_leaves(layer.specs):
                p = layer
                for k in path:
                    p = p[k]
                if s.names[0] != "experts":
                    p.copy_(s.initializer(generator, dev))
                    continue
                one = ParamSpec(s.shape[1:], s.names[1:], dtype=s.dtype,
                                init=s.init, scale=s.scale)
                for e in range(s.shape[0]):
                    p[e].copy_(one.initializer(generator, dev))

    def layers(self):
        """(stack name, layer index, layer) of every layer, stack by
        stack (whisper: the encoder's, then the decoder's)."""
        for name, stack in self.named_children():
            for li, layer in enumerate(stack):
                yield name, li, layer

    # ----------------------------------------------------------- embeddings
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.to(self.device).long()]
        if self.cfg.embed_scale:
            x = x * rounded(math.sqrt(self.cfg.d_model), x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm)
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = x @ w
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

    def _inputs(self, batch) -> torch.Tensor:
        """The embedded tokens, behind the VLM's patch prefix."""
        x = self._embed(batch["tokens"])
        if self.cfg.family == "vlm" and self.cfg.vision_prefix:
            patches = batch["patch_embeds"].to(self.device, x.dtype)
            x = torch.cat([patches, x], dim=1)
        return x

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        dim = cfg.mla_qk_rope_dim if cfg.mla else cfg.head_dim
        return rope(positions, dim, cfg.rope_theta)

    # ----------------------------------------------------------------- loss
    def loss(self, batch, *, remat: bool = True) -> torch.Tensor:
        """Mean next-token CE.  Under autograd each layer runs under
        activation checkpointing when ``remat`` (the reference's
        ``jax.checkpoint`` around each layer body; whisper's encoder and
        decoder layers and RWKV's layers alike): its activations are
        recomputed in the backward, only its inputs are kept.  The hybrid's
        SSM scan and RWKV's wkv also checkpoint each chunk of their
        recurrence (``ssm.chunk_remat``), whatever ``remat`` says."""
        labels = batch["labels"].to(self.device)
        remat = remat and torch.is_grad_enabled()
        if self.cfg.family == "ssm":
            x = self._rwkv_run(self._embed(batch["tokens"]), remat=remat)
            return _cross_entropy(self._logits(x), labels)
        if self.cfg.family == "audio":
            x, _ = self._whisper_decoder(batch, remat=remat)
            return _cross_entropy(self._logits(x), labels)
        x = self._inputs(batch)
        sin, cos = self._rope(torch.arange(x.shape[1], device=self.device))
        for _, _, layer in self.layers():
            if remat:
                x = checkpoint(_layer_out, layer, x, sin, cos,
                               use_reentrant=False)
            else:
                x, _ = layer(x, sin, cos)
        if self.cfg.family == "vlm" and self.cfg.vision_prefix:
            x = x[:, self.cfg.vision_prefix:]
        return _cross_entropy(self._logits(x), labels)

    # -------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_len: int) -> PyTree:
        cfg = self.cfg
        dt = torch.bfloat16
        names = ("layers", "batch", "seq", None)
        kv_names = names[:3] + ("kv_heads", None)
        if cfg.family == "ssm":
            h, hd = rwkv.rwkv_heads(cfg)
            shift = ParamSpec((cfg.num_layers, batch, cfg.d_model),
                              ("layers", "batch", None), dtype=dt,
                              init="zeros")
            return {"shift1": shift, "shift2": shift, "wkv": ParamSpec(
                (cfg.num_layers, batch, h, hd, hd),
                ("layers", "batch", "heads", None, None),
                dtype=torch.float32, init="zeros")}
        if cfg.family == "audio":
            return {key: ParamSpec((cfg.num_layers, batch, t,
                                    cfg.num_kv_heads, cfg.head_dim),
                                   kv_names, dtype=dt, init="zeros")
                    for key, t in (("k", max_len), ("v", max_len),
                                   ("ck", cfg.encoder_seq),
                                   ("cv", cfg.encoder_seq))}
        caches = {}
        for gi, g in enumerate(tfm.layer_groups(cfg)):
            if cfg.mla:
                c = {key: ParamSpec((g.count, batch, max_len, width), names,
                                    dtype=dt, init="zeros")
                     for key, width in (("ckv", cfg.mla_kv_lora_rank),
                                        ("kr", cfg.mla_qk_rope_dim))}
            else:
                t = (min(max_len, cfg.window) if tfm.ring_cache(cfg)
                     else max_len)
                shape = (g.count, batch, t, cfg.num_kv_heads, cfg.head_dim)
                c = {kv: ParamSpec(shape, kv_names, dtype=dt, init="zeros")
                     for kv in ("k", "v")}
            if cfg.hybrid_parallel:
                d_in, _, n, k = ssm._dims(cfg)
                c["conv"] = ParamSpec(
                    (g.count, batch, k - 1, d_in),
                    ("layers", "batch", None, "ffn"), dtype=dt, init="zeros")
                c["ssm"] = ParamSpec(
                    (g.count, batch, d_in, n),
                    ("layers", "batch", "ffn", None), dtype=torch.float32,
                    init="zeros")
            caches[f"group{gi}"] = c
        return caches

    def init_cache(self, batch: int, max_len: int) -> PyTree:
        """A zero decode cache on the model's device."""
        def zeros(specs):
            return {k: s.initializer(None, self.device)
                    if isinstance(s, ParamSpec) else zeros(s)
                    for k, s in specs.items()}

        return zeros(self.cache_specs(batch, max_len))

    def prefill(self, batch, max_len: int):
        """Run the full prompt, return (last-token logits, decode cache).

        Each layer's cache lands in a zero cache of ``max(S, max_len)``
        slots, so the slots past S stay exact zeros (the reference's
        ``_pad_prefill_cache``, in place).  The hybrid's ring keeps the
        last ``min(S, T)`` positions, position p in slot ``p % T``, the
        slots past S zero when S < T.  The reference keeps only S slots
        then, and its decode overwrites token 0 (ROADMAP queue 3, R10)."""
        if self.cfg.family == "ssm":
            return self._rwkv_prefill(batch)
        if self.cfg.family == "audio":
            return self._whisper_prefill(batch, max_len)
        x = self._inputs(batch)
        b, s = x.shape[:2]
        sin, cos = self._rope(torch.arange(s, device=self.device))
        cache = self.init_cache(b, max(s, max_len))
        for g, li, layer in self.layers():
            x, lc = layer(x, sin, cos)
            for key, t in lc.items():
                dst = cache[g][key][li]
                if key in ("conv", "ssm"):
                    dst.copy_(t)
                elif key in ("k", "v") and tfm.ring_cache(self.cfg):
                    lo = max(0, s - dst.shape[1])
                    slots = torch.arange(lo, s, device=self.device)
                    dst.index_copy_(1, slots % dst.shape[1], t[:, lo:])
                else:
                    dst[:, :s] = t
        logits = self._logits(x[:, -1:, :])[:, 0]
        return logits, cache

    def decode_step(self, cache, tokens: torch.Tensor, pos):
        """tokens int[B, 1]; pos an int or a 0-d integer tensor.  Returns
        (logits [B, V], cache), the cache written in place.  No host sync:
        ``pos`` goes to the device once and stays there."""
        if self.cfg.family == "ssm":  # the state carries the position
            x = self._rwkv_run(self._embed(tokens), cache)
            return self._logits(x)[:, 0], cache
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int64, device=self.device)
        if self.cfg.family == "audio":
            return self._whisper_decode(cache, tokens, pos)
        x = self._embed(tokens)
        sin, cos = self._rope(pos.expand(tokens.shape[0], 1))
        for g, li, layer in self.layers():
            lc = {k: t[li] for k, t in cache[g].items()}
            x, _ = layer.decode(x, sin, cos, lc, pos)
        logits = self._logits(x)[:, 0]
        return logits, cache

    # ------------------------------------------------------------- RWKV-6
    def _rwkv_run(self, x: torch.Tensor, cache=None,
                  remat: bool = False) -> torch.Tensor:
        """x through every layer.  With ``cache`` each layer starts from
        its state there and writes its state after x back in place; with
        ``remat`` (the loss under autograd) each layer is checkpointed and
        only its output x is kept."""
        for li, layer in enumerate(self["layers"]):
            if remat:
                x = checkpoint(_rwkv_out, layer, x, use_reentrant=False)
                continue
            if cache is None:
                x, _ = layer(x)
                continue
            x, state = layer(x, tuple(cache[k][li] for k in RWKV_STATE))
            for k, t in zip(RWKV_STATE, state):
                cache[k][li].copy_(t)
        return x

    def _rwkv_prefill(self, batch):
        """The reference's prefill from zero states; ``max_len`` has no
        part in a constant-size state."""
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], 0)
        x = self._rwkv_run(self._embed(tokens), cache)
        return self._logits(x[:, -1:, :])[:, 0], cache

    # ------------------------------------------------------------- whisper
    def _whisper_encode(self, frames: torch.Tensor,
                        remat: bool = False) -> torch.Tensor:
        x = frames.to(self.device, torch.bfloat16) + self.enc_pos_embed
        for layer in self["encoder"]:
            x = (checkpoint(layer, x, use_reentrant=False) if remat
                 else layer(x))
        return rms_norm(x, self.enc_final_norm)

    def _whisper_decoder(self, batch, remat: bool = False):
        """The decoder over the prompt: (x, [(self kv, cross kv)] of each
        layer).  No ``embed_scale``: tokens plus learned positions.  With
        ``remat`` (the loss under autograd) every encoder and decoder layer
        is checkpointed and no layer's k/v are kept: ``[]``."""
        enc_out = self._whisper_encode(batch["frames"], remat)
        tokens = batch["tokens"].to(self.device).long()
        s = tokens.shape[1]
        x = self.embed[tokens] + self.pos_embed[:s]
        sin, cos = self._rope(torch.arange(s, device=self.device))
        kvs = []
        for layer in self["decoder"]:
            if remat:
                x = checkpoint(_decoder_out, layer, x, enc_out, sin, cos,
                               use_reentrant=False)
                continue
            x, kv, ckv = layer(x, enc_out, sin, cos)
            kvs.append((kv, ckv))
        return x, kvs

    def _whisper_prefill(self, batch, max_len: int):
        x, kvs = self._whisper_decoder(batch)
        b, s = x.shape[:2]
        cache = self.init_cache(b, max(s, max_len))
        for li, ((k, v), (ck, cv)) in enumerate(kvs):
            cache["k"][li, :, :s] = k
            cache["v"][li, :, :s] = v
            cache["ck"][li] = ck
            cache["cv"][li] = cv
        return self._logits(x[:, -1:, :])[:, 0], cache

    def _whisper_decode(self, cache, tokens, pos: torch.Tensor):
        x = (self.embed[tokens.to(self.device).long()]
             + self.pos_embed.index_select(0, pos.reshape(1)))
        sin, cos = self._rope(pos.expand(tokens.shape[0], 1))
        for li, layer in enumerate(self["decoder"]):
            x, _ = layer.decode(x, {k: t[li] for k, t in cache.items()},
                                sin, cos, pos)
        return self._logits(x)[:, 0], cache


def build_model(cfg: ArchConfig, device=None,
                generator: Optional[torch.Generator] = None) -> Model:
    return Model(cfg, device=device, generator=generator)
