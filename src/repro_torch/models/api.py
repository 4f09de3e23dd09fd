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

On a mesh with a ``model`` axis (``sharding.model_axis()``; the
transformer families) each rank holds its block of the weights
(``transformer.py``) and of the cache (the KV heads split where the axis
divides them; MLA's latents whole).  The embedding is vocab-parallel: a
rank looks up the tokens of its vocab block, zero elsewhere, and the
partial sums go onto the residual stream split over the sequence (the
reference's ``("vocab", "embed_fsdp")`` table); a VLM's patch prefix
rides on the first rank's part.  The logits are vocab-parallel too, and
the loss a vocab-parallel cross-entropy (``_VocabCE``: the max, the sum
of exponentials and the label's logit combined across the ranks), where
the reference gathers the logits whole; the serving logits are gathered
over the vocab.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    activate,
    all_gather,
    all_max,
    all_reduce,
    current_policy,
    model_axis,
)
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


class _VocabCE(torch.autograd.Function):
    """Mean next-token CE in fp32 over logits split along the vocab
    across ``group`` (``[B, S, V/m]``, this rank's block from ``start``);
    every rank gets the loss.  Backward: this rank's block of ``(softmax
    - onehot) / N``, times the loss's cotangent (which every rank holds
    whole: no sum across the ranks) and ``share`` (``1/m`` when the
    logits are whole on each of m ranks: their cotangents are summed)."""

    @staticmethod
    def forward(ctx, logits, labels, start, group, share):
        logits = logits.float()
        m = all_max(logits.amax(-1, keepdim=True), group)
        e = torch.exp(logits - m)
        total = all_reduce(e.sum(-1), group)
        local = labels.long() - start
        mine = (local >= 0) & (local < logits.shape[-1])
        ll = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)
                          [..., None])[..., 0]
        ll = all_reduce(torch.where(mine, ll, 0.0), group)
        nll = m[..., 0] + torch.log(total) - ll
        ctx.save_for_backward(e, total, local, mine)
        ctx.share = share
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        e, total, local, mine = ctx.saved_tensors
        grad = e / total[..., None]
        hit = torch.where(mine, local, 0)[..., None]
        grad.scatter_add_(-1, hit, -mine[..., None].float())
        return grad * (g * ctx.share / local.numel()), None, None, None, None


def spec_leaves(specs: PyTree, prefix=()):
    """(path, spec) of every leaf, in the tree's key order."""
    for k, s in specs.items():
        if isinstance(s, ParamSpec):
            yield prefix + (k,), s
        else:
            yield from spec_leaves(s, prefix + (k,))


def _remat(fn, *args) -> torch.Tensor:
    """``fn(*args)`` under activation checkpointing; its recompute runs
    under the policy active now (the backward may run on another thread,
    where the thread-local policy, and with it the ``model`` axis, is
    not set: autograd's device threads on the card)."""
    policy = current_policy()
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), activate(policy)))


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
    def init_weights(self, generator: torch.Generator,
                     blocks: Optional[Dict[str, Tuple[slice, ...]]] = None,
                     device=None) -> None:
        """Draw every leaf from ``generator`` (on the device), in one
        stream: the top-level leaves, then each layer's from that layer's
        own specs (``layer.specs``), so a normal matrix's fan-in is its
        leading axis, and each expert of an ``experts`` leaf from that
        expert's own matrix (fan-in d for ``wi``/``wg``, the expert width
        for ``wo``; no fp32 copy of the whole stack).  The reference
        draws a stacked ``[L, ...]`` leaf whole, which makes its fan-in
        the layer count L, and an expert stack's the expert count
        (ROADMAP queue 3, R7).

        ``blocks`` (``{name: slices}``, a model built on ``meta``): each
        weight becomes that block of its draw, on ``device``.  The stream
        is drawn whole all the same, one leaf (or expert) at a time, and
        the rest of it dropped, so a block equals the same slice of the
        whole model's weight drawn from the same seed on a device of the
        same type."""
        dev = self.device if device is None else torch.device(device)

        def draw(owner, leaf: str, name: str, s: ParamSpec) -> None:
            sl = None if blocks is None else blocks[name]
            if s.names[0] != "experts":
                t = s.initializer(generator, dev, sl)
                if blocks is None:
                    owner._parameters[leaf].copy_(t)
                else:
                    owner._parameters[leaf] = nn.Parameter(
                        t, requires_grad=False)
                return
            one = ParamSpec(s.shape[1:], s.names[1:], dtype=s.dtype,
                            init=s.init, scale=s.scale)
            lo, hi, _ = (slice(None) if sl is None else sl[0]).indices(
                s.shape[0])
            if blocks is None:
                out = owner._parameters[leaf]
            else:
                out = torch.empty((hi - lo,) + tuple(
                    len(range(*c.indices(n)))
                    for c, n in zip(sl[1:], s.shape[1:])),
                    dtype=s.dtype, device=dev)
            for e in range(s.shape[0]):  # every expert: the stream's order
                t = one.initializer(generator, dev,
                                    None if sl is None else sl[1:])
                if lo <= e < hi:
                    out[e - lo].copy_(t)
            if blocks is not None:
                owner._parameters[leaf] = nn.Parameter(out,
                                                       requires_grad=False)

        for name, spec in self.param_specs().items():
            if isinstance(spec, ParamSpec):
                draw(self, name, name, spec)
        for stack, li, layer in self.layers():
            for path, s in spec_leaves(layer.specs):
                owner = layer
                for k in path[:-1]:
                    owner = owner[k]
                draw(owner, path[-1], ".".join((stack, str(li)) + path), s)

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

    def _embed_parts(self, tokens: torch.Tensor):
        """``(x, partial)``: the embedded tokens, on the ``model`` axis
        this rank's vocab block's (zero for the others' tokens; a partial
        sum over the ranks) when the axis divides the vocab."""
        ax, v = model_axis(), self.cfg.vocab_size
        if ax is None or not ax.splits(v):
            return self._embed(tokens), False
        start, n = ax.block(v)
        t = tokens.to(self.device).long() - start
        mine = ((t >= 0) & (t < n))[..., None].to(self.embed.dtype)
        x = self.embed[t.clamp(0, n - 1)] * mine
        if self.cfg.embed_scale:
            x = x * rounded(math.sqrt(self.cfg.d_model), x.dtype)
        return x, True

    def _vocab_gathered(self, logits: torch.Tensor) -> torch.Tensor:
        """Serving logits whole over the vocab on every rank."""
        ax = model_axis()
        if ax is None or not ax.splits(self.cfg.vocab_size):
            return logits
        return all_gather(logits, logits.dim() - 1, ax.group)

    def _loss_of(self, logits: torch.Tensor, labels: torch.Tensor):
        ax = model_axis()
        if ax is None:
            return _cross_entropy(logits, labels)
        if ax.splits(self.cfg.vocab_size):
            return _VocabCE.apply(logits, labels,
                                  ax.block(self.cfg.vocab_size)[0],
                                  ax.group, 1.0)
        return _VocabCE.apply(logits, labels, 0, None, 1.0 / ax.size)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm)
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = x @ w
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

    def _inputs(self, batch) -> torch.Tensor:
        """The embedded tokens, behind the VLM's patch prefix; on the
        ``model`` axis this rank's part of the residual stream (the
        prefix on the first rank's partial sum)."""
        x, partial = self._embed_parts(batch["tokens"])
        ax = model_axis()
        if self.cfg.family == "vlm" and self.cfg.vision_prefix:
            patches = batch["patch_embeds"].to(self.device, x.dtype)
            if partial and ax.index:
                patches = torch.zeros_like(patches)
            x = torch.cat([patches, x], dim=1)
        return x if ax is None else ax.leave(x, partial)

    def _sequence(self, batch) -> None:
        """The ``model`` axis's residual layout for a full-sequence pass
        of ``batch`` (split over the sequence when it divides)."""
        ax = model_axis()
        if ax is not None:
            prefix = (self.cfg.vision_prefix if self.cfg.family == "vlm"
                      else 0)
            ax.set_sequence(batch["tokens"].shape[1] + prefix)

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
        self._sequence(batch)
        x = self._inputs(batch)
        ax = model_axis()
        total = x.shape[1] * (ax.size if ax is not None and ax.seq else 1)
        sin, cos = self._rope(torch.arange(total, device=self.device))
        for _, _, layer in self.layers():
            if remat:
                x = _remat(_layer_out, layer, x, sin, cos)
            else:
                x, _ = layer(x, sin, cos)
        if ax is not None:
            x = ax.enter(x)
        if self.cfg.family == "vlm" and self.cfg.vision_prefix:
            x = x[:, self.cfg.vision_prefix:]
        return self._loss_of(self._logits(x), labels)

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
                kv, ax = cfg.num_kv_heads, model_axis()
                if ax is not None and ax.splits(kv):  # this rank's heads
                    kv //= ax.size
                shape = (g.count, batch, t, kv, cfg.head_dim)
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
        self._sequence(batch)
        x = self._inputs(batch)
        ax = model_axis()
        b, s = x.shape[0], x.shape[1] * (
            ax.size if ax is not None and ax.seq else 1)
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
        last = x[:, -1:, :] if ax is None else ax.last_token(x)
        return self._vocab_gathered(self._logits(last)[:, 0]), cache

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
        ax = model_axis()
        x, partial = self._embed_parts(tokens)
        if ax is not None:
            ax.set_sequence(None)  # one token: whole on every rank
            x = ax.leave(x, partial)
        sin, cos = self._rope(pos.expand(tokens.shape[0], 1))
        for g, li, layer in self.layers():
            lc = {k: t[li] for k, t in cache[g].items()}
            x, _ = layer.decode(x, sin, cos, lc, pos)
        return self._vocab_gathered(self._logits(x)[:, 0]), cache

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
