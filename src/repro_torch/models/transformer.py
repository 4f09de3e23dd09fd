"""Composable decoder-only transformer: GQA / MoE / MLA / local-global /
the hybrid SSM branch.  Port of ``repro/models/transformer.py``.

One decoder layer is a :class:`DecoderLayer` module and a group of layers
an ``nn.ModuleList``; the reference's ``lax.scan`` over stacked
``[count, ...]`` weights becomes a Python loop over layers, and each
layer's ``window`` (0 = global) is a plain integer.  Deepseek's leading
dense layers before its MoE stack stay a group of their own
(``layer_groups``).  The MoE layer is the reference's single-device
dispatch (capacity, keep and drop rule, gates) computed with index
operations.  RWKV and the encoder-decoder have modules of their own
(``rwkv.py``, ``encdec.py``).

On a mesh with a ``model`` axis (``sharding.model_axis()``, the train
and serve steps of ``distributed/train.py``) each rank holds its block
of every weight: ``wq``/``wk``/``wv``/``wi``/``wg`` split over their
heads or ffn columns (column-parallel), ``wo`` over its rows
(row-parallel), where the axis divides the dim; the norms, the router
and MLA's down projections whole.  The residual stream is split over
the sequence (sequence parallelism): a block's normed input is gathered
to the whole sequence (``ModelAxis.enter``, the reference's bf16 gather
point) and its output, a partial sum when ``wo`` is split, goes back by
a reduce-scatter (``ModelAxis.leave``).  Keys and values whose heads do
not divide the axis take the reference's layout branch
(``kv_layout``).  The MoE takes ``moe_distributed.moe_apply_sharded``
under the reference's rule, else the dense dispatch over this rank's
experts, summed over the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (
    all_gather,
    all_reduce,
    axis_group,
    model_axis,
)
from repro_torch.models import ssm
from repro_torch.models.common import (
    MASKED,
    ParamSpec,
    Params,
    apply_rope,
    attention,
    decode_attention,
    needs_grad,
    rms_norm,
    rounded,
    silu,
)
from repro_torch.models.config import ArchConfig

GLOBAL_WINDOW = 2 ** 30  # a window of 0 means global


def ring_cache(cfg: ArchConfig) -> bool:
    """Whether the k/v cache is a sliding ring of ``min(max_len, window)``
    slots (the hybrid family's): position p lives in slot ``p % T``."""
    return cfg.family == "hybrid" and bool(cfg.window)


def _window(window: int, present: bool) -> Optional[int]:
    return (window if window > 0 else GLOBAL_WINDOW) if present else None


# ---------------------------------------------------------------------------
# Attention blocks
# ---------------------------------------------------------------------------
def gqa_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    p = {
        "wq": ParamSpec((d, h, hd), ("hidden", "heads", None), dtype=dt),
        "wk": ParamSpec((d, kv, hd), ("hidden", "kv_heads", None), dtype=dt),
        "wv": ParamSpec((d, kv, hd), ("hidden", "kv_heads", None), dtype=dt),
        "wo": ParamSpec((h, hd, d), ("heads", None, "hidden"), dtype=dt),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((h, hd), ("heads", None), dtype=dt, init="zeros")
        p["bk"] = ParamSpec((kv, hd), ("kv_heads", None), dtype=dt, init="zeros")
        p["bv"] = ParamSpec((kv, hd), ("kv_heads", None), dtype=dt, init="zeros")
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _merge_heads(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matmul, in the operands' dtype."""
    return out.flatten(2) @ wo.flatten(0, 1)


def gqa_qkv(cfg: ArchConfig, p, x, sin, cos):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def kv_branch(heads: int, kv_heads: int, ax) -> Optional[str]:
    """The reference's attention layout on the ``model`` axis (its
    ``attention``, ``common.py:175-195``): None when the axis divides the
    KV heads (each rank its heads); ``"repeat"`` when it divides only the
    query heads, which share KV heads: K and V repeated to the query
    heads, each rank its heads; else ``"seq"``: K and V split over the
    sequence, the softmax's statistics combined across the ranks."""
    if ax is None or ax.splits(kv_heads):
        return None
    if ax.splits(heads) and heads // kv_heads > 1:
        return "repeat"
    return "seq"


def kv_layout(heads: int, kv_heads: int, k, v, ax):
    """``(k, v, kv_offset, group)`` for ``attention`` of this rank's
    queries (its heads, or all of them) under ``kv_branch``: k and v
    ``[B, T, KV', D]`` as computed (this rank's KV heads, or all of
    them)."""
    branch = kv_branch(heads, kv_heads, ax)
    if branch == "repeat":
        start, n = ax.block(heads)
        g = heads // kv_heads
        return (k.repeat_interleave(g, 2).narrow(2, start, n),
                v.repeat_interleave(g, 2).narrow(2, start, n), 0, None)
    if branch == "seq" and ax.seq:
        start, n = ax.block(k.shape[1])
        return k.narrow(1, start, n), v.narrow(1, start, n), start, ax.group
    return k, v, 0, None


def _decode_kv(heads: int, kv_heads: int, kc, vc, ax):
    """This rank's query heads' K and V from a decode cache that holds
    every KV head (the ``"repeat"`` branch); else the cache as is."""
    if kv_branch(heads, kv_heads, ax) != "repeat":
        return kc, vc
    start, n = ax.block(heads)
    idx = torch.arange(start, start + n, device=kc.device) // (
        heads // kv_heads)
    return kc.index_select(2, idx), vc.index_select(2, idx)


def _leave(y, width: int):
    """A block's output onto the residual stream (``ModelAxis.leave``):
    a partial sum when its contracted dim, ``width`` wide, is split over
    ``model``."""
    ax = model_axis()
    return y if ax is None else ax.leave(y, ax.splits(width))


def gqa_apply_train(cfg: ArchConfig, p, x, sin, cos, window: int):
    """Full-sequence attention (training / prefill); window 0 => global.
    Returns the block's output and this layer's (k, v)."""
    q, k, v = gqa_qkv(cfg, p, x, sin, cos)
    win = _window(window, cfg.window is not None
                  or cfg.local_global_pattern is not None)
    ka, va, offset, group = kv_layout(cfg.num_heads, cfg.num_kv_heads, k,
                                      v, model_axis())
    out = attention(q, ka, va, causal=True, window=win,
                    softcap=cfg.attn_softcap, q_chunk=1024,
                    kv_offset=offset, group=group)
    return _leave(_merge_heads(out, p["wo"]), cfg.num_heads), (k, v)


def gqa_apply_decode(cfg: ArchConfig, p, x, sin, cos, window: int, kc, vc,
                     pos: torch.Tensor):
    """Single-token decode; kc/vc: this layer's ``[B, T, KV, hd]`` caches,
    written in place and returned; ``pos`` is a 0-d device tensor.  The
    hybrid family's cache is a ring of T slots: position ``pos`` lands in
    slot ``pos % T`` and every valid slot is in the window."""
    q, k, v = gqa_qkv(cfg, p, x, sin, cos)
    t = kc.shape[1]
    ring = ring_cache(cfg)
    slot = (pos % t if ring else pos).reshape(1)
    kc.index_copy_(1, slot, k)
    vc.index_copy_(1, slot, v)
    ka, va = _decode_kv(cfg.num_heads, cfg.num_kv_heads, kc, vc,
                        model_axis())
    if ring:
        out = decode_attention(q, ka, va, torch.clamp(pos + 1, max=t),
                               softcap=cfg.attn_softcap)
    else:
        win = _window(window, bool(cfg.window or cfg.local_global_pattern))
        out = decode_attention(q, ka, va, pos + 1, softcap=cfg.attn_softcap,
                               window=win)
    return _leave(_merge_heads(out, p["wo"]), cfg.num_heads), (kc, vc)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3) attention
# ---------------------------------------------------------------------------
def mla_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank
    nope, rpe, vd = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim
    dt = torch.bfloat16
    return {
        "wq_a": ParamSpec((d, qr), ("hidden", "rank"), dtype=dt),
        "q_norm": ParamSpec((qr,), ("rank",), dtype=dt, init="ones"),
        "wq_b": ParamSpec((qr, h, nope + rpe), ("rank", "heads", None),
                          dtype=dt),
        "wkv_a": ParamSpec((d, kvr + rpe), ("hidden", "rank"), dtype=dt),
        "kv_norm": ParamSpec((kvr,), ("rank",), dtype=dt, init="ones"),
        "wkv_b": ParamSpec((kvr, h, nope + vd), ("rank", "heads", None),
                           dtype=dt),
        "wo": ParamSpec((h, vd, d), ("heads", None, "hidden"), dtype=dt),
    }


def _mla_q(cfg: ArchConfig, p, x, sin, cos):
    """(q_nope, q_rope) ``[B, S, H, nope]``, ``[B, S, H, rope]``."""
    nope = cfg.mla_qk_nope_dim
    q = _heads(rms_norm(x @ p["wq_a"], p["q_norm"]), p["wq_b"])
    return q[..., :nope], apply_rope(q[..., nope:], sin, cos)


def _mla_latent(cfg: ArchConfig, p, x, sin, cos):
    """(c_kv ``[B, S, kv_lora]``, k_rope ``[B, S, 1, rope]``): what the
    cache keeps."""
    kvr = cfg.mla_kv_lora_rank
    ckv_full = x @ p["wkv_a"]  # [B, S, kvr + rope]
    c_kv = rms_norm(ckv_full[..., :kvr], p["kv_norm"])
    return c_kv, apply_rope(ckv_full[..., None, kvr:], sin, cos)


def mla_apply_train(cfg: ArchConfig, p, x, sin, cos, window: int):
    """Full-sequence MLA: the latent expanded to per-head keys (qk
    ``nope + rope`` wide) and values (``v_dim``).  Returns the block's
    output and this layer's (c_kv, k_rope)."""
    del window
    nope, rpe = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    q_nope, q_rope = _mla_q(cfg, p, x, sin, cos)
    c_kv, k_rope = _mla_latent(cfg, p, x, sin, cos)
    kvx = _heads(c_kv, p["wkv_b"])
    k_nope, v = kvx[..., :nope], kvx[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], rpe)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    h = cfg.num_heads
    ka, va, offset, group = kv_layout(h, h, k, v, model_axis())
    out = attention(q, ka, va, causal=True, q_chunk=1024,
                    scale=1.0 / math.sqrt(nope + rpe), kv_offset=offset,
                    group=group)
    return _leave(_merge_heads(out, p["wo"]), h), (c_kv, k_rope[:, :, 0, :])


def mla_apply_decode(cfg: ArchConfig, p, x, sin, cos, window: int, ckv_c,
                     kr_c, pos: torch.Tensor):
    """Absorbed-matmul MLA decode: attention runs in the latent space, so
    the cache stays ``[B, T, kv_lora]`` (+ ``[B, T, rope]``), written at
    slot ``pos`` in place.  Scores in fp32, probabilities in bf16."""
    del window
    nope, rpe = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim
    q_nope, q_rope = _mla_q(cfg, p, x, sin, cos)  # s == 1
    c_kv, k_rope = _mla_latent(cfg, p, x, sin, cos)
    slot = pos.reshape(1)
    ckv_c.index_copy_(1, slot, c_kv)
    kr_c.index_copy_(1, slot, k_rope[:, :, 0, :])
    wkb = p["wkv_b"]  # [kvr, H, nope + vd]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wkb[..., :nope])
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv_c.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             kr_c.float())) * (1.0 / math.sqrt(nope + rpe))
    mask = torch.arange(ckv_c.shape[1], device=x.device) <= pos
    scores.masked_fill_(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs.to(ckv_c.dtype), ckv_c)
    out = torch.einsum("bshr,rhk->bshk", out_lat, wkb[..., nope:])
    return _leave(_merge_heads(out, p["wo"]), cfg.num_heads), (ckv_c, kr_c)


# ---------------------------------------------------------------------------
# FFN blocks
# ---------------------------------------------------------------------------
def ffn_specs(cfg: ArchConfig, d_ff: Optional[int] = None
              ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = torch.bfloat16
    p = {
        "wi": ParamSpec((d, ff), ("hidden", "ffn"), dtype=dt),
        "wo": ParamSpec((ff, d), ("ffn", "hidden"), dtype=dt),
    }
    if cfg.gated_ffn:
        p["wg"] = ParamSpec((d, ff), ("hidden", "ffn"), dtype=dt)
    return p


def _gelu_consts(dtype: torch.dtype):
    return (rounded(math.sqrt(2.0 / math.pi), dtype),
            rounded(0.044715, dtype))


def _gelu(x):
    c, a = _gelu_consts(x.dtype)
    return x * (0.5 * (1 + torch.tanh(c * (x + a * (x * x * x)))))


class _GELU(torch.autograd.Function):
    """Tanh-``gelu`` whose backward is JAX's derivative of the reference's
    expression, every step in x's dtype (XLA's CPU lowering rounds each)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c, a = _gelu_consts(x.dtype)
        x2 = x * x
        t = torch.tanh(c * (x + a * (x2 * x)))
        p = (0.5 * (x * g)) * (1 - t)
        s = c * (p + p * t)
        return (g * (0.5 * (1 + t)) + s) + (a * s) * (3 * x2)


def _act(cfg: ArchConfig, x):
    """``jax.nn.gelu(approximate=True)`` or ``jax.nn.silu``, written out
    as the reference computes them: every step in x's dtype, the
    constants rounded to it.  Under autograd the backward is the
    reference's too (``_GELU``, ``common._SiLU``)."""
    if cfg.ffn_activation != "gelu":
        return silu(x)
    return _GELU.apply(x) if needs_grad(x) else _gelu(x)


def ffn_apply(cfg: ArchConfig, p, x, width: Optional[int] = None):
    """The FFN (``width``: its hidden width, ``d_ff`` by default): on the
    ``model`` axis its ffn columns split, its output left onto the
    residual stream (``_leave``)."""
    if cfg.gated_ffn:
        h = _act(cfg, x @ p["wg"]) * (x @ p["wi"])
    else:
        h = _act(cfg, x @ p["wi"])
    # bf16 out, as the reference's bf16 dot output
    return _leave(h @ p["wo"], width or cfg.d_ff)


# ---------------------------------------------------------------------------
# MoE block (the reference's single-device dispatch, by index operations)
# ---------------------------------------------------------------------------
def moe_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    eff = cfg.moe_d_ff or cfg.d_ff
    ne = cfg.moe_num_experts
    dt = torch.bfloat16
    p: Dict[str, Any] = {
        "router": ParamSpec((d, ne), ("hidden", None), dtype=torch.float32),
        "wi": ParamSpec((ne, d, eff), ("experts", "hidden", None), dtype=dt),
        "wg": ParamSpec((ne, d, eff), ("experts", "hidden", None), dtype=dt),
        "wo": ParamSpec((ne, eff, d), ("experts", None, "hidden"), dtype=dt),
    }
    if cfg.moe_num_shared:
        p["shared"] = ffn_specs(cfg, d_ff=eff * cfg.moe_num_shared)
    return p


def moe_capacity(cfg: ArchConfig, n_tok: int) -> int:
    """Slots per expert for ``n_tok`` tokens: twice the mean load, at
    least 4, at most ``n_tok``."""
    cap = max(int(2 * n_tok * cfg.moe_top_k / cfg.moe_num_experts), 4)
    return min(cap, n_tok)


def moe_apply(cfg: ArchConfig, p, x, stats: Optional[dict] = None):
    """Top-k routed experts + the optional shared expert; x ``[B, S, d]``.

    The reference's single-device semantics: fp32 router logits, ``top_k``
    then a softmax over the k gates; each (token, k) pair takes the next
    slot of its expert's ``moe_capacity`` in (token, k) order, and pairs
    past capacity are dropped (only the shared expert sees them).  The
    reference builds one-hot ``[E, T, C]`` dispatch and ``[T, C, E]``
    combine tensors; here the kept rows are gathered into an ``[E, C, d]``
    buffer, the experts run as three batched matmuls, and each pair's
    output is gathered back and summed with its bf16 gate (0 for a
    dropped pair) in fp32, rounded once.  ``stats``, when given, receives
    the 0-d device tensors ``dropped`` (pairs) and ``experts_hit``
    (experts with a pair): no host sync.

    On the ``model`` axis (the reference's ``moe_apply``, ``transformer.
    py:285-301``): the expert-parallel dispatch of ``moe_distributed``
    when a policy allows it, the axis divides the experts and each of
    the ``model`` x data-parallel shards gets 8 tokens or more; else this
    dense dispatch over the global batch (gathered over the data-parallel
    ranks) for this rank's experts only, summed over the ranks that hold
    the others (``_moe_dense_mesh``)."""
    ax = model_axis()
    if ax is not None:
        return _moe_mesh(cfg, p, x, stats, ax)
    out = moe_dense(cfg, p, x, stats)
    if cfg.moe_num_shared:
        out = out + ffn_apply(cfg, p["shared"], x)
    return out


def moe_dense(cfg: ArchConfig, p, x, stats: Optional[dict] = None,
              experts: Optional[Tuple[int, int]] = None):
    """:func:`moe_apply`'s routed experts; ``experts`` ``(first, count)``:
    the weights ``p`` hold only those experts, and only they are
    computed (every other expert's output is zero), and ``stats`` also
    gets the pairs' ``keep`` mask ``[T, k]`` (``first`` 0)."""
    b, s, d = x.shape
    ne, topk = cfg.moe_num_experts, cfg.moe_top_k
    n_tok = b * s
    xf = x.reshape(n_tok, d)
    logits = xf.float() @ p["router"]  # [T, E]
    gates, chosen = torch.topk(logits, topk, dim=-1)  # descending
    gates = torch.softmax(gates, dim=-1).to(x.dtype).float()
    cap = moe_capacity(cfg, n_tok)

    # each pair's position within its expert, counted in (token, k) order
    flat = chosen.reshape(-1)
    onehot = torch.zeros((n_tok * topk, ne), dtype=torch.int32,
                         device=x.device).scatter_(1, flat[:, None], 1)
    seen = onehot.cumsum(0, dtype=torch.int32)  # [T*k, E]
    pos = seen.gather(1, flat[:, None])[:, 0] - 1
    keep = pos < cap
    trash = ne * cap  # one slot past the experts': dropped pairs go there
    dest = torch.where(keep, flat * cap + pos, trash)

    # dispatch: each slot reads its token's row; an empty slot reads row
    # 0, and its output is never read
    src = torch.zeros((trash + 1,), dtype=torch.long, device=x.device)
    src.index_copy_(0, dest, torch.arange(n_tok * topk, device=x.device)
                    // topk)
    expert_in = xf[src[:trash]].view(ne, cap, d)
    if experts is not None:
        expert_in = expert_in[experts[0]:experts[0] + experts[1]]
    h = _act(cfg, torch.bmm(expert_in, p["wg"])) * torch.bmm(expert_in,
                                                             p["wi"])
    expert_out = torch.bmm(h, p["wo"])
    if experts is not None:  # the other experts' outputs: zero
        lo, n = experts
        expert_out = torch.cat([expert_out.new_zeros((lo, cap, d)),
                                expert_out, expert_out.new_zeros(
                                    (ne - lo - n, cap, d))])
    expert_out = expert_out.reshape(trash, d)  # [E * C, d]

    # combine: each pair's row with its gate; a dropped pair's gate is 0
    rows = expert_out[dest.clamp(max=trash - 1)].view(n_tok, topk, d)
    gates = torch.where(keep.view(n_tok, topk), gates, 0.0)
    acc = rows[:, 0].float() * gates[:, 0:1]
    for j in range(1, topk):
        acc = acc + rows[:, j].float() * gates[:, j:j + 1]
    if stats is not None:
        stats["dropped"] = (~keep).sum()
        stats["experts_hit"] = (seen[-1] > 0).sum()
        if experts is not None:  # on a mesh: every token's pairs
            stats["keep"], stats["first"] = keep.view(n_tok, topk), 0
    return acc.to(x.dtype).view(b, s, d)


def expert_block(cfg: ArchConfig, ax) -> Tuple[Tuple[str, ...], int, int]:
    """``(mesh axes, first, count)`` of the experts this rank holds: the
    ``experts`` dim's spec entry (``("data", "model")``: whole experts,
    full EP; ``("model",)``: model-axis EP; ``()``: every expert)."""
    ne, d = cfg.moe_num_experts, cfg.d_model
    eff = cfg.moe_d_ff or cfg.d_ff
    names, shape = ("experts", "hidden", None), (ne, d, eff)
    entry = ax.policy.spec_for(names, shape)[:1]
    axes = () if not entry or entry[0] is None else (
        entry[0] if isinstance(entry[0], tuple) else (entry[0],))
    sl = ax.policy.local_slices(names, shape, ax.mesh.get_coordinate())[0]
    lo, hi, _ = sl.indices(ne)
    return axes, lo, hi - lo


def _moe_mesh(cfg: ArchConfig, p, x, stats, ax):
    from repro_torch.models import moe_distributed

    b, s, _ = x.shape
    nshards = ax.size * ax.dp
    if (ax.policy.allow_shard_map and ax.size > 1
            and ax.splits(cfg.moe_num_experts)
            and (b * ax.dp * s) // nshards >= 8):  # enough tokens a shard
        out = ax.leave(moe_distributed.moe_apply_sharded(cfg, p, x, ax,
                                                         stats), True)
    else:
        out = _moe_dense_mesh(cfg, p, x, stats, ax)
    if cfg.moe_num_shared:
        out = out + ffn_apply(cfg, p["shared"], x,
                              (cfg.moe_d_ff or cfg.d_ff) * cfg.moe_num_shared)
    return out


def _moe_dense_mesh(cfg: ArchConfig, p, x, stats, ax):
    """The reference's dense fallback under a mesh: the routing, capacity
    and slots of the global batch (every data-parallel rank's rows,
    gathered), the outputs of this rank's experts, summed over the ranks
    holding the others, this rank's rows kept."""
    b = x.shape[0]
    axes, lo, n = expert_block(cfg, ax)
    xg = all_gather(x, 0, ax.dp_group)
    y = moe_dense(cfg, p, xg, stats, experts=(lo, n))
    if "data" in axes:  # the other data ranks' experts
        y = all_reduce(y, axis_group(ax.mesh, ("data",)))
    y = y.narrow(0, ax.dp_index * b, b)
    return ax.leave(y, "model" in axes)


# ---------------------------------------------------------------------------
# Decoder layer (dense or moe ffn; gqa or mla attention; optional ssm branch)
# ---------------------------------------------------------------------------
def layer_specs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    dt = torch.bfloat16
    p: Dict[str, Any] = {
        "ln1": ParamSpec((d,), (None,), dtype=dt, init="ones"),
        "ln2": ParamSpec((d,), (None,), dtype=dt, init="ones"),
    }
    if cfg.post_block_norms:
        p["ln1_post"] = ParamSpec((d,), (None,), dtype=dt, init="ones")
        p["ln2_post"] = ParamSpec((d,), (None,), dtype=dt, init="ones")
    p["attn"] = mla_specs(cfg) if cfg.mla else gqa_specs(cfg)
    if cfg.hybrid_parallel:
        p["ssm"] = ssm.mamba_specs(cfg)
        p["ssm_norm"] = ParamSpec((d,), (None,), dtype=dt, init="ones")
        p["attn_norm"] = ParamSpec((d,), (None,), dtype=dt, init="ones")
    p["ffn"] = moe_specs(cfg) if kind == "moe" else ffn_specs(cfg)
    return p


def _norm_offset(cfg: ArchConfig) -> float:
    return 1.0 if cfg.post_block_norms else 0.0


def _hybrid(p, attn_out, ssm_out):
    """The hybrid's two branches, each normalized, averaged."""
    return 0.5 * (rms_norm(attn_out, p["attn_norm"])
                  + rms_norm(ssm_out, p["ssm_norm"]))


def _gather_point(h):
    """A block's normed input gathered to the whole sequence on the
    ``model`` axis (``ModelAxis.enter``); as is without one."""
    ax = model_axis()
    return h if ax is None else ax.enter(h)


def _ffn_residual(cfg: ArchConfig, kind: str, p, x, attn_out, stats):
    if cfg.post_block_norms:
        attn_out = rms_norm(attn_out, p["ln1_post"], offset=1.0)
    x = x + attn_out
    h = _gather_point(rms_norm(x, p["ln2"], offset=_norm_offset(cfg)))
    if kind == "moe":
        ffn_out = moe_apply(cfg, p["ffn"], h, stats)
    else:
        ffn_out = ffn_apply(cfg, p["ffn"], h)
    if cfg.post_block_norms:
        ffn_out = rms_norm(ffn_out, p["ln2_post"], offset=1.0)
    return x + ffn_out


def layer_apply_train(cfg: ArchConfig, kind: str, p, x, sin, cos,
                      window: int, stats: Optional[dict] = None):
    """Returns (x_out, this layer's cache): ``{"k", "v"}`` or MLA's
    ``{"ckv", "kr"}`` over the S positions, plus the hybrid's final
    ``{"conv", "ssm"}`` state.  Prefill keeps the cache, the loss drops
    it.  ``stats``: see :func:`moe_apply`."""
    h = _gather_point(rms_norm(x, p["ln1"], offset=_norm_offset(cfg)))
    attn_fn = mla_apply_train if cfg.mla else gqa_apply_train
    attn_out, kv = attn_fn(cfg, p["attn"], h, sin, cos, window)
    cache = dict(zip(("ckv", "kr") if cfg.mla else ("k", "v"), kv))
    if cfg.hybrid_parallel:
        ssm_out, cache["conv"], cache["ssm"] = ssm.mamba_prefill_state(
            cfg, p["ssm"], h)
        attn_out = _hybrid(p, attn_out, ssm_out)
    return _ffn_residual(cfg, kind, p, x, attn_out, stats), cache


def layer_apply_decode(cfg: ArchConfig, kind: str, p, x, sin, cos,
                       window: int, cache: Dict[str, torch.Tensor],
                       pos: torch.Tensor, stats: Optional[dict] = None):
    """cache: this layer's tensors (``layer_apply_train``'s keys), written
    in place; returns (x, cache)."""
    h = rms_norm(x, p["ln1"], offset=_norm_offset(cfg))
    if cfg.mla:
        attn_out, _ = mla_apply_decode(cfg, p["attn"], h, sin, cos, window,
                                       cache["ckv"], cache["kr"], pos)
    else:
        attn_out, _ = gqa_apply_decode(cfg, p["attn"], h, sin, cos, window,
                                       cache["k"], cache["v"], pos)
    if cfg.hybrid_parallel:
        ssm_out, conv_s, ssm_s = ssm.mamba_apply_decode(
            cfg, p["ssm"], h, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
        attn_out = _hybrid(p, attn_out, ssm_out)
    return _ffn_residual(cfg, kind, p, x, attn_out, stats), cache


class DecoderLayer(Params):
    """One decoder layer's weights (``layer_specs``), its kind and window.
    ``moe_stats``: None, or a dict that a caller set on a MoE layer to
    receive its last call's ``dropped`` and ``experts_hit`` (0-d device
    tensors)."""

    def __init__(self, cfg: ArchConfig, kind: str, window: int, device):
        super().__init__(layer_specs(cfg, kind), device)
        self.cfg, self.kind, self.window = cfg, kind, window
        self.moe_stats: Optional[Dict[str, torch.Tensor]] = None

    def forward(self, x, sin, cos):
        return layer_apply_train(self.cfg, self.kind, self, x, sin, cos,
                                 self.window, self.moe_stats)

    def decode(self, x, sin, cos, cache, pos):
        return layer_apply_decode(self.cfg, self.kind, self, x, sin, cos,
                                  self.window, cache, pos, self.moe_stats)


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str  # "dense" | "moe"
    count: int
    windows: Tuple[int, ...]  # per-layer window (0 = global)


def layer_groups(cfg: ArchConfig) -> List[LayerGroup]:
    def window_for(layer_idx: int) -> int:
        if cfg.local_global_pattern:
            pat = cfg.local_global_pattern
            return (
                cfg.window or 0
            ) if pat[layer_idx % len(pat)] == "local" else 0
        if cfg.window:
            return cfg.window
        return 0

    groups: List[LayerGroup] = []
    if cfg.moe_num_experts > 0:
        nd = cfg.moe_first_dense
        if nd:
            groups.append(
                LayerGroup("dense", nd, tuple(window_for(i) for i in range(nd)))
            )
        rest = cfg.num_layers - nd
        groups.append(
            LayerGroup(
                "moe", rest, tuple(window_for(nd + i) for i in range(rest))
            )
        )
    else:
        groups.append(
            LayerGroup(
                "dense",
                cfg.num_layers,
                tuple(window_for(i) for i in range(cfg.num_layers)),
            )
        )
    return groups
