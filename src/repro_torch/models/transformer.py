"""Composable decoder-only transformer: GQA, dense FFN, local-global windows.
Port of ``repro/models/transformer.py`` for the dense and VLM families.

One decoder layer is a :class:`DecoderLayer` module and a group of layers
an ``nn.ModuleList``; the reference's ``lax.scan`` over stacked
``[count, ...]`` weights becomes a Python loop over layers, and each
layer's ``window`` (0 = global) is a plain integer.  MLA, MoE and the
hybrid SSM branch raise :class:`NotImplementedError` (ROADMAP queue 1,
M10: the other families).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.common import (
    ParamSpec,
    Params,
    apply_rope,
    attention,
    decode_attention,
    needs_grad,
    rms_norm,
    rounded,
)
from repro_torch.models.config import ArchConfig

GLOBAL_WINDOW = 2 ** 30  # a window of 0 means global
OUT_OF_SLICE = ("ROADMAP queue 1, item 6 (M10: the other families — MoE, "
                "MLA, the hybrid SSM, RWKV, the encoder-decoder)")


def out_of_slice(cfg: ArchConfig) -> Optional[str]:
    """Why ``cfg`` is outside the port's dense and VLM families, or None."""
    if cfg.family not in ("dense", "vlm"):
        return f"family {cfg.family!r}"
    if cfg.mla:
        return "MLA attention"
    if cfg.moe_num_experts:
        return "MoE layers"
    if cfg.hybrid_parallel:
        return "the hybrid SSM branch"
    return None


def require_slice(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not
    run yet; it never runs part of a model."""
    why = out_of_slice(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported to repro_torch yet; see "
            f"{OUT_OF_SLICE}")


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


def gqa_apply_train(cfg: ArchConfig, p, x, sin, cos, window: int):
    """Full-sequence attention (training / prefill); window 0 => global.
    Returns the block's output and this layer's (k, v)."""
    q, k, v = gqa_qkv(cfg, p, x, sin, cos)
    win = _window(window, cfg.window is not None
                  or cfg.local_global_pattern is not None)
    out = attention(q, k, v, causal=True, window=win,
                    softcap=cfg.attn_softcap, q_chunk=1024)
    return _merge_heads(out, p["wo"]), (k, v)


def gqa_apply_decode(cfg: ArchConfig, p, x, sin, cos, window: int, kc, vc,
                     pos: torch.Tensor):
    """Single-token decode; kc/vc: this layer's ``[B, T, KV, hd]`` caches,
    written at slot ``pos`` (a 0-d device tensor) in place and returned."""
    q, k, v = gqa_qkv(cfg, p, x, sin, cos)
    slot = pos.reshape(1)
    kc.index_copy_(1, slot, k)
    vc.index_copy_(1, slot, v)
    win = _window(window, bool(cfg.window or cfg.local_global_pattern))
    out = decode_attention(q, kc, vc, pos + 1, softcap=cfg.attn_softcap,
                           window=win)
    return _merge_heads(out, p["wo"]), (kc, vc)


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


def _silu(x):
    return x * (1 / (1 + torch.exp(-x)))


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


class _SiLU(torch.autograd.Function):
    """``silu`` whose backward is JAX's (``logistic``'s rule ``d * (1 -
    d)``), every step in x's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _silu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = 1 / (1 + torch.exp(-x))
        return g * d + (x * g) * (d * (1 - d))


def _act(cfg: ArchConfig, x):
    """``jax.nn.gelu(approximate=True)`` or ``jax.nn.silu``, written out
    as the reference computes them: every step in x's dtype, the
    constants rounded to it.  Under autograd the backward is the
    reference's too (``_GELU``, ``_SiLU``)."""
    gelu = cfg.ffn_activation == "gelu"
    if needs_grad(x):
        return (_GELU if gelu else _SiLU).apply(x)
    return _gelu(x) if gelu else _silu(x)


def ffn_apply(cfg: ArchConfig, p, x):
    if cfg.gated_ffn:
        h = _act(cfg, x @ p["wg"]) * (x @ p["wi"])
    else:
        h = _act(cfg, x @ p["wi"])
    return h @ p["wo"]  # bf16 out, as the reference's bf16 dot output


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------
def layer_specs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    """A dense layer's specs (``require_slice`` refuses MoE layers)."""
    require_slice(cfg)
    del kind
    d = cfg.d_model
    dt = torch.bfloat16
    p: Dict[str, Any] = {
        "ln1": ParamSpec((d,), (None,), dtype=dt, init="ones"),
        "ln2": ParamSpec((d,), (None,), dtype=dt, init="ones"),
    }
    if cfg.post_block_norms:
        p["ln1_post"] = ParamSpec((d,), (None,), dtype=dt, init="ones")
        p["ln2_post"] = ParamSpec((d,), (None,), dtype=dt, init="ones")
    p["attn"] = gqa_specs(cfg)
    p["ffn"] = ffn_specs(cfg)
    return p


def _norm_offset(cfg: ArchConfig) -> float:
    return 1.0 if cfg.post_block_norms else 0.0


def _ffn_residual(cfg: ArchConfig, p, x, attn_out):
    if cfg.post_block_norms:
        attn_out = rms_norm(attn_out, p["ln1_post"], offset=1.0)
    x = x + attn_out
    h = rms_norm(x, p["ln2"], offset=_norm_offset(cfg))
    ffn_out = ffn_apply(cfg, p["ffn"], h)
    if cfg.post_block_norms:
        ffn_out = rms_norm(ffn_out, p["ln2_post"], offset=1.0)
    return x + ffn_out


def layer_apply_train(cfg: ArchConfig, kind: str, p, x, sin, cos,
                      window: int):
    """Returns (x_out, (k, v)): prefill keeps the layer's cache, the loss
    drops it."""
    del kind  # dense only
    h = rms_norm(x, p["ln1"], offset=_norm_offset(cfg))
    attn_out, kv = gqa_apply_train(cfg, p["attn"], h, sin, cos, window)
    return _ffn_residual(cfg, p, x, attn_out), kv


def layer_apply_decode(cfg: ArchConfig, kind: str, p, x, sin, cos,
                       window: int, cache: Dict[str, torch.Tensor],
                       pos: torch.Tensor):
    """cache: this layer's ``{"k", "v"}`` (written in place); returns
    (x, cache)."""
    del kind
    h = rms_norm(x, p["ln1"], offset=_norm_offset(cfg))
    attn_out, (kc, vc) = gqa_apply_decode(
        cfg, p["attn"], h, sin, cos, window, cache["k"], cache["v"], pos)
    return _ffn_residual(cfg, p, x, attn_out), {"k": kc, "v": vc}


class DecoderLayer(Params):
    """One decoder layer's weights (``layer_specs``), its kind and window."""

    def __init__(self, cfg: ArchConfig, kind: str, window: int, device):
        super().__init__(layer_specs(cfg, kind), device)
        self.cfg, self.kind, self.window = cfg, kind, window

    def forward(self, x, sin, cos):
        return layer_apply_train(self.cfg, self.kind, self, x, sin, cos,
                                 self.window)

    def decode(self, x, sin, cos, cache, pos):
        return layer_apply_decode(self.cfg, self.kind, self, x, sin, cos,
                                  self.window, cache, pos)


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
