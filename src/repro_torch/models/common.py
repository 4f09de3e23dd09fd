"""Shared model-library primitives: param specs, norms, RoPE, attention.
Port of ``repro/models/common.py``.

A model's parameters follow a spec tree: nested dicts whose leaves are
:class:`ParamSpec` (shape, dtype, init, logical dim names).  The same tree
drives initialization and, through :class:`Params`, the ``nn.Module`` that
holds the weights.  The reference's ``constrain`` calls become the
``model`` axis's explicit collectives (``distributed/sharding.py``,
``ModelAxis``), placed by the layers (``transformer.py``);
``attention``'s layout branch is ``transformer.kv_layout``, whose
sequence-split keys and values reach ``attention`` as ``kv_offset`` and
``group``.  ``abstract_params`` is the ``meta`` device
(``build_model(cfg, device="meta")``).

The arithmetic keeps the reference's dtype steps: activations in bf16,
norm statistics in fp32 with the scale multiplies in bf16, attention scores
in fp32 from bf16 operands (``preferred_element_type=float32``), softmax
probabilities cast to bf16 before the PV product.  Attention is plain
PyTorch, as the reference's is plain ``jnp``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

__all__ = [
    "ParamSpec",
    "Params",
    "init_params",
    "rms_norm",
    "layer_norm",
    "rope",
    "apply_rope",
    "attention",
    "decode_attention",
    "Dense",
    "rounded",
    "needs_grad",
    "silu",
]

PyTree = Any
MASKED = -1e30  # the reference's fill for masked scores


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: the scalar that
    ``jnp.asarray(value, dtype)`` multiplies by."""
    return torch.tensor(value, dtype=dtype).item()


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical dim names + init."""

    shape: Tuple[int, ...]
    names: Tuple[str, ...]  # logical dim names, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.names):
            raise ValueError(f"shape {self.shape} vs names {self.names}")

    @property
    def std(self) -> float:
        """The normal draw's standard deviation.  The fan-in is the
        leading axis, as in the reference (for a stacked leaf, the layer
        count)."""
        if self.init == "embed":
            return self.scale or 1.0
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return self.scale if self.scale is not None else 1.0 / math.sqrt(
            fan_in)

    def initializer(self, generator: torch.Generator, device,
                    block: Optional[Tuple[slice, ...]] = None
                    ) -> torch.Tensor:
        """A drawn leaf on ``device``: zeros, ones, or a normal drawn in
        fp32 from ``generator`` (which lives on ``device``), scaled and
        cast.  ``block``: only that slice of the leaf is returned (the
        whole is drawn, so the block's values are the whole's)."""
        shape = self.shape if block is None else tuple(
            len(range(*c.indices(n))) for c, n in zip(block, self.shape))
        if self.init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=device)
        x = torch.randn(self.shape, generator=generator,
                        dtype=torch.float32, device=device)
        if block is None:
            return x.mul_(self.std).to(self.dtype)
        return x[block].mul(self.std).to(self.dtype)


def init_params(specs: PyTree, generator: torch.Generator,
                device) -> PyTree:
    """Materialize a param tree (nested dicts of tensors) from its spec
    tree, each leaf drawn whole, in the tree's key order."""
    if isinstance(specs, ParamSpec):
        return specs.initializer(generator, device)
    return {k: init_params(s, generator, device) for k, s in specs.items()}


class Params(nn.Module):
    """A spec tree as a module: leaves become parameters (no gradient: the
    serving path), dicts submodules.  ``p["wq"]`` and ``"bq" in p`` read it
    as the reference's functions read their dict of arrays; ``specs`` is
    the tree it was built from."""

    def __init__(self, specs: Dict[str, Any], device):
        super().__init__()
        self.specs = specs
        for name, s in specs.items():
            if isinstance(s, ParamSpec):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=s.dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(name, Params(s, device))

    def __getitem__(self, name: str):
        if name in self._modules:  # a stack named as a method (``layers``)
            return self._modules[name]
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a graph through ``tensors`` here: the
    training path takes the backward rules below, serving the plain ops."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rms_stats(x: torch.Tensor, eps: float):
    """``(inverse RMS in x's dtype, rsqrt(r) / r in fp32)`` with ``r`` the
    fp32 mean square plus ``eps``, both ``[..., 1]``."""
    xf = x.float()
    r = (xf * xf).mean(-1, keepdim=True) + eps
    rs = torch.rsqrt(r)
    return rs.to(x.dtype), rs / r


class _RMSNorm(torch.autograd.Function):
    """``rms_norm`` with the reference's backward, step for step as JAX
    differentiates it: the cotangent products in x's dtype, the ``rsqrt``
    rule ``-0.5 * rsqrt(r) / r`` and the mean's ``/ d`` in fp32.  The sums
    (over the rows for the weight, over the features for the statistic)
    accumulate in fp32 and round once; XLA's CPU lowering rounds each
    partial sum of a bf16 reduction to bf16 instead."""

    @staticmethod
    def forward(ctx, x, weight, eps, offset):
        inv, k = _rms_stats(x, eps)
        w = (offset + weight.float()).to(x.dtype)
        ctx.save_for_backward(x, weight, inv, k, w)
        return x * inv * w

    @staticmethod
    def backward(ctx, g):
        x, weight, inv, k, w = ctx.saved_tensors
        gw = (x * inv * g).flatten(0, -2).sum(0).to(weight.dtype)
        gxn = g * w
        gi = (x * gxn).sum(-1, keepdim=True).float()
        gr = gi * (-0.5 * k) / x.shape[-1]
        gx = gxn * inv + (x.float() * gr * 2).to(x.dtype)
        return gx, gw, None, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm: fp32 statistics; only the ``[..., 1]`` inverse RMS is fp32,
    the normalize and scale multiplies run in the input dtype.  Under
    autograd its backward is the reference's (``_RMSNorm``)."""
    if needs_grad(x, weight):
        return _RMSNorm.apply(x, weight, eps, offset)
    inv = _rms_stats(x, eps)[0]  # [..., 1], tiny
    w = (offset + weight.float()).to(x.dtype)
    return x * inv * w


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------
def _silu(x):
    return x * (1 / (1 + torch.exp(-x)))


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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference's CPU lowering computes it, every
    step in x's dtype; under autograd its backward is the reference's
    (``_SiLU``)."""
    return _SiLU.apply(x) if needs_grad(x) else _silu(x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """Rotary embedding tables: (sin, cos) of shape [..., dim/2], fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x: [..., S, H, D]; sin/cos: [..., S, D/2] broadcast over heads.  The
    two halves rotate (not interleaved pairs), in fp32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window / softcap)
# ---------------------------------------------------------------------------
def _softcap(scores: torch.Tensor, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (local attention)
    softcap: Optional[float] = None,
    q_chunk: int = 1024,
    q_offset: int = 0,  # absolute position of q[0] relative to k[0]
    scale: Optional[float] = None,
    kv_offset: int = 0,  # absolute position of k[0] (a sequence block)
    group=None,  # the ranks holding the other blocks of k and v
) -> torch.Tensor:
    """Chunked multi-head GQA attention.

    Queries go in chunks of ``q_chunk`` (then the remainder), so the fp32
    scores are at most ``[B, KV, G, q_chunk, T]``.  H must be a multiple
    of KV; heads are grouped.  The scale multiplies q in q's dtype; the
    scores are fp32 products of the bf16 operands.

    With ``group``, k and v are this rank's block of the keys, from
    position ``kv_offset`` (the reference's keys split over the sequence
    on the ``model`` axis): the softmax's max and sum are taken across
    the group, each rank's probabilities (bf16) meet its own values, and
    the partial outputs are summed across the group (bf16), as the
    reference's sharded softmax runs."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    groups = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scale = rounded(scale, q.dtype)
    q = q.reshape(b, s, kv, groups, d)
    kf = k.float()  # bf16 products are exact in fp32: fp32 accumulation
    kpos = kv_offset + torch.arange(t, device=q.device)

    def chunk_attn(qc: torch.Tensor, start: int) -> torch.Tensor:
        # qc: [B, C, KV, G, D]
        c = qc.shape[1]
        scores = torch.einsum("bckgd,btkd->bkgct", (qc * scale).float(), kf)
        scores = _softcap(scores, softcap)  # [B, KV, G, C, T] fp32
        qpos = start + q_offset + torch.arange(c, device=q.device)[:, None]
        mask = torch.ones((c, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        scores.masked_fill_(~mask, MASKED)
        if group is not None:
            return _split_softmax_pv(scores, v, group)
        probs = torch.softmax(scores, dim=-1)
        del scores
        return torch.einsum("bkgct,btkd->bckgd", probs.to(v.dtype), v)

    outs = [chunk_attn(q[:, lo:lo + q_chunk], lo)
            for lo in range(0, s, q_chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, s, h, dv)


def _split_softmax_pv(scores, v, group):
    """Softmax over keys split across ``group`` and the PV product: the
    row max and the sum of exponentials across the ranks, then each
    rank's bf16 probabilities times its values, summed across them."""
    from repro_torch.distributed.sharding import all_max, all_reduce

    top = all_max(scores.amax(-1, keepdim=True), group)
    e = torch.exp(scores - top)
    probs = e / all_reduce(e.sum(-1, keepdim=True), group)
    return all_reduce(torch.einsum("bkgct,btkd->bckgd", probs.to(v.dtype),
                                   v), group)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, T, KV, D]
    v_cache: torch.Tensor,  # [B, T, KV, D]
    cache_len: torch.Tensor,  # int 0-d tensor: valid prefix of the cache
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention against a (possibly padded) KV cache;
    q and k upcast to fp32.  ``cache_len`` stays on the device: no host
    sync."""
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    groups = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kv, groups, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float() * scale,
                          k_cache.float())
    scores = _softcap(scores, softcap)
    kpos = torch.arange(t, device=q.device)
    mask = kpos < cache_len
    if window is not None:
        mask &= kpos >= cache_len - window
    scores.masked_fill_(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# Dense helper
# ---------------------------------------------------------------------------
class Dense:
    """Tiny helper to declare a (kernel, optional bias) pair of ParamSpecs."""

    @staticmethod
    def spec(
        d_in: int,
        d_out: int,
        names: Tuple[str, str],
        *,
        bias: bool = False,
        dtype=torch.bfloat16,
        scale: Optional[float] = None,
    ) -> Dict[str, ParamSpec]:
        p = {"w": ParamSpec((d_in, d_out), names, dtype=dtype, scale=scale)}
        if bias:
            p["b"] = ParamSpec((d_out,), (names[1],), dtype=dtype, init="zeros")
        return p

    @staticmethod
    def apply(p, x: torch.Tensor) -> torch.Tensor:
        y = x @ p["w"]
        if "b" in p:
            y = y + p["b"]
        return y
