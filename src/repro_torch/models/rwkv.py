"""RWKV-6 ("Finch"): attention-free stack with data-dependent decay.
Port of ``repro/models/rwkv.py``.

Time-mix recurrence per head (head size ``rwkv_head_size``):

    S_t = diag(w_t) . S_{t-1} + k_t^T v_t          (state [hd, hd])
    o_t = r_t . (S_{t-1} + diag(u) . k_t^T v_t)

with the data-dependent decay w_t = exp(-exp(w_base + tanh(x_t A) B)).
Token-shift lerps use static learned mixes (the reference collapses the
paper's DDLERP stack to its static term and keeps the decay LoRA); the
channel mix is the squared-ReLU RWKV FFN.

The arithmetic keeps the reference's dtype steps: the lerps and
projections in bf16, the decay in fp32 over a bf16 ``tanh`` LoRA, r in
bf16 up to the contraction, k, v and the state in fp32.  The recurrence
is the reference's ``lax.scan``, plain PyTorch in fp32: each chunk of
``SCAN_CHUNK`` steps forms its outer products ``k_t^T v_t`` and its bonus
terms ``(r_t . (u o k_t)) v_t`` at once, then takes one batched
``r_t S_{t-1}`` product and one fused multiply-add a step.  That is the
reference's sum in another fp32 order.  While autograd records and S is a
multiple of ``SCAN_CHUNK`` above it (the reference's rule,
``ssm.chunk_remat``), each chunk's outer products, bonus and steps run
under activation checkpointing, as the reference's chunk-of-128
``jax.checkpoint`` does: the backward keeps only the chunks' boundary
states.  Decode is the same layer on one token from the carried
``(shift1, shift2, wkv)``.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import ssm
from repro_torch.models.common import ParamSpec, Params, rms_norm, silu
from repro_torch.models.config import ArchConfig

__all__ = ["rwkv_heads", "rwkv_layer_specs", "rwkv_layer_train",
           "rwkv_layer_decode", "RWKVLayer"]

_DECAY_LORA = 64
# steps whose outer products and bonus are formed at once
SCAN_CHUNK = ssm.SCAN_CHUNK

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def rwkv_heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_size
    return cfg.d_model // hd, hd


def rwkv_layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    h, hd = rwkv_heads(cfg)
    ff = cfg.d_ff
    dt = torch.bfloat16

    def vec(init="zeros", dtype=dt):
        return ParamSpec((d,), (None,), dtype=dtype, init=init)

    def mat(rows, cols, names):
        return ParamSpec((rows, cols), names, dtype=dt)

    return {
        "ln1": vec("ones"),
        "ln2": vec("ones"),
        "tm": {  # time mix
            "mix_r": vec(), "mix_k": vec(), "mix_v": vec(), "mix_g": vec(),
            "mix_w": vec(),
            "wr": mat(d, d, ("hidden", "heads")),
            "wk": mat(d, d, ("hidden", "heads")),
            "wv": mat(d, d, ("hidden", "heads")),
            "wg": mat(d, d, ("hidden", "heads")),
            "w_base": vec(dtype=torch.float32),
            "wA": mat(d, _DECAY_LORA, ("hidden", "rank")),
            "wB": mat(_DECAY_LORA, d, ("rank", "hidden")),
            "u": ParamSpec((h, hd), (None, None), dtype=torch.float32,
                           init="zeros"),
            "gn": vec("ones"),
            "wo": mat(d, d, ("heads", "hidden")),
        },
        "cm": {  # channel mix
            "mix_k": vec(), "mix_r": vec(),
            "wk": mat(d, ff, ("hidden", "ffn")),
            "wv": mat(ff, d, ("ffn", "hidden")),
            "wr": mat(d, d, ("hidden", "hidden")),
        },
    }


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference's CPU lowering computes it,
    every step in x's dtype (as ``common.silu``)."""
    return 1 / (1 + torch.exp(-x))


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Shifted-by-one sequence: [prev, x_0, ..., x_{S-2}]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerps(x, xs, mixes):
    """``x + (xs - x) * sigmoid(mix)`` for every mix at once, each step in
    bf16 as the reference's lerps: ``[len(mixes), B, S, d]``."""
    return x + (xs - x) * _sigmoid(torch.stack(mixes))[:, None, None, :]


def _decay(tm, xw):
    """Data-dependent per-channel decay in (0, 1), fp32 ``[B, S, d]``."""
    lora = torch.tanh(xw @ tm["wA"]) @ tm["wB"]
    return torch.exp(-torch.exp(tm["w_base"] + lora.float()))


def _time_mix_inputs(tm, x, prev_x):
    xr, xk, xv, xg, xw = _lerps(x, _token_shift(x, prev_x), [
        tm[f"mix_{c}"] for c in "rkvgw"])
    return (xr @ tm["wr"], xk @ tm["wk"], xv @ tm["wv"], xg @ tm["wg"],
            _decay(tm, xw))


def _wkv_chunk(r, k, v, w, u, state):
    """One chunk of the recurrence, step-major ``[c, B, h, hd]`` inputs:
    returns (o ``[c, B, h, hd]``, the state after it)."""
    kv = k[..., None] * v[..., None, :]  # [c, B, h, hd, hd]
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    os = []
    # steps as unbind's views, as in ``ssm._scan_chunk``
    for row, kv_t, decay in zip(r[..., None, :].unbind(0), kv.unbind(0),
                                w[..., None].unbind(0)):
        os.append(row @ state)  # r_t S_{t-1}: [B, h, 1, hd]
        state = torch.addcmul(kv_t, decay, state)
    return torch.stack(os)[..., 0, :] + bonus, state


def _wkv(r, k, v, w, u, state: torch.Tensor):
    """The recurrence over S: r bf16, k, v, w fp32, each ``[B, S, h, hd]``;
    u fp32 ``[h, hd]``; ``state`` fp32 ``[B, h, hd, hd]`` before step 0.
    Returns (o fp32 ``[B, S, h, hd]``, the state after step S-1).  Each
    chunk runs under ``checkpoint`` when ``ssm.chunk_remat(S)``."""
    s = k.shape[1]
    # step-major, so that each step's slice is contiguous
    r, k, v, w = (t.transpose(0, 1).contiguous() for t in (r.float(), k, v,
                                                           w))
    run = (partial(checkpoint, _wkv_chunk, use_reentrant=False)
           if ssm.chunk_remat(s) else _wkv_chunk)
    outs = []
    for lo in range(0, s, SCAN_CHUNK):
        part = [t[lo:lo + SCAN_CHUNK] for t in (r, k, v, w)]
        o, state = run(*part, u, state)
        outs.append(o)
    o = torch.cat(outs) if len(outs) > 1 else outs[0]
    return o.transpose(0, 1), state


def rwkv_layer_train(cfg: ArchConfig, p, x: torch.Tensor,
                     state: Optional[State] = None):
    """x: [B, S, d].  state: optional (shift1, shift2, wkv) to carry on
    from; returns (x_out, (shift1, shift2, wkv) after the S tokens)."""
    b, s, d = x.shape
    h, hd = rwkv_heads(cfg)
    if state is None:
        shift1 = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        shift2 = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        wkv0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                           device=x.device)
    else:
        shift1, shift2, wkv0 = state

    # ---- time mix ----
    tm = p["tm"]
    xn = rms_norm(x, p["ln1"])
    r, k, v, g, w = _time_mix_inputs(tm, xn, shift1)
    heads = (b, s, h, hd)
    o, wkv = _wkv(r.reshape(heads), k.reshape(heads).float(),
                  v.reshape(heads).float(), w.reshape(heads), tm["u"], wkv0)
    o = rms_norm(o.reshape(b, s, d).to(x.dtype), tm["gn"]) * silu(g)
    x = x + o @ tm["wo"]

    # ---- channel mix ----
    cm = p["cm"]
    xn2 = rms_norm(x, p["ln2"])
    xk, xr = _lerps(xn2, _token_shift(xn2, shift2),
                    [cm["mix_k"], cm["mix_r"]])
    kc = torch.relu(xk @ cm["wk"])
    rc = _sigmoid(xr @ cm["wr"])
    x = x + rc * ((kc * kc) @ cm["wv"])
    return x, (xn[:, -1, :], xn2[:, -1, :], wkv)


def rwkv_layer_decode(cfg: ArchConfig, p, x: torch.Tensor, state: State):
    """Single-token step: x [B, 1, d]; state (shift1 [B, d], shift2, wkv)."""
    return rwkv_layer_train(cfg, p, x, state)


class RWKVLayer(Params):
    """One RWKV layer's weights (``rwkv_layer_specs``)."""

    kind = "rwkv"

    def __init__(self, cfg: ArchConfig, device):
        super().__init__(rwkv_layer_specs(cfg), device)
        self.cfg = cfg

    def forward(self, x, state: Optional[State] = None):
        return rwkv_layer_train(self.cfg, self, x, state)
