"""Mamba-style selective SSM block: the SSM half of hymba's hybrid heads.
Port of ``repro/models/ssm.py``.

Standard Mamba-1 formulation: input gating, short causal conv, selective
(input-dependent) dt/B/C, diagonal state recurrence:

    h_t = exp(dt_t * A) . h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The recurrence runs in fp32, one step at a time as the reference's
``lax.scan`` does; the state is ``[B, d_inner, N]`` (N = ``ssm_state``).
Each chunk of ``SCAN_CHUNK`` steps forms its decays and inputs at once,
then takes one fused multiply-add a step.  While autograd records and S is
a multiple of ``SCAN_CHUNK`` above it (the reference's rule), each chunk
runs under activation checkpointing, as the reference's chunk-of-128
``jax.checkpoint`` does: the backward keeps only the chunks' boundary
states and recomputes a chunk's steps.  Decode is a single step on the
carried ``(conv_state, ssm_state)``.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamSpec, silu
from repro_torch.models.config import ArchConfig

__all__ = ["mamba_specs", "mamba_apply_train", "mamba_prefill_state",
           "mamba_apply_decode"]

SCAN_CHUNK = 128  # steps whose decays and inputs are formed at once


def chunk_remat(s: int) -> bool:
    """Whether a scan over ``s`` steps checkpoints each chunk: while
    autograd records, under the reference's rule."""
    return (torch.is_grad_enabled() and s % SCAN_CHUNK == 0
            and s > SCAN_CHUNK)


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return d_in, dt_rank, cfg.ssm_state, cfg.ssm_conv


def mamba_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, dt_rank, n, k = _dims(cfg)
    dt = torch.bfloat16
    return {
        "w_in": ParamSpec((d, 2 * d_in), ("hidden", "ffn"), dtype=dt),
        "conv_w": ParamSpec((k, d_in), ("conv", "ffn"), dtype=dt),
        "conv_b": ParamSpec((d_in,), ("ffn",), dtype=dt, init="zeros"),
        "w_x": ParamSpec((d_in, dt_rank + 2 * n), ("ffn", None), dtype=dt),
        "w_dt": ParamSpec((dt_rank, d_in), (None, "ffn"), dtype=dt),
        "dt_bias": ParamSpec((d_in,), ("ffn",), dtype=torch.float32,
                             init="zeros"),
        "A_log": ParamSpec((d_in, n), ("ffn", "state"), dtype=torch.float32,
                           init="zeros"),
        "D": ParamSpec((d_in,), ("ffn",), dtype=torch.float32, init="ones"),
        "w_out": ParamSpec((d_in, d), ("ffn", "hidden"), dtype=dt),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, no threshold."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(cfg: ArchConfig, p, x_conv):
    """x_conv: [B, S, d_in] post-conv activations -> (dt, B, C), fp32."""
    _, dt_rank, n, _ = _dims(cfg)
    xproj = x_conv @ p["w_x"]  # [B, S, dt_rank + 2n]
    dt_low = xproj[..., :dt_rank]
    b_mat = xproj[..., dt_rank:dt_rank + n].float()
    c_mat = xproj[..., dt_rank + n:].float()
    dt = _softplus((dt_low @ p["w_dt"]).float() + p["dt_bias"])
    return dt, b_mat, c_mat


def _causal_conv(p, x, k: int):
    """Depthwise causal conv along time: x [B, S, d_in].  The taps are
    summed in bf16 from tap 0 up, each product rounded, as the
    reference's Python ``sum`` does."""
    s = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    w = p["conv_w"]
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + p["conv_b"]


def _scan_chunk(xs, dt, b_mat, c_mat, a_mat, h):
    """One chunk of the recurrence: returns (y [B, c, d_in], h after it)."""
    decay = torch.exp(dt[..., None] * a_mat)  # [B, c, d_in, n]
    u = (dt * xs.float())[..., None] * b_mat[:, :, None, :]
    hs = []
    # steps as unbind's views: the backward stacks their gradients once,
    # where an index a step would add a zeroed chunk a step
    for u_t, decay_t in zip(u.unbind(1), decay.unbind(1)):
        h = torch.addcmul(u_t, decay_t, h)  # decay . h + u
        hs.append(h)
    return (torch.stack(hs, 1) * c_mat[:, :, None, :]).sum(-1), h


def _scan(xs, dt, b_mat, c_mat, a_mat, h: Optional[torch.Tensor] = None):
    """The recurrence over S, fp32: returns (y [B, S, d_in], h_S).  ``h``
    is the state before step 0 (zeros when None).  Each chunk runs under
    ``checkpoint`` when ``chunk_remat(S)``."""
    bsz, s, d_in = xs.shape
    n = a_mat.shape[1]
    if h is None:
        h = torch.zeros((bsz, d_in, n), dtype=torch.float32,
                        device=xs.device)
    run = (partial(checkpoint, _scan_chunk, use_reentrant=False)
           if chunk_remat(s) else _scan_chunk)
    ys = []
    for lo in range(0, s, SCAN_CHUNK):
        part = [t[:, lo:lo + SCAN_CHUNK] for t in (xs, dt, b_mat, c_mat)]
        y, h = run(*part, a_mat, h)
        ys.append(y)
    return torch.cat(ys, 1) if len(ys) > 1 else ys[0], h


def _output(p, xs, y, z, dtype):
    y = y + xs.float() * p["D"]
    return (y.to(dtype) * silu(z)) @ p["w_out"]


def mamba_prefill_state(cfg: ArchConfig, p, x: torch.Tensor):
    """Run the train path and return the final (conv_state, ssm_state) for
    decode: (out [B, S, d], the last k-1 pre-conv activations, h_S)."""
    d_in, _, _, k = _dims(cfg)
    xs_pre, z = (x @ p["w_in"]).split(d_in, dim=-1)
    conv_state = xs_pre[:, -(k - 1):]
    xs = silu(_causal_conv(p, xs_pre, k))
    dt, b_mat, c_mat = _ssm_inputs(cfg, p, xs)
    y, h = _scan(xs, dt, b_mat, c_mat, -torch.exp(p["A_log"]))
    return _output(p, xs, y, z, x.dtype), conv_state, h


def mamba_apply_train(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]; recurrence scanned over S."""
    return mamba_prefill_state(cfg, p, x)[0]


def _decode_conv(p, window):
    """The conv's output at the window's last step, ``[B, d_in]``: the
    reference's ``einsum("bkd,kd->bd")``, fp32 products summed and
    rounded once (``_causal_conv`` rounds each tap: R11)."""
    conv = (window.float() * p["conv_w"].float()).sum(1).to(window.dtype)
    return conv + p["conv_b"]


def mamba_apply_decode(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,  # [B, 1, d]
    conv_state: torch.Tensor,  # [B, k-1, d_in] rolling pre-conv window
    ssm_state: torch.Tensor,  # [B, d_in, n] fp32
):
    """One step: returns (out [B, 1, d], new conv_state, new ssm_state)."""
    d_in, _, _, k = _dims(cfg)
    xs_new, z = (x @ p["w_in"]).split(d_in, dim=-1)  # [B, 1, d_in]
    window = torch.cat([conv_state, xs_new], dim=1)  # [B, k, d_in]
    xs = silu(_decode_conv(p, window)[:, None, :])
    dt, b_mat, c_mat = _ssm_inputs(cfg, p, xs)
    y, h = _scan(xs, dt, b_mat, c_mat, -torch.exp(p["A_log"]), ssm_state)
    return _output(p, xs, y, z, x.dtype), window[:, 1:], h
