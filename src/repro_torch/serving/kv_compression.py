"""Legacy standalone KV-cache compression (deprecated shim).
Port of ``repro/serving/kv_compression.py``.

.. deprecated::
    Use :class:`repro_torch.serving.workloads.KVCacheCodec` instead.  The
    codec routes KV blocks through the batched engines' fixed-rate mode
    with *calibrated* domain tables (3-zone quantization, the K5/K3
    kernels on the card, plans cached per layer group) — this module's
    ad-hoc per-window max-abs quantizer predates the engine stack and
    survives only so existing callers keep working for one release.

Cold KV blocks are DCT-transformed along the *time* axis in windows of N
tokens and quantized to uint8; entropy coding is intentionally NOT applied
so cache blocks stay fixed-size for O(1) random access during decode.
Plain PyTorch on whatever device the block is on.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import torch

from repro_torch.core import dct

__all__ = ["KVCompressionConfig", "compress_kv_block", "decompress_kv_block"]


def _warn_deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.serving.kv_compression.{name} is deprecated; use "
        "repro_torch.serving.workloads.KVCacheCodec (calibrated tables + "
        "the batched engines' fixed-rate mode) instead",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclasses.dataclass(frozen=True)
class KVCompressionConfig:
    n: int = 16  # DCT window along the token axis
    e: int = 8  # retained coefficients
    # simple symmetric linear quantizer per (head, dim) channel — the KV
    # analog of the paper's zone-1; mu-law zone-0 adds little for KV because
    # the coefficient dynamic range per channel is narrow post-RMSNorm.

    @property
    def ratio(self) -> float:
        """Compressed bytes / raw bf16 bytes.

        Per channel, each N-token window stores E uint8 levels plus one f32
        scale against N bf16 samples: ``E/(2N) + 4/(2N)`` (the scale
        overhead is per *channel*, independent of head_dim).

        Prefer :attr:`repro_torch.serving.workloads.CompressedKV.ratio`,
        which is measured from the actual tensor bytes of a round trip.
        """
        return (self.e / self.n) * (1 / 2) + 4.0 / (self.n * 2)


def compress_kv_block(
    kv: torch.Tensor, cfg: KVCompressionConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv: [B, T, H, D] with T divisible by cfg.n.

    Returns ``(levels uint8 [B, W, H, D, E], scale f32 [B, W, H, D])``
    where ``W = T // N`` — one window of E levels and one scale per
    (batch, window, head, dim) channel.

    The uint8 mapping is symmetric: quantized values are clipped to
    [-127, 127] *before* the +128 bias, so level 128 is exactly 0.0 and
    every stored level decodes back into [-1, 1] of the window scale.

    .. deprecated:: use :class:`repro_torch.serving.workloads.KVCacheCodec`.
    """
    _warn_deprecated("compress_kv_block")
    b, t, h, d = kv.shape
    w = t // cfg.n
    x = kv.to(torch.float32).reshape(b, w, cfg.n, h, d)
    x = x.movedim(2, -1)  # [B, W, H, D, N]
    coeffs = x @ dct.dct_basis(cfg.n, cfg.e, device=kv.device)
    scale = coeffs.abs().amax(dim=-1, keepdim=True) + 1e-8
    q = (
        torch.clamp(torch.round(coeffs / scale * 127.0), -127, 127) + 128.0
    ).to(torch.uint8)
    return q, scale[..., 0]


def decompress_kv_block(
    levels: torch.Tensor, scale: torch.Tensor, cfg: KVCompressionConfig,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Inverse of :func:`compress_kv_block` -> [B, T, H, D].

    .. deprecated:: use :class:`repro_torch.serving.workloads.KVCacheCodec`.
    """
    _warn_deprecated("decompress_kv_block")
    b, w, h, d, e = levels.shape
    coeffs = (levels.to(torch.float32) - 128.0) / 127.0 * scale[..., None]
    x = coeffs @ dct.idct_basis(cfg.n, e, device=levels.device)
    x = x.movedim(-1, 2)  # [B, W, N, H, D]
    return x.reshape(b, w * cfg.n, h, d).to(dtype)
