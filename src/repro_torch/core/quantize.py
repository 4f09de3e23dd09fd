"""Hybrid three-zone quantization (paper §3.2, Eqs. 2-3), in torch.

Port of ``repro/core/quantize.py``.  The E retained DCT coefficient indices
are partitioned into three contiguous zones by boundaries B1, B2:

  zone 0  [0,  B1): mu-law companding — positive -> 129..255, negative ->
                    0..127, zero -> 128.
  zone 1  [B1, B2): symmetric linear quantizer with a deadzone of width
                    d1 = alpha1 * A1 around zero.
  zone 2  [B2, E ): aggressive zeroing — every coefficient maps to bin 128.

:class:`QuantTable` is a frozen dataclass of tensors in place of the
reference's pytree.  All float math is float32, as in the reference.

The container-v3 predictor runs in uint32 arithmetic mod 256 in the
reference; torch has almost no uint32 arithmetic on the CPU, so this module
holds uint32 values in int64 tensors and masks with ``0xFFFFFFFF`` after
every step that could leave the range — the same values, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "QuantTable",
    "build_quant_table",
    "quantize",
    "dequantize",
    "predict_levels",
    "unpredict_levels",
    "expand_coded_stream",
    "quant_grid",
]

_ZERO_BIN = 128.0
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class QuantTable:
    """Table-driven 3-zone quantizer parameters for one signal domain.

    Attributes:
      zone:  int32[E]  — zone id per retained coefficient index (0/1/2).
      scale: float32[E] — per-bin clipped-percentile maximum (A0 / A1).
      mu:    float32[] — companding strength (zone 0).
      alpha1: float32[] — deadzone ratio (zone 1).
    """

    zone: torch.Tensor
    scale: torch.Tensor
    mu: torch.Tensor
    alpha1: torch.Tensor

    @property
    def num_coeffs(self) -> int:
        return self.zone.shape[0]

    def to(self, device) -> "QuantTable":
        return QuantTable(*(t.to(device) for t in dataclasses.astuple(self)))


def quant_table_from_arrays(zone, scale, mu, alpha1) -> QuantTable:
    """A host :class:`QuantTable` from plain numbers/arrays."""
    return QuantTable(
        zone=torch.tensor(np.asarray(zone), dtype=torch.int32),
        scale=torch.tensor(np.asarray(scale), dtype=torch.float32),
        mu=torch.tensor(float(mu), dtype=torch.float32),
        alpha1=torch.tensor(float(alpha1), dtype=torch.float32),
    )


def build_quant_table(
    calib_coeffs: np.ndarray,
    *,
    b1: int,
    b2: int,
    mu: float,
    alpha1: float,
    percentile: float,
    scale_headroom: float = 1.0,
) -> QuantTable:
    """Build a :class:`QuantTable` from calibration coefficients [W, E].

    The per-bin scale is the ``percentile`` of |coeff| over calibration
    windows (paper: "clipped percentile").
    """
    calib_coeffs = np.asarray(calib_coeffs, dtype=np.float64)
    if calib_coeffs.ndim != 2:
        calib_coeffs = calib_coeffs.reshape(-1, calib_coeffs.shape[-1])
    e = calib_coeffs.shape[-1]
    if not (0 <= b1 <= b2 <= e):
        raise ValueError(f"need 0 <= B1({b1}) <= B2({b2}) <= E({e})")
    scale = np.percentile(np.abs(calib_coeffs), percentile, axis=0)
    # headroom guards against clipping on non-stationary domains
    scale = np.maximum(scale * scale_headroom, 1e-12)
    zone = np.full((e,), 2, dtype=np.int32)
    zone[:b2] = 1
    zone[:b1] = 0
    return quant_table_from_arrays(zone, scale, mu, alpha1)


def _mulaw_compress(c_abs, a0, mu):
    """Eq. 2: q = ln(1 + mu*|c|/A0) / ln(1 + mu), |c| clipped to A0."""
    x = torch.clamp(c_abs / a0, max=1.0)
    return torch.log1p(mu * x) / torch.log1p(mu)


def _mulaw_expand(q, a0, mu):
    return a0 * (torch.expm1(q * torch.log1p(mu)) / mu)


def quantize(coeffs: torch.Tensor, table: QuantTable) -> torch.Tensor:
    """Map float coefficients [..., E] to uint8 levels via the 3-zone table."""
    c = coeffs.to(torch.float32)
    a = table.scale
    mu = table.mu
    sign_pos = c > 0

    # --- zone 0: mu-law companding -------------------------------------
    q01 = _mulaw_compress(torch.abs(c), a, mu)
    lvl0 = torch.where(
        sign_pos,
        129.0 + torch.round(q01 * 126.0),
        127.0 - torch.round(q01 * 127.0),
    )
    lvl0 = torch.where(c == 0, _ZERO_BIN, lvl0)  # exact zeros: zero bin

    # --- zone 1: linear deadzone (Eq. 3) --------------------------------
    d1 = table.alpha1 * a
    denom = torch.clamp(a - d1, min=1e-12)
    c_clip = torch.maximum(torch.minimum(c, a), -a)
    mag = torch.abs(c_clip)
    lvl1_pos = 129.0 + torch.floor((c_clip - d1) / denom * 126.0 + 0.5)
    lvl1_neg = 127.0 - torch.floor((mag - d1) / denom * 127.0 + 0.5)
    lvl1 = torch.where(
        c_clip > d1,
        lvl1_pos,
        torch.where(c_clip < -d1, lvl1_neg, _ZERO_BIN),
    )

    # --- zone 2: aggressive zeroing -------------------------------------
    lvl = torch.where(
        table.zone == 0,
        lvl0,
        torch.where(table.zone == 1, lvl1, _ZERO_BIN),
    )
    return torch.clamp(lvl, 0.0, 255.0).to(torch.uint8)


def dequantize(levels: torch.Tensor, table: QuantTable) -> torch.Tensor:
    """Inverse 3-zone mapping: uint8 levels [..., E] -> float32 coefficients.

    Uses the midpoint reconstruction of each quantization cell.
    """
    lvl = levels.to(torch.float32)
    a = table.scale
    mu = table.mu
    pos = lvl > _ZERO_BIN
    neg = lvl < _ZERO_BIN

    # zone 0 inverse mu-law
    q01 = torch.where(pos, (lvl - 129.0) / 126.0, (127.0 - lvl) / 127.0)
    mag0 = _mulaw_expand(torch.clamp(q01, 0.0, 1.0), a, mu)
    c0 = torch.where(pos, mag0, -mag0)
    c0 = torch.where(lvl == _ZERO_BIN, 0.0, c0)

    # zone 1 inverse linear deadzone
    d1 = table.alpha1 * a
    span = a - d1
    mag1 = torch.where(
        pos,
        d1 + (lvl - 129.0) / 126.0 * span,
        d1 + (127.0 - lvl) / 127.0 * span,
    )
    c1 = torch.where(pos, mag1, torch.where(neg, -mag1, 0.0))

    return torch.where(
        table.zone == 0, c0, torch.where(table.zone == 1, c1, 0.0)
    )


# ---------------------------------------------------------------------------
# Container-v3 window prediction: a lossless re-coding of the quantized
# levels before entropy coding.  For bands k < predict_bands the coded
# symbol is the mod-256 residual of the level against the previous
# window(s), with a virtual all-128 history before each signal's first
# window.  The reference computes in uint32 (256 divides 2**32, so the wrap
# never changes a value mod 256); these functions hold the same uint32
# values in int64 tensors.
# ---------------------------------------------------------------------------
def predict_levels(
    levels: torch.Tensor, pred_id: int, predict_bands: int
) -> torch.Tensor:
    """Forward prediction: uint8 levels ``[..., W, E]`` -> coded grid."""
    if pred_id == 0 or predict_bands == 0:
        return levels
    lv = levels.to(torch.int64)
    zero = torch.full_like(lv[..., :1, :], 128)
    l1 = torch.cat([zero, lv[..., :-1, :]], dim=-2)  # prev window
    if pred_id == 1:
        pred = l1
    else:
        l2 = torch.cat([zero, l1[..., :-1, :]], dim=-2)  # prev-prev
        pred = 2 * l1 - l2
    r = torch.remainder(lv - pred + 128, 256)
    band = torch.arange(levels.shape[-1], device=levels.device) < predict_bands
    return torch.where(band, r, lv).to(torch.uint8)


def _seg_cumsum(t: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive cumsum along axis 0 of ``t`` [W, E] (uint32
    values in int64): a plain cumsum minus a gather of the exclusive cumsum
    at each window's segment start, wrapped to 32 bits like the reference."""
    a = torch.cumsum(t, dim=0) & _U32  # inclusive
    excl = (a - t) & _U32  # exclusive
    return (a - excl[seg_start.long(), :]) & _U32


def unpredict_levels(
    grid: torch.Tensor,
    seg_start: torch.Tensor,
    pred_id: int,
    predict_bands: int,
) -> torch.Tensor:
    """Inverse prediction: coded grid ``[W, E]`` -> uint8 levels.

    ``seg_start[w]`` is the first window of w's signal, so predictions never
    cross a signal boundary.  The delta inverse is one segmented cumsum of
    ``t = (r - 128) mod 256``; linear2 telescopes to a double segmented
    cumsum.
    """
    if pred_id == 0 or predict_bands == 0:
        return grid.to(torch.uint8)
    g = grid.to(torch.int64)
    t = torch.remainder(g + 128, 256)  # (r - 128) mod 256
    cs = _seg_cumsum(t, seg_start)
    if pred_id == 2:
        cs = _seg_cumsum(cs, seg_start)
    lvl = torch.remainder(cs + 128, 256)
    band = torch.arange(grid.shape[-1], device=grid.device) < predict_bands
    return torch.where(band, lvl, g).to(torch.uint8)


def expand_coded_stream(dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Zero-plane expansion: dense coded symbols -> flat residual grid.

    ``idx[p]`` is the position of flat grid cell ``p`` in the dense coded
    stream, or ``-1`` where the cell was suppressed (zero-plane) or is
    bucket padding — those cells expand to the zero bin 128.
    """
    took = dense[torch.clamp(idx.long(), min=0)]
    return torch.where(idx >= 0, took, torch.full_like(took, 128))


def quant_grid(table: QuantTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 256 reconstruction values per bin: ([E, 256] f32, levels u8[256]).

    The dequantization table materialized: decode selects from it instead
    of evaluating transcendentals per symbol.
    """
    levels = torch.arange(256, dtype=torch.uint8, device=table.scale.device)
    e = table.num_coeffs
    grid = dequantize(levels[:, None].expand(256, e), table)  # [256, E]
    return grid.T.contiguous(), levels
