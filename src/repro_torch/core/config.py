"""Codec configuration — the paper's Table 1 parameters.

Beyond Table 1, the config carries the **container-v3 coding stage**
(predictor + zero-plane suppression, ROADMAP item 3): an optional lossless
re-coding of the quantized levels before entropy coding.  ``predictor``/
``predict_bands``/``zero_planes`` default off, in which case the encoder
emits the classic v2 container byte for byte.

Port of ``repro/core/config.py`` (pure Python, unchanged).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["CodecConfig", "DOMAIN_DEFAULTS", "PREDICTORS"]

# predictor name -> wire id (container v3 flag bits; order is frozen)
PREDICTORS = {"none": 0, "delta": 1, "linear2": 2}


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """FPTC per-signal-domain parameters (paper Table 1).

    Attributes:
      n:  DCT_SIZE — transform block size, range [4, 128].
      e:  ENCODED_COEFFS — retained low-frequency coefficients, [1, N].
      b1: HYBRID_BOUNDARY_1 — low/mid zone boundary, [0, E].
      b2: HYBRID_BOUNDARY_2 — mid/high zone boundary, [B1, E].
      mu: MU_COMPANDING — companding strength, [1, 500].
      alpha1: DEAD_RATIO_ZONE1 — zone-1 deadzone ratio, [0, 1].
      a0_percentile: ZONE_PERCENTILE — clip percentile for zone maxima,
        [90, 100].
      l_max: maximum Huffman codeword length (LUT is 2**l_max entries; the
        paper bounds it so the table stays cache-resident).
      scale_headroom: multiplier on calibrated zone maxima — clipping guard
        for low-stationarity domains (paper tunes A0 per-domain by
        stationarity; this is the explicit knob).
      predictor: container-v3 window predictor on the low-frequency bands —
        "none" (v2 behaviour), "delta" (residual vs the previous window's
        level), or "linear2" (residual vs the 2*prev - prev2 linear
        extrapolation).  Lossless re-coding of the quantized levels: the
        reconstruction is bit-identical to v2 at the same quant table.
      predict_bands: how many leading coefficient bands [0, predict_bands)
        the predictor applies to (the DC/low-frequency bands, where
        adjacent windows correlate).  0 iff predictor == "none".
      zero_planes: container-v3 zero-plane suppression — all-zero-bin
        window rows and coefficient columns of the coded level grid are
        dropped from the symbol stream and recorded in header bitmaps.
    """

    n: int = 32
    e: int = 16
    b1: int = 2
    b2: int = 16
    mu: float = 50.0
    alpha1: float = 0.004
    a0_percentile: float = 99.9
    l_max: int = 12
    scale_headroom: float = 1.0
    predictor: str = "none"
    predict_bands: int = 0
    zero_planes: bool = False

    def __post_init__(self):
        if not (4 <= self.n <= 128):
            raise ValueError(f"N={self.n} outside [4, 128]")
        if not (1 <= self.e <= self.n):
            raise ValueError(f"E={self.e} outside [1, N={self.n}]")
        if not (0 <= self.b1 <= self.e):
            raise ValueError(f"B1={self.b1} outside [0, E={self.e}]")
        if not (self.b1 <= self.b2 <= self.e):
            raise ValueError(f"B2={self.b2} outside [B1={self.b1}, E={self.e}]")
        if not (1.0 <= self.mu <= 500.0):
            raise ValueError(f"mu={self.mu} outside [1, 500]")
        if not (0.0 <= self.alpha1 <= 1.0):
            raise ValueError(f"alpha1={self.alpha1} outside [0, 1]")
        if not (90.0 <= self.a0_percentile <= 100.0):
            raise ValueError(f"percentile={self.a0_percentile} outside [90,100]")
        if not (1 <= self.l_max <= 16):
            raise ValueError(f"l_max={self.l_max} outside [1, 16]")
        if self.predictor not in PREDICTORS:
            raise ValueError(
                f"predictor={self.predictor!r} not in {sorted(PREDICTORS)}"
            )
        if self.predictor == "none":
            if self.predict_bands != 0:
                raise ValueError(
                    "predict_bands must be 0 when predictor='none'"
                )
        elif not (1 <= self.predict_bands <= self.e):
            raise ValueError(
                f"predict_bands={self.predict_bands} outside [1, E={self.e}]"
            )

    @property
    def coding(self) -> Tuple[int, int, bool]:
        """The v3 coding triple ``(pred_id, predict_bands, zero_planes)``.

        ``(0, 0, False)`` means "no v3 stage" — the v2 wire format.  This
        triple is part of every plan key: plans with different codings trace
        different bucket math and must never share a cache entry.
        """
        return (
            PREDICTORS[self.predictor], self.predict_bands, self.zero_planes
        )

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


# Typical per-domain operating points (paper §3.4: typical values, tuned per
# domain smoothness / sampling rate).  These seed calibration; the RD
# benchmark sweeps around them exactly as the paper sweeps N and E.
#
# The last two are *device-resident workload* domains, not archival signal
# domains (their encoders wait for the encode slice of the port):
#   kv          — KV-cache timelines, windowed along the token axis per
#                 (head, dim) channel.  n == e (quantization-only) by
#                 default: spectral truncation only helps TRAINED models
#                 whose adjacent-token keys/values are smooth, and the
#                 fixed-rate cache path needs a predictable block size
#                 anyway.  Post-RMSNorm dynamic range is narrow, so a
#                 moderate mu + headroom covers outlier channels.
#   train_state — flattened parameter/optimizer/gradient shards.  Near-
#                 lossless operating point: full retention, heavy mu-law
#                 resolution, 100th-percentile scales (a clipped weight is
#                 a training bug, not a rate win).
DOMAIN_DEFAULTS = {
    "biomedical": CodecConfig(n=32, e=16, b1=4, b2=16, mu=50.0),
    "seismic": CodecConfig(
        n=32, e=32, b1=16, b2=32, mu=255.0, a0_percentile=99.99,
        scale_headroom=1.6,
    ),
    "power": CodecConfig(n=32, e=6, b1=2, b2=6, mu=50.0),
    "meteorological": CodecConfig(n=32, e=8, b1=2, b2=8, mu=50.0),
    "default": CodecConfig(),
    "kv": CodecConfig(
        n=16, e=16, b1=2, b2=16, mu=50.0, a0_percentile=99.9,
        scale_headroom=1.25,
    ),
    "train_state": CodecConfig(
        n=64, e=64, b1=64, b2=64, mu=255.0, a0_percentile=100.0,
        scale_headroom=1.05, l_max=12,
    ),
}
