"""Offline per-domain calibration (paper §3.4, Fig. 4), and the tables the
decoders consume.  Port of ``repro/core/calibration.py``.

From representative domain data, precompute the two deployed structures:
  1. the quantization table (per-bin zone + clipped-percentile scales), and
  2. the length-limited canonical Huffman codebook.

Laplace (+1) smoothing of the symbol histogram gives *every* uint8 symbol a
codeword.  :func:`tables_from_arrays` rebuilds the same structures from
plain numbers — the state another implementation (the JAX package) can hand
across: config fields, quant table, and the 256 code lengths.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import dct
from repro_torch.core.config import CodecConfig
from repro_torch.core.huffman import (
    HuffmanCodebook,
    build_codebook,
    codebook_from_lengths,
)
from repro_torch.core.quantize import (
    QuantTable,
    build_quant_table,
    predict_levels,
    quant_table_from_arrays,
    quantize,
)

__all__ = [
    "DomainTables",
    "DeviceTables",
    "calibrate",
    "tables_from_hist",
    "tables_from_arrays",
]


_DEVICE_TABLES_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Huffman encode/decode tables + quantization table on one device.

    The decode tables hold values below 2**17, so they are int32 whatever
    their unsigned type in the reference (``codes`` keeps int64 for the
    full uint32 codeword range)."""

    codes: torch.Tensor  # int64[256] (uint32 codewords)
    lengths: torch.Tensor  # int32[256]
    dec_limit: torch.Tensor  # int32[L_max]
    dec_first: torch.Tensor  # int32[L_max + 1]
    dec_rank: torch.Tensor  # int32[L_max + 1]
    dec_syms: torch.Tensor  # int32[256]
    quant: QuantTable


@dataclasses.dataclass(frozen=True)
class DomainTables:
    """Host-side calibrated structures for one signal domain."""

    config: CodecConfig
    quant: QuantTable  # host (CPU) tensors
    book: HuffmanCodebook
    domain_id: int = 0
    hist: Optional[np.ndarray] = None  # smoothed symbol histogram

    def device_tables(self, device="cpu") -> DeviceTables:
        """The tables on ``device``, built once per (instance, device).

        Every decode of this domain on that device reuses the same tensors,
        so the plan cache and repeated decodes pay no re-upload.
        """
        key = str(torch.device(device))
        with _DEVICE_TABLES_LOCK:
            cache = self.__dict__.get("_device_cache")
            if cache is None:
                cache = {}
                object.__setattr__(self, "_device_cache", cache)
            cached = cache.get(key)
            if cached is None:
                b = self.book

                def put(a, dtype):
                    return torch.as_tensor(
                        np.asarray(a).astype(np.int64), dtype=dtype,
                        device=device,
                    )

                cached = cache[key] = DeviceTables(
                    codes=put(b.codes, torch.int64),
                    lengths=put(b.lengths, torch.int32),
                    dec_limit=put(b.limit_shifted[1:], torch.int32),
                    dec_first=put(b.first_code_shifted, torch.int32),
                    dec_rank=put(b.rank_offset, torch.int32),
                    dec_syms=put(b.sorted_symbols, torch.int32),
                    quant=self.quant.to(device),
                )
        return cached


def calibrate(
    signal: np.ndarray,
    config: CodecConfig,
    *,
    domain_id: int = 0,
    max_windows: Optional[int] = 65536,
    seed: int = 0,
    scale_floor: Optional[np.ndarray] = None,
) -> DomainTables:
    """Calibrate quantization table + Huffman codebook on representative
    data (host, CPU tensors).

    Args:
      signal: 1-D representative signal strip (float).
      config: codec parameters (Table 1).
      max_windows: subsample cap for calibration windows (randomly sampled,
        kept in signal order so v3 residual histograms stay faithful).
      seed: subsampling RNG seed.
      scale_floor: per-bin lower bounds on the scales (``[E]``), for a
        caller that knows coefficients the strip does not hold; the
        histogram is taken under the raised scales.
    """
    signal = np.asarray(signal, dtype=np.float32).ravel()
    windows = dct.window_signal(torch.from_numpy(signal.copy()), config.n)
    if max_windows is not None and windows.shape[0] > max_windows:
        rng = np.random.default_rng(seed)
        idx = rng.choice(windows.shape[0], size=max_windows, replace=False)
        idx.sort()
        windows = windows[torch.from_numpy(idx)]
    coeffs = dct.forward_dct(windows, config.e)

    quant = build_quant_table(
        coeffs.numpy(),
        b1=config.b1,
        b2=config.b2,
        mu=config.mu,
        alpha1=config.alpha1,
        percentile=config.a0_percentile,
        scale_headroom=config.scale_headroom,
    )
    if scale_floor is not None:
        scale = np.maximum(quant.scale.numpy(), np.asarray(scale_floor))
        quant = quant_table_from_arrays(_zones(config, config.e), scale,
                                        config.mu, config.alpha1)
    levels = quantize(coeffs, quant)
    pred_id, bands, zplanes = config.coding
    # v3 configs entropy-code the TRANSFORMED symbols (prediction residuals,
    # minus suppressed zero planes), so that is what the book is built on
    grid = predict_levels(levels, pred_id, bands).numpy()
    if zplanes:
        from repro_torch.core.symlen import zero_plane_masks

        zrow, zcol = zero_plane_masks(grid)
        symbols = grid[~zrow, :][:, ~zcol].ravel()
    else:
        symbols = grid.ravel()
    hist = np.bincount(symbols, minlength=256).astype(np.int64)
    hist += 1  # Laplace smoothing: every symbol must be encodable
    book = build_codebook(hist, l_max=config.l_max)
    return DomainTables(
        config=config, quant=quant, book=book, domain_id=domain_id, hist=hist
    )


def _zones(config: CodecConfig, e: int) -> np.ndarray:
    zone = np.full((e,), 2, dtype=np.int32)
    zone[: config.b2] = 1
    zone[: config.b1] = 0
    return zone


def tables_from_hist(
    config: CodecConfig,
    scale: np.ndarray,
    hist: np.ndarray,
    *,
    domain_id: int = 0,
) -> DomainTables:
    """Rebuild DomainTables from serialized (scale, hist)."""
    scale = np.asarray(scale)
    quant = quant_table_from_arrays(
        _zones(config, scale.shape[0]), scale, config.mu, config.alpha1
    )
    book = build_codebook(np.asarray(hist, dtype=np.int64), l_max=config.l_max)
    return DomainTables(
        config=config, quant=quant, book=book, domain_id=domain_id,
        hist=np.asarray(hist),
    )


def tables_from_arrays(
    config: Mapping,
    domain_id: int,
    *,
    zone,
    scale,
    mu: float,
    alpha1: float,
    lengths,
) -> DomainTables:
    """DomainTables from plain numbers: the state carried across from
    another implementation of the codec.

    ``config`` holds the :class:`CodecConfig` fields by name; the quant
    table is given whole (``zone``, ``scale``, ``mu``, ``alpha1``); the
    codebook is rebuilt canonically from its 256 code ``lengths``, which
    fix every codeword and decode table.
    """
    cfg = CodecConfig(**dict(config))
    quant = quant_table_from_arrays(zone, scale, mu, alpha1)
    if quant.num_coeffs != cfg.e:
        raise ValueError(
            f"quant table has {quant.num_coeffs} bins, config says E={cfg.e}"
        )
    book = codebook_from_lengths(np.asarray(lengths), cfg.l_max)
    return DomainTables(config=cfg, quant=quant, book=book, domain_id=domain_id)
