"""Evaluation metrics (paper §5.1, Eqs. 4-5).

Port of ``repro/core/metrics.py`` (numpy only, copied so the port imports
nothing of the reference package).
"""
from __future__ import annotations

import numpy as np

__all__ = ["prd", "compression_ratio", "nrmse", "snr_db"]


def prd(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Percentage root-mean-square difference (Eq. 5)."""
    x = np.asarray(original, dtype=np.float64).ravel()
    xh = np.asarray(reconstructed, dtype=np.float64).ravel()
    if x.shape != xh.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {xh.shape}")
    denom = np.sum(x * x)
    if denom == 0:
        return 0.0 if np.allclose(x, xh) else float("inf")
    return float(100.0 * np.sqrt(np.sum((x - xh) ** 2) / denom))


def compression_ratio(original_bytes: int, compressed_bytes: int) -> float:
    """CR = S_orig / S_comp (Eq. 4)."""
    return original_bytes / max(compressed_bytes, 1)


def nrmse(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Normalized RMSE (range-normalized) — seismic literature metric."""
    x = np.asarray(original, dtype=np.float64).ravel()
    xh = np.asarray(reconstructed, dtype=np.float64).ravel()
    rng = x.max() - x.min()
    if rng == 0:
        return 0.0 if np.allclose(x, xh) else float("inf")
    return float(np.sqrt(np.mean((x - xh) ** 2)) / rng)


def snr_db(original: np.ndarray, reconstructed: np.ndarray) -> float:
    x = np.asarray(original, dtype=np.float64).ravel()
    e = x - np.asarray(reconstructed, dtype=np.float64).ravel()
    pe = np.sum(e * e)
    if pe == 0:
        return float("inf")
    return float(10.0 * np.log10(np.sum(x * x) / pe))
