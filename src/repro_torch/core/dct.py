"""Windowed DCT-II forward / DCT-III inverse transforms (paper §3.1, Eq. 1).

The paper's transform for a window of N samples:

    C[k] = (2/N) * sum_n x[n] * cos(pi/N * (n + 1/2) * k),   k = 0..N-1

with inverse

    x[n] = C[0]/2 + sum_{k>=1} C[k] * cos(pi/N * (n + 1/2) * k).

Both directions are products against a precomputed basis.  The bases are
built in float64 numpy (cached per (N, E)) and cast to the caller's dtype
and device, as in ``repro/core/dct.py``, of which this module is the port.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "dct_basis",
    "idct_basis",
    "forward_dct",
    "inverse_dct",
    "window_signal",
    "unwindow_signal",
]


@functools.lru_cache(maxsize=64)
def _dct_basis_np(n: int, e: int) -> np.ndarray:
    """Forward DCT-II basis, shape [N, E]: C = x @ basis."""
    if not (1 <= e <= n):
        raise ValueError(f"retained coeffs E={e} must satisfy 1 <= E <= N={n}")
    samples = np.arange(n, dtype=np.float64)[:, None]  # n index
    freqs = np.arange(e, dtype=np.float64)[None, :]  # k index
    basis = (2.0 / n) * np.cos(np.pi / n * (samples + 0.5) * freqs)
    return basis  # [N, E]


@functools.lru_cache(maxsize=64)
def _idct_basis_np(n: int, e: int) -> np.ndarray:
    """Inverse (DCT-III) basis, shape [E, N]: x = C @ basis.

    Truncated reconstruction: coefficients k >= E are treated as zero
    (spectral truncation, paper §3.1).
    """
    samples = np.arange(n, dtype=np.float64)[None, :]
    freqs = np.arange(e, dtype=np.float64)[:, None]
    basis = np.cos(np.pi / n * (samples + 0.5) * freqs)
    basis[0, :] *= 0.5  # DC term halved in the inverse
    return basis  # [E, N]


def dct_basis(n: int, e: int, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(_dct_basis_np(n, e), dtype=dtype, device=device)


def idct_basis(n: int, e: int, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(_idct_basis_np(n, e), dtype=dtype, device=device)


def window_signal(signal: torch.Tensor, n: int) -> torch.Tensor:
    """Partition a 1-D signal strip into non-overlapping windows [W, N].

    The tail is zero-padded to a whole window (decoder trims via sample count
    carried in the container header).
    """
    length = signal.shape[-1]
    num_windows = -(-length // n)
    pad = num_windows * n - length
    if pad:
        signal = torch.nn.functional.pad(signal, (0, pad))
    return signal.reshape(signal.shape[:-1] + (num_windows, n))


def unwindow_signal(windows: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of :func:`window_signal`: [..., W, N] -> [..., length]."""
    flat = windows.reshape(windows.shape[:-2] + (-1,))
    return flat[..., :length]


def forward_dct(windows: torch.Tensor, e: int) -> torch.Tensor:
    """[..., W, N] windows -> [..., W, E] retained DCT-II coefficients."""
    n = windows.shape[-1]
    basis = dct_basis(n, e, dtype=windows.dtype, device=windows.device)
    return windows @ basis


def inverse_dct(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """[..., W, E] coefficients -> [..., W, N] reconstructed windows."""
    e = coeffs.shape[-1]
    basis = idct_basis(n, e, dtype=coeffs.dtype, device=coeffs.device)
    return coeffs @ basis
