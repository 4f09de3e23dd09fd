"""Synthetic signal generators for the paper's four domains (Table 2).

The paper evaluates on ten datasets across biomedical / seismic / power /
meteorological domains.  Those corpora are not redistributable here, so each
dataset is modeled by a generator that reproduces the *statistical structure
the codec exploits*: spectral decay rate, local smoothness, stationarity,
amplitude distribution, and characteristic waveform features (QRS complexes,
seismic wavelets, diurnal cycles, ...).  Generators are deterministic given a
seed, so calibration/eval splits are reproducible.

Port of ``repro/data/signals.py`` (numpy, unchanged).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["DATASETS", "make_signal"]


def _ecg(rng: np.random.Generator, n: int, fs: float = 360.0) -> np.ndarray:
    """MIT-BIH-like ECG: quasi-periodic PQRST via Gaussian bumps + drift."""
    t = np.arange(n) / fs
    hr = 1.1 + 0.1 * np.sin(2 * np.pi * 0.1 * t)  # beats/sec with HRV
    phase = np.cumsum(hr) / fs
    beat_phase = phase % 1.0
    sig = np.zeros(n)
    # (center, width, amplitude) of P, Q, R, S, T waves in beat-phase units
    for c, w, a in [
        (0.15, 0.025, 0.12),
        (0.235, 0.010, -0.18),
        (0.25, 0.008, 1.20),
        (0.265, 0.010, -0.25),
        (0.45, 0.045, 0.30),
    ]:
        sig += a * np.exp(-0.5 * ((beat_phase - c) / w) ** 2)
    baseline = 0.08 * np.sin(2 * np.pi * 0.25 * t + rng.uniform(0, 6))
    noise = 0.01 * rng.standard_normal(n)
    return (sig + baseline + noise).astype(np.float32)


def _eeg(rng: np.random.Generator, n: int, fs: float = 250.0) -> np.ndarray:
    """EEG-MAT-like: 1/f background + alpha/beta band oscillations."""
    freqs = np.fft.rfftfreq(n, 1 / fs)
    spec = rng.standard_normal(freqs.size) + 1j * rng.standard_normal(freqs.size)
    mag = np.zeros_like(freqs)
    nz = freqs > 0
    mag[nz] = 1.0 / freqs[nz]  # 1/f
    mag += 2.0 * np.exp(-0.5 * ((freqs - 10.0) / 1.5) ** 2)  # alpha
    mag += 0.6 * np.exp(-0.5 * ((freqs - 22.0) / 3.0) ** 2)  # beta
    sig = np.fft.irfft(spec * mag, n)
    sig = sig / (np.std(sig) + 1e-9) * 20.0  # ~20 uV
    return sig.astype(np.float32)


def _seismic(rng: np.random.Generator, n: int, fs: float = 500.0) -> np.ndarray:
    """Seismic reflection trace: sparse reflectivity * Ricker wavelet + AGC-ish
    amplitude decay.  Low smoothness, broadband — the paper's hardest domain."""
    refl = np.zeros(n)
    k = max(n // 200, 4)
    pos = rng.choice(n, size=k, replace=False)
    refl[pos] = rng.laplace(0, 1.0, size=k)
    fm = 30.0  # Ricker dominant frequency
    tw = (np.arange(-127, 128)) / fs
    ricker = (1 - 2 * (np.pi * fm * tw) ** 2) * np.exp(-((np.pi * fm * tw) ** 2))
    sig = np.convolve(refl, ricker, mode="same")
    decay = np.exp(-np.arange(n) / (n * 0.7))
    noise = 0.02 * rng.standard_normal(n)
    return ((sig * decay) + noise).astype(np.float32)


def _power(
    rng: np.random.Generator, n: int, fs: float = 1.0 / 60, kind: str = "load"
) -> np.ndarray:
    """PSML-like power telemetry: smooth diurnal + weekly structure + ramps."""
    t = np.arange(n) * 60.0  # seconds at 1-min sampling
    day = 86400.0
    sig = 50.0 + 12.0 * np.sin(2 * np.pi * t / day - 1.2)
    sig += 4.0 * np.sin(4 * np.pi * t / day + 0.4)
    sig += 2.5 * np.sin(2 * np.pi * t / (7 * day))
    if kind == "solar":
        sig = np.maximum(0.0, 40.0 * np.sin(2 * np.pi * t / day - np.pi / 2))
        cloud = np.convolve(
            rng.standard_normal(n), np.ones(30) / 30, mode="same"
        )
        sig *= np.clip(1.0 - 0.3 * np.abs(cloud), 0.2, 1.0)
    elif kind == "wind":
        w = np.convolve(rng.standard_normal(n), np.ones(120) / 120, mode="same")
        sig = 25.0 + 18.0 * np.tanh(2.0 * w)
    ar = np.zeros(n)
    for i in range(1, n):
        ar[i] = 0.98 * ar[i - 1] + rng.standard_normal() * 0.15
    return (sig + ar).astype(np.float32)


def _meteo(
    rng: np.random.Generator, n: int, fs: float = 1.0 / 60, kind: str = "temp"
) -> np.ndarray:
    """Meteorological: strong diurnal/seasonal cycles, very smooth."""
    t = np.arange(n) * 60.0
    day = 86400.0
    if kind == "temp":
        sig = 15.0 + 8.0 * np.sin(2 * np.pi * t / day - 2.0)
        sig += 10.0 * np.sin(2 * np.pi * t / (365 * day))
        rough = 0.05
    elif kind == "irradiance":
        sig = np.maximum(0.0, 800.0 * np.sin(2 * np.pi * t / day - np.pi / 2))
        rough = 5.0
    else:  # wind speed
        w = np.convolve(rng.standard_normal(n), np.ones(60) / 60, mode="same")
        sig = 6.0 + 4.0 * np.abs(w)
        rough = 0.1
    ar = np.zeros(n)
    for i in range(1, n):
        ar[i] = 0.995 * ar[i - 1] + rng.standard_normal() * rough * 0.1
    return (sig + ar).astype(np.float32)


# name -> (domain, generator)
DATASETS: Dict[str, tuple] = {
    "mitbih": ("biomedical", _ecg),
    "ecg_arth": ("biomedical", lambda r, n: _ecg(r, n, fs=500.0)),
    "eeg_mat": ("biomedical", _eeg),
    "seismic": ("seismic", _seismic),
    "wind_power": ("power", lambda r, n: _power(r, n, kind="wind")),
    "solar_power": ("power", lambda r, n: _power(r, n, kind="solar")),
    "load_power": ("power", lambda r, n: _power(r, n, kind="load")),
    "temperature": ("meteorological", lambda r, n: _meteo(r, n, kind="temp")),
    "irradiance": (
        "meteorological",
        lambda r, n: _meteo(r, n, kind="irradiance"),
    ),
    "wind_speed": ("meteorological", lambda r, n: _meteo(r, n, kind="wind")),
}


def make_signal(name: str, num_samples: int, seed: int = 0) -> np.ndarray:
    """Generate `num_samples` of the named dataset's synthetic analog."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    _, gen = DATASETS[name]
    rng = np.random.default_rng(seed)
    return gen(rng, num_samples)


def domain_of(name: str) -> str:
    return DATASETS[name][0]
