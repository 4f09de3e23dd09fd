"""Workload signal domains: KV-cache timelines and training state.
Port of ``repro/core/domains.py``.

The paper calibrates per *signal domain* (biomedical, seismic, power,
meteorological).  Two serving/training workloads are just more signal
domains for the same transform → quantize → (optional) entropy-code
pipeline:

  * **kv** — a KV-cache block ``[B, T, H, D]`` is ``B * H * D`` independent
    time-axis channels; adjacent-token keys/values of trained models are
    smooth, so windowed DCT along the token axis concentrates energy in the
    low bins exactly like an archival strip.  The cache path runs
    *fixed-rate* (transform + table quantization, no entropy coding) so
    compressed blocks keep a static size and O(1) random access during
    decode.
  * **train_state** — parameter / optimizer / gradient tensors flatten into
    fixed-length 1-D shards; accumulators are smooth along the flattened
    axis.  Shards ride the full entropy-coded container path (they live on
    disk / the checkpoint wire, where variable size is fine).

Both calibrations are thin shims over :func:`repro_torch.core.calibration.
calibrate`; they only own the domain-specific *flattening* of structured
tensors into the 1-D strips the calibrator samples windows from, plus the
reserved domain ids the container header carries.  Inputs are tensors (on
any device) or numpy arrays; trees are nested dicts, lists and tuples
(:mod:`repro_torch.core.tree`).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import dct
from repro_torch.core.calibration import DomainTables, calibrate
from repro_torch.core.config import DOMAIN_DEFAULTS, CodecConfig
from repro_torch.core.tree import tree_leaves

__all__ = [
    "KV_DOMAIN_ID",
    "TRAIN_STATE_DOMAIN_ID",
    "kv_channel_strips",
    "calibrate_kv",
    "train_state_strip",
    "calibrate_train_state",
]

# Reserved domain ids for the workload domains.  0-4 are the archival
# domains (see tests/_synth.GOLDEN_DOMAINS), 5-7 stay free for archival
# growth; containers carry the id in the header so a decode with the wrong
# tables is rejected by validate_container_tables.
KV_DOMAIN_ID = 8
TRAIN_STATE_DOMAIN_ID = 9

# the float types the reference's train-state walk keeps: numpy has no
# bfloat16 (the reference sees it as a void type and skips it)
_STATE_FLOATS = (torch.float16, torch.float32, torch.float64)


def _as_tensor(x: Any) -> torch.Tensor:
    """A tensor where it lives, or a numpy array / scalar as a host tensor
    (sharing its memory where numpy allows)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def kv_channel_strips(kv: Any, n: int) -> np.ndarray:
    """Flatten a KV block ``[B, T, H, D]`` into per-channel time strips.

    Returns ``f32[B * H * D, T]`` (numpy, on the host) — one row per
    (batch, head, dim) channel, samples ordered along the token axis (the
    axis the windowed DCT runs over).  ``T`` must be a multiple of the
    window size ``n`` so that concatenated rows never share a window.
    """
    kv = _as_tensor(kv)
    if kv.ndim != 4:
        raise ValueError(
            f"KV block must be [B, T, H, D], got shape {tuple(kv.shape)}"
        )
    t = kv.shape[1]
    if t % n:
        raise ValueError(
            f"KV time axis T={t} must be a multiple of the DCT window "
            f"n={n} (fixed-size blocks keep O(1) cache access)"
        )
    strips = kv.to(torch.float32).movedim(1, -1).reshape(-1, t)
    return strips.cpu().numpy()


def calibrate_kv(
    kv_sample: Any,
    config: Optional[CodecConfig] = None,
    *,
    domain_id: int = KV_DOMAIN_ID,
    max_windows: Optional[int] = 65536,
    seed: int = 0,
) -> DomainTables:
    """Calibrate ``kv``-domain tables from a representative KV block.

    ``kv_sample`` is ``[B, T, H, D]`` (e.g. one layer's key or value cache
    after a representative prefill).  Every (batch, head, dim) channel
    contributes its token timeline to the calibration strip; windows are
    channel-aligned, so the per-bin scales and the symbol histogram see
    exactly the coefficient distribution the fixed-rate cache path will
    quantize.
    """
    config = config or DOMAIN_DEFAULTS["kv"]
    strips = kv_channel_strips(kv_sample, config.n)
    return calibrate(
        strips.reshape(-1), config,
        domain_id=domain_id, max_windows=max_windows, seed=seed,
    )


def _float_leaves(tree_or_leaves: Any):
    """Per float16/32/64 leaf that holds data, in tree order: its samples
    flattened to f32 where it lives, and their max-abs."""
    for leaf in tree_leaves(tree_or_leaves):
        if not isinstance(leaf, torch.Tensor) and (
                np.asarray(leaf).dtype.kind != "f"):
            continue  # numpy's void, object, integer ... leaves
        t = _as_tensor(leaf)
        if t.dtype not in _STATE_FLOATS or t.numel() == 0:
            continue
        flat = t.reshape(-1).to(torch.float32)
        yield flat, float(flat.abs().max())


def train_state_strip(
    tree_or_leaves: Any,
    *,
    max_elems: int = 1 << 22,
    seed: int = 0,
) -> np.ndarray:
    """Flatten a tree (or iterable) of float tensors into one 1-D strip.

    Large states are subsampled leaf-proportionally to ``max_elems`` with
    contiguous runs (the calibrator needs *windows*, so sampling keeps
    whole aligned spans rather than scattered elements).  Leaves that are
    not float16/32/64 are skipped — they do not compress through FPTC.

    Each leaf is normalized to unit max-abs before it joins the strip:
    checkpoint leaves span orders of magnitude (params vs Adam ``v``), and
    the encode path (``serving.workloads.state_to_containers``) applies
    the same per-leaf normalization, so calibration must see the
    distribution the quantizer will actually face.  The normalization runs
    where each leaf lives; only the sampled runs reach the host.
    """
    flats = list(_float_leaves(tree_or_leaves))
    if not flats:
        raise ValueError("no float leaves to calibrate train_state on")
    total = sum(f.numel() for f, _ in flats)
    if total > max_elems:
        rng = np.random.default_rng(seed)
        kept = []
        for f, amax in flats:
            take = max(int(f.numel() / total * max_elems), 1)
            take = min(take, f.numel())
            start = int(rng.integers(0, f.numel() - take + 1))
            kept.append((f[start:start + take], amax))
        flats = kept
    # the normalization is elementwise, so only the kept runs are divided
    return np.concatenate([
        (f / np.float32(amax) if amax > 0.0 else f).cpu().numpy()
        for f, amax in flats])


def calibrate_train_state(
    tree_or_leaves: Any,
    config: Optional[CodecConfig] = None,
    *,
    domain_id: int = TRAIN_STATE_DOMAIN_ID,
    max_windows: Optional[int] = 65536,
    seed: int = 0,
) -> DomainTables:
    """Calibrate ``train_state``-domain tables from a representative state.

    One calibration serves a whole checkpoint: every float leaf contributes
    to the strip, and the resulting tables are serialized once per
    checkpoint (scale + histogram sidecar) instead of once per leaf.

    At a 100th-percentile operating point (the ``train_state`` default)
    each bin's scale also covers every window of the whole state
    (:func:`_state_coeff_max`), not only the sampled strip's: the
    reference takes it over the strip, which for states past ``max_elems``
    clips the leaves whose extremes the sample missed.  Below ``max_elems``
    both give the same scales.
    """
    config = config or DOMAIN_DEFAULTS["train_state"]
    strip = train_state_strip(tree_or_leaves, seed=seed)
    floor = None
    if config.a0_percentile >= 100.0:
        floor = _state_coeff_max(tree_or_leaves, config) * (
            config.scale_headroom)
    return calibrate(
        strip, config,
        domain_id=domain_id, max_windows=max_windows, seed=seed,
        scale_floor=floor,
    )


def _state_coeff_max(tree_or_leaves: Any, config: CodecConfig,
                     chunk_windows: int = 1 << 20) -> np.ndarray:
    """Per DCT bin, the largest |coefficient| over every window of every
    float leaf, normalized as the encode normalizes it (``[E]``, float64).

    The sampled strip keeps a run of each leaf, so a leaf whose extremes
    lie outside its run (a drifting accumulator, or a small leaf that
    contributes a few samples) would sit past its bin's 100th-percentile
    scale and clip; taking the percentile over the whole state keeps the
    configured "no clipping" operating point.  Windows start at each
    leaf's first sample, as in the encode's shards (a multiple of ``n``
    long).  Runs where each leaf lives, a chunk of windows at a time.
    """
    n, e = config.n, config.e
    out = np.zeros(e, np.float64)
    for flat, amax in _float_leaves(tree_or_leaves):
        if amax > 0.0:
            flat = flat / np.float32(amax)
        windows = dct.window_signal(flat, n)
        basis = dct.dct_basis(n, e, device=flat.device)
        for lo in range(0, windows.shape[0], chunk_windows):
            peak = (windows[lo:lo + chunk_windows] @ basis).abs().amax(0)
            out = np.maximum(out, peak.double().cpu().numpy())
    return out
