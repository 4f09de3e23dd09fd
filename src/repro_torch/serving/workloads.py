"""Device-resident FPTC workloads: KV-cache and training-state compression.
Port of ``repro/serving/workloads.py``.

The engines compress *signals*; this module adapts two structured tensor
workloads onto them:

  * :class:`KVCacheCodec` — a model's KV cache blocks, compressed in the
    engines' **fixed-rate** mode (``BatchEncoder.encode_fixed`` — K5 —
    and ``BatchDecoder.decode_fixed`` — K3): windowed DCT along the token
    axis per (batch, head, dim) channel + calibrated table quantization,
    entropy coding OFF so every compressed block has a static size and
    cold cache reads stay O(1) during decode.  Levels live in device
    memory as uint8 — half the bytes of bf16 at ``e == n``.  Tables, and
    therefore engine plans, are cached per (layer group, dtype);
    compress/decompress never bounce through the host.
  * train-state sharding (:func:`shard_state` / :func:`unshard_state` +
    :func:`state_to_containers` / :func:`state_from_containers`) — float
    tensors of a checkpoint/optimizer tree flatten into fixed-length 1-D
    shards that ride the full entropy-coded container path as batched
    encodes (K4; every shard but a leaf's last has the same length, so they
    share one bucket) and batched decodes (K1 + K2), one of each per
    ``MAX_CALL_SAMPLES`` samples.
    ``distributed.checkpoint`` uses these for compressed checkpoints.

Both workloads use calibrated :class:`~repro_torch.core.calibration.
DomainTables` from :mod:`repro_torch.core.domains`.  The engines run on the
card unless the caller asks for the CPU (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.calibration import DomainTables
from repro_torch.core.config import DOMAIN_DEFAULTS, CodecConfig
from repro_torch.core.container import Container
from repro_torch.core.domains import KV_DOMAIN_ID, calibrate_kv
from repro_torch.serving.batch_decode import BatchDecoder
from repro_torch.serving.batch_encode import DEFAULT_CHUNK_SIZE, BatchEncoder

__all__ = [
    "CompressedKV",
    "KVCacheCodec",
    "shard_state",
    "unshard_state",
    "state_to_containers",
    "state_from_containers",
    "DEFAULT_SHARD_LEN",
    "MAX_CALL_SAMPLES",
    "engine_calls",
    "write_workloads_report",
]


def dtype_name(dtype) -> str:
    """A numpy or torch dtype by numpy's name (``float32``, ``bfloat16``),
    the name the reference's manifests carry."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _dtype_of(x: Any) -> torch.dtype:
    return _torch_dtype(x.dtype) if hasattr(x, "dtype") else torch.float32


# ---------------------------------------------------------------------------
# KV-cache workload.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompressedKV:
    """One compressed KV block: device-resident uint8 levels, fixed size.

    ``levels`` is ``uint8[B, H, D, W, E]`` — per-channel token-axis DCT
    windows, table-quantized.  ``t`` is the original token count
    (``t == W * n``), ``dtype`` the cache's torch dtype to restore on
    decompress.  The compressed footprint is exactly the levels' bytes — no
    sidecar: the quantizer scales live in the calibrated tables, shipped
    once per (layer group, dtype), not per block.
    """

    levels: torch.Tensor
    t: int
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return self.levels.numel() * self.levels.element_size()

    def raw_nbytes(self) -> int:
        """Bytes of the uncompressed block in its original dtype."""
        b, h, d, _, _ = self.levels.shape
        return b * h * d * self.t * self.dtype.itemsize

    @property
    def ratio(self) -> float:
        """Measured compressed/raw byte ratio (actual tensor bytes)."""
        return self.nbytes / self.raw_nbytes()


class KVCacheCodec:
    """Fixed-rate KV-cache compression over the batched engines.

    Usage::

        codec = KVCacheCodec()                        # the card; or
                                                      # device="cpu"
        codec.calibrate(sample_block, layer="attn")   # once, offline
        ckv = codec.compress(kv_block, layer="attn")  # uint8 levels
        kv  = codec.decompress(ckv, layer="attn")     # [B, T, H, D] again

    ``layer`` names a *table group* — calibration is per (layer group,
    dtype), so e.g. all attention layers of one model can share tables
    (keys and values usually want separate groups; their distributions
    differ).  Compress and decompress stay on the device: one channel
    transpose copy and one K5 launch, one K3 launch and one transpose copy
    back, with no host sync (``tests/test_torch_gpu.py`` pins it).
    """

    def __init__(
        self,
        *,
        config: Optional[CodecConfig] = None,
        encoder: Optional[BatchEncoder] = None,
        decoder: Optional[BatchDecoder] = None,
        device=None,
    ):
        self.config = config or DOMAIN_DEFAULTS["kv"]
        self.encoder = encoder or BatchEncoder(device=device)
        self.decoder = decoder or BatchDecoder(device=device)
        self._tables: Dict[Tuple[Any, torch.dtype], DomainTables] = {}

    # -- tables ------------------------------------------------------------
    @staticmethod
    def _key(layer: Any, dtype) -> Tuple[Any, torch.dtype]:
        return (layer, _torch_dtype(dtype))

    def calibrate(
        self, kv_sample: Any, *, layer: Any = None,
        domain_id: int = KV_DOMAIN_ID,
    ) -> DomainTables:
        """Calibrate (and register) tables for one (layer group, dtype).

        ``kv_sample`` is a representative ``[B, T, H, D]`` block — e.g. the
        layer's cache after prefilling calibration prompts.
        """
        tables = calibrate_kv(kv_sample, self.config, domain_id=domain_id)
        self._tables[self._key(layer, _dtype_of(kv_sample))] = tables
        return tables

    def set_tables(
        self, tables: DomainTables, *, layer: Any = None,
        dtype=torch.bfloat16,
    ) -> None:
        """Register pre-calibrated tables (shipped structures) for a group."""
        self._tables[self._key(layer, dtype)] = tables

    def tables_for(self, *, layer: Any = None, dtype=torch.bfloat16
                   ) -> DomainTables:
        key = self._key(layer, dtype)
        try:
            return self._tables[key]
        except KeyError:
            raise KeyError(
                f"no KV tables calibrated for (layer, dtype)={key} — call "
                "calibrate(sample_block, layer=...) or set_tables(...) first"
            ) from None

    # -- the hot path ------------------------------------------------------
    def channel_strips(self, kv) -> torch.Tensor:
        """``[B, T, H, D]`` -> contiguous ``f32[B, H, D, T]`` on the
        encoder's device: the channel transpose and the cast in one copy,
        made on purpose so that the fixed-rate encode reads whole rows."""
        kv = torch.as_tensor(kv, device=self.encoder.device)
        b, t, h, d = kv.shape
        x = torch.empty((b, h, d, t), dtype=torch.float32, device=kv.device)
        return x.copy_(kv.movedim(1, -1))

    def compress(self, kv, *, layer: Any = None) -> CompressedKV:
        """``[B, T, H, D]`` cache block -> fixed-size uint8 levels.

        The channel transpose (:meth:`channel_strips`), then one K5 launch
        through :meth:`BatchEncoder.encode_fixed`; ``T`` must be a multiple
        of the domain's window size.  A block on the encoder's device never
        visits the host.
        """
        if kv.ndim != 4:
            raise ValueError(
                f"KV block must be [B, T, H, D], got {tuple(kv.shape)}"
            )
        dtype = _dtype_of(kv)
        tables = self.tables_for(layer=layer, dtype=dtype)
        levels = self.encoder.encode_fixed(self.channel_strips(kv), tables)
        return CompressedKV(levels=levels, t=int(kv.shape[1]), dtype=dtype)

    def decompress(self, ckv: CompressedKV, *, layer: Any = None
                   ) -> torch.Tensor:
        """Inverse of :meth:`compress` -> a contiguous ``[B, T, H, D]``
        tensor in the block's dtype: one K3 launch (3-zone dequant + iDCT)
        through :meth:`BatchDecoder.decode_fixed`, then the transpose and
        the cast back in one copy."""
        tables = self.tables_for(layer=layer, dtype=ckv.dtype)
        x = self.decoder.decode_fixed(ckv.levels, tables, length=ckv.t)
        b, h, d, t = x.shape
        out = torch.empty((b, t, h, d), dtype=ckv.dtype, device=x.device)
        return out.copy_(x.movedim(-1, 1))


# ---------------------------------------------------------------------------
# Training-state workload.
# ---------------------------------------------------------------------------
DEFAULT_SHARD_LEN = 1 << 16  # 64Ki samples per shard: uniform buckets, and
# each shard's packing chunks parallelize inside one engine dispatch


def _host_f32(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf's samples as host f32 (numpy) and its dtype's name."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy(), dtype_name(
            x.dtype)
    arr = np.asarray(x)
    return arr.astype(np.float32), str(arr.dtype)


def shard_state(
    arrays: Mapping[str, Any],
    *,
    shard_len: int = DEFAULT_SHARD_LEN,
    normalize: bool = False,
) -> Tuple[List[np.ndarray], List[dict]]:
    """Split named float tensors into fixed-length 1-D f32 shards.

    ``arrays`` maps names to numpy arrays or tensors (on any device).
    Returns ``(shards, manifest)``: host f32 shards in deterministic
    (key-sorted, then offset) order, and per-leaf manifest entries ``{key,
    shape, dtype, lengths}`` where ``lengths`` are the true sample counts
    of the leaf's shards (all ``shard_len`` except the tail).  Uniform
    shard lengths mean one encode bucket shape per checkpoint.

    ``normalize=True`` scales each leaf to unit max-abs and records the
    scale in its manifest entry (``unshard_state`` undoes it).  The lossy
    container path uses this: one shared quantizer then serves leaves that
    span orders of magnitude (params vs Adam ``v``), instead of the
    smallest-scale leaves losing all their resolution to the largest.
    The default (``False``) keeps shard/unshard bit-exact.
    """
    if shard_len <= 0:
        raise ValueError(f"shard_len must be positive, got {shard_len}")
    shards: List[np.ndarray] = []
    manifest: List[dict] = []
    for key in sorted(arrays):
        flat, name = _host_f32(arrays[key])
        entry = {
            "key": key,
            "shape": list(flat.shape),
            "dtype": name,
        }
        flat = flat.ravel()
        if normalize:
            amax = float(np.max(np.abs(flat))) if flat.size else 0.0
            scale = amax if amax > 0.0 else 1.0
            flat = flat / np.float32(scale)
            entry["scale"] = scale
        lengths = []
        for start in range(0, flat.size, shard_len):
            piece = flat[start:start + shard_len]
            shards.append(piece)
            lengths.append(int(piece.size))
        entry["lengths"] = lengths
        manifest.append(entry)
    return shards, manifest


def unshard_state(
    shards: Sequence[np.ndarray], manifest: Sequence[dict]
) -> Dict[str, Any]:
    """Reassemble :func:`shard_state` output (shards in manifest order).

    Each leaf comes back as a numpy array of its recorded dtype; a
    ``bfloat16`` leaf, which numpy cannot hold, as a host tensor."""
    out: Dict[str, Any] = {}
    pos = 0
    for entry in manifest:
        n_shards = len(entry["lengths"])
        pieces = shards[pos:pos + n_shards]
        pos += n_shards
        for piece, want in zip(pieces, entry["lengths"]):
            if piece.shape[0] != want:
                raise ValueError(
                    f"shard of {entry['key']} has {piece.shape[0]} samples, "
                    f"manifest says {want}"
                )
        flat = np.concatenate([np.asarray(p, np.float32) for p in pieces]) \
            if pieces else np.empty(0, np.float32)
        if "scale" in entry:  # undo shard_state(normalize=True)
            flat = flat * np.float32(entry["scale"])
        if entry["dtype"] == "bfloat16":
            out[entry["key"]] = torch.from_numpy(flat).to(
                torch.bfloat16).reshape(entry["shape"])
        else:
            out[entry["key"]] = flat.astype(np.dtype(entry["dtype"])
                                            ).reshape(entry["shape"])
    if pos != len(shards):
        raise ValueError(
            f"manifest covers {pos} shards, got {len(shards)}"
        )
    return out


# samples in one engine call.  The kernels' offsets are int32 (a decode
# bucket past 2**31 symbols is refused: ``ops.check_i32_offsets``) and the
# bucket ladder pads a call's windows up to twice their count, so a state
# of more samples goes through the engines in several calls; the
# containers' bytes do not depend on the split (signals encode and decode
# independently)
MAX_CALL_SAMPLES = 1 << 30


def engine_calls(lengths: Sequence[int],
                 budget: Optional[int] = None) -> List[slice]:
    """Consecutive runs of shards (by their sample counts ``lengths``),
    each of at most ``budget`` samples (``MAX_CALL_SAMPLES``): the engine
    calls of a state."""
    budget = MAX_CALL_SAMPLES if budget is None else budget
    calls: List[slice] = []
    start = total = 0
    for i, n in enumerate(lengths):
        if total and total + n > budget:
            calls.append(slice(start, i))
            start, total = i, 0
        total += int(n)
    if start < len(lengths):
        calls.append(slice(start, len(lengths)))
    return calls


def state_to_containers(
    arrays: Mapping[str, Any],
    tables: DomainTables,
    *,
    encoder: Optional[BatchEncoder] = None,
    shard_len: int = DEFAULT_SHARD_LEN,
    device=None,
) -> Tuple[List[Container], List[dict]]:
    """Encode a named-tensor state as FPTC containers, one batched encode
    per ``MAX_CALL_SAMPLES`` samples (``engine_calls``).

    The shards of every leaf go through one :meth:`BatchEncoder.encode`
    call — uniform shard lengths land in the same bucket, so the whole
    checkpoint is a handful of K4 launches with chunk-parallel packing,
    drained once a call (the bytes are headed to disk anyway).  Leaves
    are normalized to unit max-abs before quantization (scales ride the
    manifest), matching the normalization :func:`repro_torch.core.domains.
    train_state_strip` applies at calibration.  With no ``encoder`` one is
    made on ``device`` (the card unless ``device="cpu"``).
    """
    encoder = encoder or BatchEncoder(chunk_size=DEFAULT_CHUNK_SIZE,
                                      device=device)
    shards, manifest = shard_state(
        arrays, shard_len=shard_len, normalize=True
    )
    containers = [
        c for part in engine_calls([s.size for s in shards])
        for c in encoder.encode(shards[part], tables).to_host()
    ]
    return containers, manifest


def state_from_containers(
    containers: Sequence[Container],
    manifest: Sequence[dict],
    tables: DomainTables,
    *,
    decoder: Optional[BatchDecoder] = None,
    device=None,
) -> Dict[str, Any]:
    """Decode :func:`state_to_containers` output back into named host
    arrays (one batched decode and one drain per ``engine_calls`` run of
    containers).  With no ``decoder`` one is made on ``device`` (the card
    unless ``device="cpu"``)."""
    decoder = decoder or BatchDecoder(device=device)
    containers = list(containers)
    shards = [
        x for part in engine_calls([c.signal_length for c in containers])
        for x in decoder.decode(containers[part], tables).to_host()
    ]
    return unshard_state(shards, manifest)


# ---------------------------------------------------------------------------
# Workload benchmark reporting.
# ---------------------------------------------------------------------------
def write_workloads_report(
    section: str,
    payload: dict,
    path: Optional[str] = None,
) -> str:
    """Merge one workload's report into ``BENCH_workloads.json``.

    Each workload owns a section (``"kv_cache"`` / ``"checkpoint"``); the
    file accumulates sections.  Writes are atomic (temp file + rename).
    """
    if path is None:
        path = os.path.join(
            "benchmarks", "artifacts", "workloads", "BENCH_workloads.json"
        )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    report = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                report = json.load(f)
        except (json.JSONDecodeError, OSError):
            report = {}
    report[section] = payload
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path
