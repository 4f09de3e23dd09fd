"""Batched bucketed encode engine: one bucket encode per shape bucket.
Port of ``repro/serving/batch_encode.py``.

The encode-side mirror of the decode engine, for server-side ingest,
transcoding, checkpoints and the KV cache (the paper's *embedded* encoder
stays ``core.codec.encode``, sequential by design):

  * **Chunk-parallel packing.**  Each signal's symbols are packed in
    fixed-size chunks, each from a fresh 64-bit word; SymLen words decode
    independently, so the chunked stream is decoder-compatible bit for bit
    at < 1 padding word per chunk.  ``chunk_size=None`` is *exact* mode:
    one chunk per signal, bit-identical to the host encoder.
  * **Shape bucketing.**  Signals are grouped by (domain, config) and
    padded into window/batch buckets on the policy's ladder; per-signal
    symbol counts ride a device array into the packer's validity mask.
  * **Persistent encode plans.**  Device tables and the DCT basis upload
    once per (domain, config, device) into an LRU :class:`EncodePlan`
    cache.  Each bucket's register tile comes from the tuning cache
    (``kernels.encode_fused`` resolves it once per bucket shape and cache
    epoch).
  * **Shards.**  ``devices=`` splits each bucket's rows into contiguous
    per-device shards at cost-balanced boundaries
    (:meth:`~repro_torch.tuning.cost_model.CostModel.signal_encode_cost`);
    ``encode_staged(shard_ids=, shard_devices=)`` pins rows to shards (the
    transcoder's re-encode stays where it decoded).  Rows pack
    independently, so the bytes never depend on the split.
  * **Device-resident results.**  Chunk parts stay on the device inside an
    :class:`EncodedBatch` until one ``.to_host()`` drain, where the
    per-row histogram-gap flags are checked too.

Each bucket is one K4 encode (``kernels.encode_fused``: ``encode_levels``
then ``symlen_pack``) on the card; a bucket staged as a
:class:`~repro_torch.serving.engine.GatherStage` (the transcoder's path)
reads its rows straight out of a flat device tensor
(``encode_levels_gather`` then ``symlen_pack``); the fixed-rate mode is one
K5 (``kernels.dct_quant``).  The engine runs on the card unless the caller
asks for the CPU (``device="cpu"``), where every kernel wrapper takes its
plain version; there is no ``use_kernels`` switch.  ``quarantine=True``
demotes the device-side histogram-gap flag from batch-fatal to a typed
per-signal outcome at the drain.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch.core import dct, symlen
from repro_torch.core.calibration import DeviceTables, DomainTables
from repro_torch.core.container import Container
from repro_torch.kernels.dct_quant import dct_quant
from repro_torch.kernels.encode_fused import encode_fused, encode_fused_gather
from repro_torch.kernels.encode_fused import gather_rows as _gather_rows_math
from repro_torch.serving._plans import (
    TRIVIAL_CODING,
    PlanCache,
    normalize_plan_key,
)
from repro_torch.serving.engine import (
    Bucket,
    BucketScheduler,
    GatherStage,
    PipelineExecutor,
    SubmitBuffer,
    Upload,
    block_until_ready,
    fetch_to_host,
    fetch_to_host_stitched,
    putter,
    resolve_device,
    serving_devices,
)
from repro_torch.tuning.cost_model import CostModel, default_cost_model
from repro_torch.tuning.policy import PolicyArg

__all__ = [
    "BatchEncoder",
    "BatchEncoderStats",
    "EncodedBatch",
    "EncodedBucketParts",
    "EncodePlan",
    "default_encoder",
    "DEFAULT_CHUNK_SIZE",
]

TablesArg = Union[DomainTables, Mapping[int, DomainTables]]

# Symbols per packing chunk.  Words per chunk ~= chunk * avg_bits / 64, so at
# ~4 bits/symbol a 1024-symbol chunk spans ~64 words and the <1-word-per-chunk
# padding bound costs < ~1.6% stream growth.
DEFAULT_CHUNK_SIZE = 1024


# ---------------------------------------------------------------------------
# Encode plans: per-(domain, config, device) state, uploaded once.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """Device-resident encode state for one (domain, config) on one device.

    Batch-size independent: one plan serves every bucket shape.
    ``has_gaps`` records (host-side, at plan build) whether the Huffman book
    has zero-length entries — only then does the pack check for
    unencodable symbols.
    """

    tables: DeviceTables
    basis: torch.Tensor  # f32[N, E] dct basis
    n: int
    e: int
    l_max: int
    domain_id: int
    has_gaps: bool
    device: torch.device
    source: DomainTables  # host tables (kept so cache keys stay alive)
    # container-v3 coding triple (pred_id, predict_bands, zero_planes);
    # TRIVIAL_CODING selects the classic v2 stream byte for byte
    coding: Tuple[int, int, bool] = TRIVIAL_CODING


def _build_encode_plan(tables: DomainTables, key, device) -> EncodePlan:
    domain_id, n, e, l_max, coding = normalize_plan_key(key)
    return EncodePlan(
        tables=tables.device_tables(device),
        basis=putter(device)(dct.dct_basis(n, e)),
        n=n,
        e=e,
        l_max=l_max,
        domain_id=domain_id,
        has_gaps=bool(np.any(np.asarray(tables.book.lengths) == 0)),
        device=device,
        source=tables,
        coding=coding,
    )


# ---------------------------------------------------------------------------
# The bucket encode contract.
# ---------------------------------------------------------------------------
def _encode_bucket_math(
    signals: torch.Tensor,  # f32[K, Wp * n] (zero-padded signals)
    counts: torch.Tensor,  # int32[K] true symbol count per signal
    tables: DeviceTables,
    basis: torch.Tensor,  # f32[n, e]
    *,
    n: int,
    e: int,
    chunk_size: int,
    check_gaps: bool,
    coding: Tuple[int, int, bool] = TRIVIAL_CODING,
):
    """DCT + quantize + chunk-parallel pack for one shape bucket.

    Per-signal true lengths ride in ``counts`` and become the packer's
    validity mask, so zero-padded windows contribute no symbols.  Returns
    the per-signal chunk parts (hi/lo/symlen ``[K, B, chunk_size]``, the
    uint32 halves as int32 bit patterns, + words-per-chunk ``[K, B]``) and
    the per-row unencodable-symbol flags ``bool[K]``; a v3 ``coding`` adds
    ``(ncoded, zrow, zcol)``.  K4 (``kernels.encode_fused``) on CUDA
    tensors, its plain version — the reference's XLA-arm math — on CPU
    tensors.
    """
    return encode_fused(
        signals, counts, tables, basis, n=n, e=e, chunk_size=chunk_size,
        check_gaps=check_gaps, coding=coding,
    )


def _encode_bucket_gather_math(
    flat: torch.Tensor,  # f32[T + width] (flattened decoded windows)
    starts: torch.Tensor,  # int32[K] first-sample offset per row
    lens: torch.Tensor,  # int32[K] true sample count per row
    counts: torch.Tensor,
    tables: DeviceTables,
    basis: torch.Tensor,
    *,
    width: int,
    n: int,
    e: int,
    chunk_size: int,
    check_gaps: bool,
    coding: Tuple[int, int, bool] = TRIVIAL_CODING,
):
    """:func:`_encode_bucket_math` of the rows ``_gather_rows_math(flat,
    starts, lens, width)`` describes (row ``r`` is ``flat[starts[r]:
    starts[r] + lens[r]]``, exact zero past ``lens[r]``).  On the card the
    gather runs inside the bucket encode (``encode_levels_gather``): the
    signal matrix is never materialized."""
    return encode_fused_gather(
        flat, starts, lens, counts, tables, basis, width=width, n=n, e=e,
        chunk_size=chunk_size, check_gaps=check_gaps, coding=coding,
    )


def _encode_fixed_math(
    x: torch.Tensor,  # f32[..., T] channel strips, T % n == 0
    tables: DeviceTables,
    basis: torch.Tensor,  # f32[n, e]
    *,
    n: int,
    e: int,
) -> torch.Tensor:
    """Fixed-rate (entropy-off) encode: DCT + table quantize only, uint8
    ``[..., W, e]``.  K5 (``kernels.dct_quant``) on CUDA tensors, its plain
    version on CPU tensors."""
    w = x.shape[-1] // n
    levels = dct_quant(x.reshape(-1, n), tables.quant, e=e, basis=basis,
                       exact=True)
    return levels.reshape(x.shape[:-1] + (w, e))


# ---------------------------------------------------------------------------
# Encoded batches: streams stay on the device until explicitly drained.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Slice:
    """Where signal i's stream lives: row ``row`` of bucket ``bucket``'s
    output tensors, plus the host-side container header fields."""

    bucket: int
    row: int
    num_windows: int
    signal_length: int
    n: int
    e: int
    l_max: int
    domain_id: int
    coding: Tuple[int, int, bool] = TRIVIAL_CODING


@dataclasses.dataclass(frozen=True)
class EncodedBucketParts:
    """One bucket's device-resident encode output, un-stitched.

    ``hi``/``lo``/``symlen`` are the per-chunk word runs ``[K, num_chunks,
    chunk_size]`` (hi/lo: the uint32 halves as int32 bit patterns) and
    ``words_per_chunk`` ``[K, num_chunks]``; rows past the real signals are
    batch padding and pack zero words.  ``unencodable`` is the per-row
    histogram-gap flag ``bool[K]``, checked at drain.  v3 buckets also
    carry per-signal coded-symbol counts ``ncoded`` and, with zero planes,
    the ``zrow``/``zcol`` masks.  ``shard``/``device`` record the
    scheduler's placement (a transcode of the parts stays there).
    """

    plan_key: tuple  # (domain_id, n, e, l_max, coding)
    hi: torch.Tensor  # int32[K, B, C]
    lo: torch.Tensor  # int32[K, B, C]
    symlen: torch.Tensor  # int32[K, B, C]
    words_per_chunk: torch.Tensor  # int32[K, B]
    unencodable: torch.Tensor  # bool[K]
    ncoded: Optional[torch.Tensor] = None  # int32[K] (v3 only)
    zrow: Optional[torch.Tensor] = None  # bool[K, Wp] (v3 zero planes)
    zcol: Optional[torch.Tensor] = None  # bool[K, e] (v3 zero planes)
    shard: int = 0
    device: Any = None

    @property
    def chunk_size(self) -> int:
        return int(self.hi.shape[2])

    @property
    def num_chunks(self) -> int:
        return int(self.hi.shape[1])

    def words_per_signal(self) -> torch.Tensor:
        """Per-row word extents int32[K], on the parts' device (no sync)."""
        return self.words_per_chunk.sum(dim=1, dtype=torch.int32)


def _gap_error(key) -> ValueError:
    return ValueError(
        f"encode batch for plan_key (domain_id, n, e, l_max, coding)={key} "
        "produced symbol(s) with no codeword (histogram gap in the Huffman "
        "book) — the stream would decode to garbage; recalibrate with "
        "Laplace smoothing or a complete codebook"
    )


class EncodedBatch:
    """Result of :meth:`BatchEncoder.encode` — device-resident streams.

    ``to_host()`` performs the only host sync: the histogram-gap flags are
    checked first, then every bucket's d2h copies start before any is read
    and the per-signal :class:`Container`\\ s are stitched (input order
    preserved).

    A batch drains **once**.  A second ``to_host()`` — or any drain after
    the device buffers were handed to a :class:`~repro_torch.serving.
    transcode.Transcoder` — raises instead of silently re-syncing.
    Device-resident consumers read :meth:`device_parts` /
    :meth:`signal_slices` instead of draining.  ``pending_flags`` are
    histogram-gap flags inherited from upstream device stages (a
    transcode's source batch), checked at the drain like the batch's own.
    A quarantined batch (``poisoned`` records, ``quarantine=True``) returns
    a typed per-signal error at each poisoned position.
    """

    def __init__(
        self,
        buckets: List[EncodedBucketParts],
        slices: List[Optional[_Slice]],
        pending_flags: Sequence[Tuple[tuple, torch.Tensor]] = (),
        *,
        poisoned: Optional[Dict[int, Exception]] = None,
        quarantine: bool = False,
    ):
        self._buckets = buckets
        self._slices = slices
        self._pending_flags = list(pending_flags)
        # signals excluded before encoding (slice None at their index)
        self._poisoned: Dict[int, Exception] = dict(poisoned or {})
        self._quarantine = bool(quarantine)
        self._consumed: Optional[str] = None

    def __len__(self) -> int:
        return len(self._slices)

    def device_parts(self) -> List[EncodedBucketParts]:
        """The per-bucket chunk parts as device tensors — no host sync."""
        self._check_live("read device parts of")
        return list(self._buckets)

    def signal_slices(self) -> List[Optional[_Slice]]:
        """Per-signal (input order) location and header fields: which
        bucket/row holds signal i's chunk parts, plus its container header
        fields (num_windows, signal_length, n, e, l_max, domain_id,
        coding)."""
        return list(self._slices)

    def block_until_ready(self) -> "EncodedBatch":
        """Wait until every bucket's chunk parts are packed; returns self."""
        block_until_ready([p.words_per_chunk for p in self._buckets])
        return self

    def _check_live(self, verb: str) -> None:
        if self._consumed is not None:
            raise RuntimeError(
                f"cannot {verb} this EncodedBatch: {self._consumed}"
            )

    def _mark_consumed(self, reason: str) -> None:
        """Hand the batch to a device-resident consumer: later reads and
        drains raise with ``reason``, and the batch drops its references to
        the device buffers."""
        self._check_live("consume")
        self._consumed = reason
        self._buckets = []

    def to_host(self) -> List[Any]:
        """Drain the batch into containers: all d2h copies in flight
        together, then a host stitch of each signal's chunk word runs
        (chunk b of a row contributes its first ``wpc[row, b]`` words),
        bucket k's stitch overlapping bucket k+1's copies.

        A histogram gap raises ``ValueError`` for the whole batch and
        leaves it drainable (a retry raises the same error) — except under
        quarantine, where a flagged row becomes a
        :class:`~repro_torch.serving.quarantine.PoisonedContainerError` at
        its position and every other row drains as in a clean run.
        Upstream flags have no row-to-signal mapping here, so they stay
        batch-fatal even under quarantine."""
        self._check_live("drain")
        flags = fetch_to_host([f for _, f in self._pending_flags]
                              + [p.unencodable for p in self._buckets])
        npend = len(self._pending_flags)
        for (key, _), bad in zip(self._pending_flags, flags[:npend]):
            if bool(np.any(bad)):
                raise _gap_error(key)
        bucket_bad = flags[npend:]
        poisoned: Dict[int, Exception] = dict(self._poisoned)
        if self._quarantine:
            from repro_torch.serving.quarantine import (
                FAULT_HISTOGRAM_GAP,
                PoisonedContainerError,
            )

            for i, s in enumerate(self._slices):
                if s is None or i in poisoned:
                    continue
                if bool(bucket_bad[s.bucket][s.row]):
                    poisoned[i] = PoisonedContainerError(
                        "signal quantizes to symbol(s) with no codeword "
                        "(histogram gap in the Huffman book) under "
                        f"plan_key (domain_id, n, e, l_max, coding)="
                        f"{self._buckets[s.bucket].plan_key} — recalibrate "
                        "with Laplace smoothing or a complete codebook",
                        index=i,
                        fault=FAULT_HISTOGRAM_GAP,
                    )
        else:
            for p, bad in zip(self._buckets, bucket_bad):
                if bool(np.any(bad)):
                    raise _gap_error(p.plan_key)

        per_bucket: List[List[Tuple[int, _Slice]]] = [
            [] for _ in self._buckets
        ]
        for i, s in enumerate(self._slices):
            if s is not None and i not in poisoned:
                per_bucket[s.bucket].append((i, s))

        def stitch_bucket(b: int, host: List[np.ndarray]):
            hi, lo, sl, wpc = host[:4]
            # v3 buckets drain (ncoded[, zrow, zcol]) after the stream parts
            ncoded = host[4] if len(host) > 4 else None
            zrow = host[5] if len(host) > 5 else None
            zcol = host[6] if len(host) > 6 else None
            # every row's live words in (chunk, slot) order, all rows at
            # once; row r's run is [ends[r-1], ends[r])
            live = np.arange(hi.shape[2])[None, None, :] < wpc[:, :, None]
            hi_all = hi[live].view(np.uint32)
            lo_all = lo[live].view(np.uint32)
            sl_all = sl[live].astype(np.uint8)
            ends = np.cumsum(wpc.sum(axis=1, dtype=np.int64))
            stitched = []
            for i, s in per_bucket[b]:
                a, z = (int(ends[s.row - 1]) if s.row else 0), int(ends[s.row])
                pred_id, bands, zplanes = s.coding
                stitched.append((i, Container(
                    words=symlen.u32_to_words(hi_all[a:z], lo_all[a:z]),
                    symlen=sl_all[a:z].copy(),
                    num_symbols=(
                        s.num_windows * s.e if ncoded is None
                        else int(ncoded[s.row])
                    ),
                    num_windows=s.num_windows,
                    signal_length=s.signal_length,
                    n=s.n,
                    e=s.e,
                    l_max=s.l_max,
                    domain_id=s.domain_id,
                    predictor=pred_id,
                    predict_bands=bands,
                    zero_planes=zplanes,
                    zrow=(
                        zrow[s.row, : s.num_windows].copy()
                        if zplanes else None
                    ),
                    zcol=zcol[s.row].copy() if zplanes else None,
                )))
            return stitched

        def drain_tensors(p: EncodedBucketParts):
            ts = [p.hi, p.lo, p.symlen, p.words_per_chunk]
            if p.ncoded is not None:
                ts.append(p.ncoded)
            if p.zrow is not None:
                ts += [p.zrow, p.zcol]
            return ts

        results = fetch_to_host_stitched(
            [drain_tensors(p) for p in self._buckets], stitch_bucket,
        )
        self._consumed = (
            "it was already drained by to_host() — hold on to the returned "
            "containers instead of draining twice"
        )
        self._buckets = []  # release the device buffers
        out: List[Any] = [None] * len(self._slices)
        for i, err in poisoned.items():
            out[i] = err
        for stitched in results:
            for i, c in stitched:
                out[i] = c
        return out


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BatchEncoderStats:
    batches: int = 0
    signals: int = 0
    dispatches: int = 0  # bucket encodes launched
    plan_hits: int = 0
    plan_misses: int = 0
    # per-dispatch padding/occupancy records (bounded history)
    bucket_pad: "deque[dict]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024)
    )


StageFn = Callable[[Sequence[int], int, int, int, torch.device], Any]


class BatchEncoder:
    """Encodes many signals in one bucket encode per shape bucket.

    Usage::

        enc = BatchEncoder()                      # the card; or device="cpu"
        batch = enc.encode(signals, tables)       # tables: DomainTables, or
                                                  # {domain_id: DomainTables}
                                                  # + domain_ids=[...]
        containers = batch.to_host()              # one drain

    Signals are grouped by (domain, config) and sub-bucketed by window and
    batch counts on the ``policy`` ladder; each bucket is one K4 encode
    (``kernels.encode_fused``).  ``chunk_size=None`` selects *exact* mode
    (one packing chunk per signal): bit-identical output to
    ``core.codec.encode``, at the price of a serial pack per signal — that
    is what ``encode_device`` uses.  ``pipeline`` double-buffers host
    staging/upload against device compute.  With no ``device`` the encoder
    runs on the card and raises if there is none; ``device="cpu"`` runs the
    plain PyTorch versions.  ``devices`` shards each bucket's rows over
    several devices (``"auto"``: every visible card; a sequence, repeats
    allowed), split at cost-balanced boundaries over ``cost_model``'s
    per-signal encode cost; ``device`` and ``devices`` together must
    agree.  None of these change the bytes.
    """

    def __init__(
        self,
        *,
        chunk_size: Optional[int] = DEFAULT_CHUNK_SIZE,
        device=None,
        devices=None,
        plan_cache_size: int = 32,
        pipeline: bool = True,
        prefetch: int = 2,
        policy: PolicyArg = None,
        cost_model: Optional[CostModel] = None,
    ):
        if chunk_size is not None and chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.chunk_size = chunk_size
        self.devices = serving_devices(devices, device)
        self.device = self.devices[0]
        self._plans = PlanCache(_build_encode_plan, plan_cache_size)
        self.scheduler = BucketScheduler(devices=self.devices, policy=policy)
        self.executor = PipelineExecutor(
            self.devices, pipeline=pipeline, prefetch=prefetch
        )
        self.cost_model = (
            cost_model if cost_model is not None
            else default_cost_model(self.device)
        )
        self.stats = BatchEncoderStats()
        self._pending = SubmitBuffer()

    # -- incremental submission ----------------------------------------------
    def submit(
        self, signal: np.ndarray, domain_id: Optional[int] = None
    ) -> int:
        """Queue one signal for the next :meth:`flush` (thread-safe);
        ``domain_id`` routes its tables when the flush passes a mapping.
        Returns its index in flush order."""
        return self._pending.submit((signal, domain_id))

    @property
    def pending(self) -> int:
        """Signals submitted since the last flush."""
        return len(self._pending)

    def flush(self, tables: TablesArg, *,
              quarantine: bool = False) -> EncodedBatch:
        """Encode everything submitted since the last flush as one batch
        (submission order).  An empty flush is a no-op empty batch."""
        items = self._pending.take()
        signals = [s for s, _ in items]
        doms = [d for _, d in items]
        if all(d is None for d in doms):
            domain_ids = None
        elif any(d is None for d in doms):
            if not isinstance(tables, DomainTables):
                raise ValueError(
                    "flush with a {domain_id: DomainTables} mapping needs "
                    "every submit() to carry a domain_id"
                )
            domain_ids = [
                tables.domain_id if d is None else d for d in doms
            ]
        else:
            domain_ids = doms
        return self.encode(signals, tables, domain_ids=domain_ids,
                           quarantine=quarantine)

    # -- plan management ------------------------------------------------------
    @staticmethod
    def _tables_for(domain_id: int, tables: TablesArg) -> DomainTables:
        if isinstance(tables, DomainTables):
            return tables
        try:
            return tables[domain_id]
        except KeyError:
            raise KeyError(
                f"no DomainTables registered for domain_id={domain_id}"
            ) from None

    def plan_for(self, tables: DomainTables, device=None) -> EncodePlan:
        cfg = tables.config
        key = (tables.domain_id, cfg.n, cfg.e, cfg.l_max, cfg.coding)
        return self._plans.get(
            tables, key, self.device if device is None else device)

    # -- fixed-rate (entropy-off) encode --------------------------------------
    def encode_fixed(self, x, tables: DomainTables) -> torch.Tensor:
        """Transform + quantize only: ``f32[..., T]`` -> ``uint8[..., W, E]``
        on this encoder's device.

        The KV-cache workload's O(1)-access mode: compressed size is a pure
        function of the input shape, the tables ride the same
        :class:`EncodePlan` cache as the container path, and the result
        stays on the device.  ``T`` must be a multiple of the domain's
        window size ``n``; leading axes are free.  Decode with
        :meth:`BatchDecoder.decode_fixed`.  K5 on the card.
        """
        plan = self.plan_for(tables)
        n, e = plan.n, plan.e
        if x.shape[-1] % n:
            raise ValueError(
                f"fixed-rate encode needs the time axis ({x.shape[-1]}) to "
                f"be a multiple of the window size n={n} — pad the block "
                "(fixed-size blocks are the point of this mode)"
            )
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        levels = _encode_fixed_math(x, plan.tables, plan.basis, n=n, e=e)
        self.stats.dispatches += 1
        return levels

    # -- the batched encode ----------------------------------------------------
    def encode(
        self,
        signals: Sequence[np.ndarray],
        tables: TablesArg,
        *,
        domain_ids: Optional[Sequence[int]] = None,
        quarantine: bool = False,
    ) -> EncodedBatch:
        """Encode a (possibly mixed-domain, mixed-length) batch of signals.

        ``domain_ids`` assigns each signal its domain when ``tables`` is a
        mapping; with a single :class:`DomainTables` every signal uses it.
        Returns an :class:`EncodedBatch`; nothing is synced to the host
        here.  ``quarantine=True`` demotes the device-side histogram-gap
        flag from batch-fatal to a typed per-signal outcome at the drain.
        """
        signals = [np.asarray(s, dtype=np.float32).ravel() for s in signals]

        def stage(idxs, kp: int, wp: int, n: int, device) -> torch.Tensor:
            x = self.executor.host_buffer(kp * wp * n, torch.float32)
            rows = x.numpy().reshape(kp, wp * n)
            for row, i in enumerate(idxs):
                rows[row, : signals[i].shape[0]] = signals[i]
            return x.reshape(kp, wp * n)

        return self.encode_staged(
            [int(s.shape[0]) for s in signals], tables,
            domain_ids=domain_ids, stage=stage, quarantine=quarantine,
        )

    def encode_staged(
        self,
        lengths: Sequence[int],
        tables: TablesArg,
        *,
        stage: StageFn,
        domain_ids: Optional[Sequence[int]] = None,
        pending_flags: Sequence[Tuple[tuple, torch.Tensor]] = (),
        shard_ids: Optional[Sequence[int]] = None,
        shard_devices: Optional[Dict[int, Any]] = None,
        quarantine: bool = False,
    ) -> EncodedBatch:
        """The bucketing/dispatch core of :meth:`encode`, with the signal
        *staging* pluggable.

        ``stage(idxs, kp, wp, n, device)`` must produce the bucket's stacked
        signal matrix ``f32[kp, wp * n]`` — row ``r`` holds signal
        ``idxs[r]``'s samples followed by exact zeros, rows past
        ``len(idxs)`` all-zero — as a numpy array, a host tensor or a
        tensor already on ``device``; **or** a :class:`GatherStage`
        describing the rows as runs of a flat tensor on ``device``, gathered
        inside the bucket encode (the transcoder's path).  Under pipelining
        it runs on the executor's staging worker, one bucket ahead of
        dispatch.  Grouping, padding, chunk-size selection, the bucket
        encode and the slice metadata are this one code path, which is what
        makes device-staged encodes byte-identical to host-staged ones.
        ``pending_flags`` (plan key, device flag) ride the batch to its
        drain (a transcode's inherited histogram-gap flags).  Shard
        assignment is the scheduler's cost-balanced split unless
        ``shard_ids`` pins each signal to a shard, with ``shard_devices``
        mapping pinned ids from another scheduler to their devices.
        """
        self.stats.batches += 1
        self.stats.signals += len(lengths)
        if not lengths:
            return EncodedBatch([], [], pending_flags, quarantine=quarantine)
        if domain_ids is None:
            if not isinstance(tables, DomainTables):
                raise ValueError(
                    "domain_ids is required when tables is a "
                    "{domain_id: DomainTables} mapping"
                )
            domain_ids = [tables.domain_id] * len(lengths)
        if len(domain_ids) != len(lengths):
            raise ValueError(
                f"domain_ids has {len(domain_ids)} entries for "
                f"{len(lengths)} signals"
            )

        # group by ((domain, config), window bucket) — one bucket encode per
        # group; the batch dim is padded to a bucket edge in the upload
        keys = []
        per_tab: Dict[tuple, DomainTables] = {}
        all_windows: List[int] = []
        for length, dom in zip(lengths, domain_ids):
            tab = self._tables_for(dom, tables)
            cfg = tab.config
            num_windows = -(-int(length) // cfg.n)
            all_windows.append(num_windows)
            key = (
                (dom, cfg.n, cfg.e, cfg.l_max, cfg.coding),
                self.scheduler.round(max(num_windows, 1)),
            )
            keys.append(key)
            per_tab.setdefault(key, tab)
        # cost-balanced shard split over the predicted per-signal encode
        # cost (pinned shard_ids bypass the split)
        item_costs = None
        if self.scheduler.num_shards > 1 and shard_ids is None:
            item_costs = [
                self.cost_model.signal_encode_cost(
                    w, e=key[0][2], n=key[0][1])
                for w, key in zip(all_windows, keys)
            ]
        buckets = self.scheduler.buckets(
            keys, shard_ids=shard_ids, shard_devices=shard_devices,
            item_costs=item_costs,
        )

        slices: List[Optional[_Slice]] = [None] * len(lengths)
        for b, bucket in enumerate(buckets):
            plan_key, _ = bucket.key
            _, n, e, l_max, coding = plan_key
            for row, i in enumerate(bucket.items):
                slices[i] = _Slice(
                    bucket=b,
                    row=row,
                    num_windows=-(-int(lengths[i]) // n),
                    signal_length=int(lengths[i]),
                    n=n,
                    e=e,
                    l_max=l_max,
                    domain_id=plan_key[0],
                    coding=coding,
                )

        def upload(bucket: Bucket) -> Tuple[int, Upload]:
            plan_key, wp = bucket.key
            _, n, e, _, _ = plan_key
            idxs = list(bucket.items)
            # pad the batch dim to a bucket edge; pad rows pack 0 symbols
            kp = self.scheduler.round(len(idxs))
            counts = np.zeros((kp,), dtype=np.int32)
            for row, i in enumerate(idxs):
                counts[row] = -(-int(lengths[i]) // n) * e
            dev = self.device if bucket.device is None else bucket.device
            # plan prefetch: the staging worker pays the tables/basis upload
            self._plans.get(per_tab[bucket.key], plan_key, dev)
            x = stage(idxs, kp, wp, n, dev)
            if isinstance(x, GatherStage):
                return kp, x, self.executor.put([x.starts, x.lens, counts],
                                                dev)
            return kp, None, self.executor.put([x, counts], dev)

        def dispatch(bucket: Bucket, staged) -> EncodedBucketParts:
            kp, gather, up = staged
            plan_key, wp = bucket.key
            dev = self.device if bucket.device is None else bucket.device
            plan = self._plans.get(per_tab[bucket.key], plan_key, dev)
            n, e = plan.n, plan.e
            coding = plan.coding
            sp = wp * e
            chunk = sp if self.chunk_size is None else min(self.chunk_size,
                                                            sp)
            kw = dict(n=n, e=e, chunk_size=chunk, check_gaps=plan.has_gaps,
                      coding=coding)
            if gather is not None:
                starts, lens, counts = up.wait()
                flat = gather.flat
                if gather.last_use:  # the stage's reference goes with it
                    gather.flat = None
                if flat is None or flat.device != dev or (
                    flat.dtype != torch.float32 or flat.dim() != 1
                ) or tuple(starts.shape) != (kp,):
                    raise ValueError(
                        "GatherStage needs a flat float32 tensor on "
                        f"{dev} and {kp} starts/lens"
                    )
                out = _encode_bucket_gather_math(
                    flat, starts.to(torch.int32), lens.to(torch.int32),
                    counts, plan.tables, plan.basis, width=wp * n, **kw,
                )
            else:
                x, counts = up.wait()
                if tuple(x.shape) != (kp, wp * n) or (
                    x.dtype != torch.float32
                ):
                    raise ValueError(
                        f"stage returned {x.dtype} {tuple(x.shape)}, "
                        f"expected float32 {(kp, wp * n)}"
                    )
                out = _encode_bucket_math(x, counts, plan.tables, plan.basis,
                                          **kw)
            if coding == TRIVIAL_CODING:
                hi, lo, sl, wpc, bad = out
                ncoded = zrow = zcol = None
            else:
                hi, lo, sl, wpc, bad, ncoded, zrow, zcol = out
            self.stats.dispatches += 1
            self.stats.bucket_pad.append({
                "plan_key": plan_key,
                "shard": bucket.shard,
                "policy": self.scheduler.policy.name,
                "rows": len(bucket.items),
                "rows_padded": kp,
                "windows": sum(-(-int(lengths[i]) // n)
                               for i in bucket.items),
                "windows_padded": wp * kp,
            })
            return EncodedBucketParts(
                plan_key=plan_key, hi=hi, lo=lo, symlen=sl,
                words_per_chunk=wpc, unencodable=bad,
                ncoded=ncoded, zrow=zrow, zcol=zcol,
                shard=bucket.shard, device=dev,
            )

        out_buckets = self.executor.run(buckets, upload, dispatch)
        self.stats.plan_hits = self._plans.hits
        self.stats.plan_misses = self._plans.misses
        return EncodedBatch(out_buckets, slices, pending_flags,
                            quarantine=quarantine)

    def encode_to_host(
        self,
        signals: Sequence[np.ndarray],
        tables: TablesArg,
        *,
        domain_ids: Optional[Sequence[int]] = None,
    ) -> List[Container]:
        """Convenience: encode + drain in one call."""
        return self.encode(signals, tables, domain_ids=domain_ids).to_host()

    def close(self) -> None:
        """Join the executor's staging worker."""
        self.executor.close()


# ---------------------------------------------------------------------------
# Process-wide default encoders (codec.encode_device rides the exact one).
# ---------------------------------------------------------------------------
_DEFAULTS: Dict[Tuple[Optional[int], str], BatchEncoder] = {}


def default_encoder(chunk_size: Optional[int] = None,
                    device=None) -> BatchEncoder:
    """Shared encoder per (chunk size, device).  ``None`` chunk size (the
    default) is *exact* mode — bit-identical to the host encoder — which is
    what ``core.codec.encode_device`` rides; pass ``DEFAULT_CHUNK_SIZE`` (or
    any chunk) for the chunk-parallel packer.  Its plan cache keeps up to 32
    recently used DomainTables, and their device buffers, alive for the
    process lifetime."""
    dev = resolve_device(device)
    key = (chunk_size, str(dev))
    enc = _DEFAULTS.get(key)
    if enc is None:
        enc = _DEFAULTS[key] = BatchEncoder(chunk_size=chunk_size, device=dev)
    return enc
