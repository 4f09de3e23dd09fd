"""Device-resident transcode pipeline: decode -> re-encode, no host round
trip.  Port of ``repro/serving/transcode.py``.

FPTC's asymmetric design puts batch re-compression on the server: archives
are migrated between configs — tighter quantization for cold storage, a
new window size ``n`` or coefficient count ``e`` after a recalibration, a
v2 -> v3 upgrade.  Composing the two engines through host containers pays
a device -> host drain of every decoded signal, a host re-stack and a
re-upload of every encode bucket.  :class:`Transcoder` keeps the whole
chain on the device:

  * **Source streams.**  A host archive (``Container`` list) stages through
    the decoder's own lazy bucket staging; a device-resident
    :class:`~repro_torch.serving.batch_encode.EncodedBatch` feeds its chunk
    parts through ``core.symlen.stitch_chunk_parts`` — a device gather into
    decoder-shaped streams, sized by the host-computable
    :func:`~repro_torch.core.symlen.chunk_words_bound` (no sync on the true
    word counts; ``exact_capacity=True`` trades one pre-decode sync for
    tighter streams).  The stitched uint32 halves become the decoder's
    int64 words on the device.
  * **Decode.**  :meth:`BatchDecoder.decode_streams`: one K2 per bucket.
  * **Re-stage on the device.**  The decoded windows are flattened once
    (padded by the widest target bucket, rounded by the scheduler) and each
    target bucket reads its rows as runs of that flat tensor
    (:class:`~repro_torch.serving.engine.GatherStage`): on the card the
    gather runs inside the bucket's encode (``encode_levels_gather``), so
    the signal matrix is never materialized.  Row layout, zero padding and
    chunk size are the encoder's own (:meth:`BatchEncoder.encode_staged`),
    which is what makes the output byte-identical to draining the decoded
    signals and re-encoding them.  The last bucket to read the flat tensor
    drops the last reference to it.
  * **One drain.**  The result is a normal :class:`EncodedBatch`; nothing
    waits on the device until its ``to_host()``.  Between decode and
    re-encode there is no device -> host transfer and no host sync
    (``torch.cuda.set_sync_debug_mode("error")`` holds it on the card).
    Building a plan — the first use of a table pairing — uploads the
    tables with ordinary copies, as the engines' plan builders do.

With several shard devices (``devices=``) every signal re-encodes on the
device that decoded it: each encode bucket is pinned to its signals' decode
shard (``encode_staged(shard_ids=, shard_devices=)``), each shard's decoded
windows are flattened on their own device, and an ``EncodedBatch`` source
stitches and decodes each shard's parts where they lie.

``core.codec.transcode`` is a container-of-one wrapper over this engine in
exact packing mode.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import symlen
from repro_torch.core.calibration import DomainTables
from repro_torch.core.container import Container
from repro_torch.serving._plans import TRIVIAL_CODING, PlanCache, TranscodePlan
from repro_torch.serving.batch_decode import (
    BatchDecoder,
    StreamGroup,
    _stage_container_group,
)
from repro_torch.serving.batch_encode import (
    DEFAULT_CHUNK_SIZE,
    BatchEncoder,
    EncodedBatch,
)
from repro_torch.serving.engine import (
    BucketScheduler,
    GatherStage,
    SubmitBuffer,
    fetch_to_host,
    member_positions,
    resolve_device,
    serving_devices,
)
from repro_torch.tuning.policy import PolicyArg

__all__ = ["Transcoder", "TranscoderStats", "TranscodePlan",
           "default_transcoder"]

TablesArg = Union[DomainTables, Mapping[int, DomainTables]]
Source = Union[Sequence[Container], EncodedBatch]

_I32_MAX = np.iinfo(np.int32).max


def _signal_words_bound(
    num_symbols: int, chunk_size: int, l_max: int
) -> int:
    """Host-side bound on one signal's packed word count under chunking."""
    full, rem = divmod(int(num_symbols), int(chunk_size))
    return full * symlen.chunk_words_bound(chunk_size, l_max) + (
        symlen.chunk_words_bound(rem, l_max)
    )


@dataclasses.dataclass
class TranscoderStats:
    batches: int = 0
    signals: int = 0
    stitches: int = 0  # device-side chunk-part stitches
    capacity_syncs: int = 0  # exact_capacity pre-decode word-count syncs
    plan_hits: int = 0
    plan_misses: int = 0
    quarantined: int = 0  # signals poisoned out of quarantine=True batches


class Transcoder:
    """Re-encodes batches under a new (domain, config) without leaving the
    device.

    Usage::

        tc = Transcoder()                       # the card; or device="cpu"
        batch = tc.transcode(containers, src_tables, dst_tables)
        migrated = batch.to_host()              # the only host sync

    ``source`` is a container archive or a device-resident
    :class:`EncodedBatch` fresh off a :class:`BatchEncoder` — whose chunk
    parts are then stitched into decoder streams on the device, and which
    is *consumed* (a later ``to_host()`` on it raises; drain the transcode
    result instead).  Output order is source order.  ``dst_domain_ids``
    routes each signal's target tables when ``dst_tables`` is a mapping; it
    defaults to the source domain ids.  ``exact_capacity=True`` opts into
    one pre-decode sync on the true stitched word counts (EncodedBatch
    sources only).  None of these change the bytes produced.  With no
    ``device`` the transcoder runs on the card and raises if there is
    none; ``device="cpu"`` runs the plain PyTorch versions.  ``devices``
    shards both halves over several devices (the decoder's split; each
    signal re-encodes on the device that decoded it).
    """

    def __init__(
        self,
        *,
        chunk_size: Optional[int] = DEFAULT_CHUNK_SIZE,
        device=None,
        devices=None,
        decoder: Optional[BatchDecoder] = None,
        encoder: Optional[BatchEncoder] = None,
        plan_cache_size: int = 32,
        pipeline: bool = True,
        prefetch: int = 2,
        exact_capacity: bool = False,
        policy: PolicyArg = None,
    ):
        if decoder is None or encoder is None:
            devices = serving_devices(devices, device)
        self.decoder = decoder or BatchDecoder(
            devices=devices, pipeline=pipeline, prefetch=prefetch,
            policy=policy,
        )
        self.encoder = encoder or BatchEncoder(
            chunk_size=chunk_size, devices=devices, pipeline=pipeline,
            prefetch=prefetch, policy=policy,
        )
        if self.decoder.devices != self.encoder.devices:
            raise ValueError(
                "decoder and encoder must shard over the same devices — a "
                "signal re-encodes where it was decoded (got "
                f"{[str(d) for d in self.decoder.devices]} vs "
                f"{[str(d) for d in self.encoder.devices]})"
            )
        if self.decoder.scheduler.policy != self.encoder.scheduler.policy:
            # the flat gather pad is sized by the encode bucket ladder
            raise ValueError(
                "decoder and encoder must use the same bucket policy (got "
                f"{self.decoder.scheduler.policy.name!r} vs "
                f"{self.encoder.scheduler.policy.name!r})"
            )
        self.device = self.decoder.device
        self.devices = self.decoder.devices
        self.exact_capacity = exact_capacity
        self._plans = PlanCache(self._build_plan, plan_cache_size)
        self.stats = TranscoderStats()
        self._pending = SubmitBuffer()

    # -- incremental submission ----------------------------------------------
    def submit(
        self, container: Container, dst_domain_id: Optional[int] = None
    ) -> int:
        """Queue one container (or raw bytes, for a quarantined flush) for
        the next :meth:`flush` (thread-safe).  ``dst_domain_id`` routes the
        re-encode tables when the flush passes a mapping (None = keep the
        source domain id).  Returns its index in flush order."""
        return self._pending.submit((container, dst_domain_id))

    @property
    def pending(self) -> int:
        """Containers submitted since the last flush."""
        return len(self._pending)

    def flush(
        self,
        src_tables: TablesArg,
        dst_tables: TablesArg,
        *,
        quarantine: bool = False,
    ) -> EncodedBatch:
        """Transcode everything submitted since the last flush as one batch
        (submission order).  An empty flush is a no-op empty batch."""
        items = self._pending.take()
        containers = [c for c, _ in items]
        if all(d is None for _, d in items):
            dst_ids = None  # transcode()'s own defaulting
        else:
            # fill unrouted members as transcode()'s default would: the
            # single tables' own id, or the source domain id
            single = (
                dst_tables if isinstance(dst_tables, DomainTables) else None
            )

            def _src_domain(c) -> int:
                if isinstance(c, Container):
                    return c.domain_id
                try:  # quarantine admits raw bytes; route off the header
                    return Container.peek(c).domain_id
                except Exception:
                    return 0  # unparseable: poisoned before routing matters

            dst_ids = [
                d if d is not None
                else (single.domain_id if single is not None
                      else _src_domain(c))
                for c, d in items
            ]
        return self.transcode(
            containers, src_tables, dst_tables, dst_domain_ids=dst_ids,
            quarantine=quarantine,
        )

    @property
    def scheduler(self) -> BucketScheduler:
        """The shard scheduler both halves of the pipeline follow."""
        return self.decoder.scheduler

    # -- plan pairing ----------------------------------------------------------
    def _build_plan(self, tables, key, device) -> TranscodePlan:
        (src_tab, dst_tab), (src_key, dst_key) = tables, key
        return TranscodePlan(
            decode=self.decoder._plan_for_key(src_key, src_tab, device),
            encode=self.encoder.plan_for(dst_tab, device),
            src_key=src_key,
            dst_key=dst_key,
        )

    def plan_for(
        self, src_tables: DomainTables, dst_tables: DomainTables,
        device=None,
    ) -> TranscodePlan:
        src_cfg, dst_cfg = src_tables.config, dst_tables.config
        src_key = (src_tables.domain_id, src_cfg.n, src_cfg.e,
                   src_cfg.l_max, src_cfg.coding)
        dst_key = (dst_tables.domain_id, dst_cfg.n, dst_cfg.e,
                   dst_cfg.l_max, dst_cfg.coding)
        return self._plans.get(
            (src_tables, dst_tables), (src_key, dst_key),
            self.device if device is None else device,
        )

    # -- source normalization ------------------------------------------------
    def _streams_from_encoded(
        self, batch: EncodedBatch, src_tables: TablesArg
    ) -> Tuple[List[StreamGroup], List[int], List[Tuple[int, tuple]],
               List[tuple], List[int]]:
        """Stitch an EncodedBatch's chunk parts into decoder streams on the
        device, each shard's parts on their own device.  Returns (groups,
        per-signal member position, per-signal (length, src plan key) in
        source order, pending gap flags, per-signal shard ids).  Does not
        consume the batch — transcode() marks it consumed only once the
        whole pipeline is committed, so a failed transcode (bad routing,
        missing tables) leaves the source drainable."""
        parts = batch.device_parts()
        for p in parts:
            key = tuple(p.plan_key)
            if len(key) == 5 and tuple(key[4]) != TRIVIAL_CODING:
                # a v3-coded SOURCE stream needs its per-signal ncoded /
                # zero-plane bitmaps on host to build the decode expansion
                # (symlen.v3_expand_index) — a sync this zero-transfer path
                # refuses by contract.  Drain the batch and feed the host
                # containers instead (the container path decodes v3 fine);
                # v2 -> v3 *upgrades* (v3 on the TARGET) are unaffected.
                raise NotImplementedError(
                    "device-resident transcode from a v3-coded EncodedBatch "
                    f"source (coding={tuple(key[4])}) is not supported — "
                    "drain it with to_host() and transcode the containers, "
                    "or keep the source coding trivial"
                )
        slices = batch.signal_slices()
        # signals per bucket, in row order (== stream symbol order)
        per_bucket: List[List] = [[] for _ in parts]
        for s in slices:
            per_bucket[s.bucket].append(s)
        for rows in per_bucket:
            rows.sort(key=lambda s: s.row)

        # merge the source buckets of one (plan key, shard) into one decode
        # group, as the container path groups them, each shard's stream
        # staying on its device
        key_order, by_key = BucketScheduler.group_by(
            [(tuple(p.plan_key), p.shard) for p in parts]
        )
        # exact_capacity: ONE batched pre-decode sync on the true per-chunk
        # word counts, so the stitched streams are sized by what was packed
        # instead of the l_max worst case; the bytes are the same either way
        wpc_host = None
        if self.exact_capacity:
            wpc_host = fetch_to_host([p.words_per_chunk for p in parts])
            self.stats.capacity_syncs += 1

        groups: List[StreamGroup] = []
        member_pos_by_sig: Dict[Tuple[int, int], int] = {}
        pos = 0
        for key, shard in key_order:
            l_max = key[3]
            tab = self.decoder._tables_for(key, src_tables)
            lengths = np.asarray(tab.book.lengths)
            nonzero = lengths[lengths > 0]
            min_len = int(nonzero.min()) if nonzero.size else 1
            max_sl = min(symlen.WORD_BITS // max(min_len, 1),
                         symlen.WORD_BITS)
            words, sls = [], []
            members: List[Tuple[int, int]] = []
            device = None
            for b in by_key[(key, shard)]:
                p = parts[b]
                device = p.device
                if wpc_host is not None:
                    cap = int(np.sum(wpc_host[b]))
                else:
                    cap = sum(
                        _signal_words_bound(
                            s.num_windows * s.e, p.chunk_size, l_max
                        )
                        for s in per_bucket[b]
                    )
                c = p.chunk_size
                shi, slo, ssl, _ = symlen.stitch_chunk_parts(
                    p.hi.reshape(-1, c),
                    p.lo.reshape(-1, c),
                    p.symlen.reshape(-1, c),
                    p.words_per_chunk.reshape(-1),
                    capacity=symlen.stitch_capacity(cap),
                )
                self.stats.stitches += 1
                # the decoder's word format, converted on the device
                words.append(symlen.halves_to_words(shi, slo))
                sls.append(ssl.to(torch.uint8))
                for s in per_bucket[b]:
                    members.append((s.num_windows, s.signal_length))
                    member_pos_by_sig[(s.bucket, s.row)] = pos
                    pos += 1
            groups.append(StreamGroup(
                plan_key=key,
                words=words[0] if len(words) == 1 else torch.cat(words),
                symlen=sls[0] if len(sls) == 1 else torch.cat(sls),
                max_symlen=max_sl,
                members=members,
                device=device,
                shard=shard,
            ))

        member_pos = [member_pos_by_sig[(s.bucket, s.row)] for s in slices]
        meta = [
            (s.signal_length, (s.domain_id, s.n, s.e, s.l_max, s.coding))
            for s in slices
        ]
        # inherit the source's own pending flags too: a chained transcode
        # must not launder an upstream histogram-gap batch into a clean
        # drain
        flags = list(batch._pending_flags) + [
            (p.plan_key, p.unencodable) for p in parts
        ]
        shard_ids = [parts[s.bucket].shard for s in slices]
        return groups, member_pos, meta, flags, shard_ids

    # -- the transcode -----------------------------------------------------------
    def transcode(
        self,
        source: Source,
        src_tables: TablesArg,
        dst_tables: TablesArg,
        *,
        dst_domain_ids: Optional[Sequence[int]] = None,
        quarantine: bool = False,
    ) -> EncodedBatch:
        """Decode ``source`` under ``src_tables`` and re-encode under
        ``dst_tables``, on the device end to end.

        Returns an :class:`EncodedBatch` (source order); nothing waits on
        the device here — drain it once with ``to_host()``.

        ``quarantine=True`` (container sources): items may be raw bytes or
        :class:`Container` objects; each is validated against
        ``src_tables`` at staging and a poisoned item is excluded from its
        bucket instead of raising batch-wide — its typed error rides the
        returned batch's drain.  EncodedBatch sources are device-resident
        output of the engines (no wire format to corrupt), so only the
        per-signal histogram-gap demotion applies to them.
        """
        src_batch: Optional[EncodedBatch] = None
        poisoned: Dict[int, Exception] = {}
        clean_pos: List[int] = []
        total = 0
        if isinstance(source, EncodedBatch):
            src_batch = source
            groups, member_pos, meta, flags, shard_ids = (
                self._streams_from_encoded(source, src_tables)
            )
            # placement follows the data: the source's shard ids may come
            # from another scheduler (a sharded encoder feeding a
            # one-device transcoder), so its parts' devices decide where
            # each shard runs
            shard_devices = {
                g.shard: self.device if g.device is None else g.device
                for g in groups
            }
            group_shards = [g.shard for g in groups]
        else:
            containers = list(source)
            total = len(containers)
            clean_pos = list(range(total))
            if quarantine:
                from repro_torch.serving.quarantine import validate_or_poison

                clean_pos, clean = [], []
                for i, item in enumerate(containers):
                    c, err = validate_or_poison(item, i, src_tables)
                    if err is not None:
                        poisoned[i] = err
                    else:
                        clean_pos.append(i)
                        clean.append(c)
                self.stats.quarantined += len(poisoned)
                containers = clean
                if dst_domain_ids is not None:
                    dst_domain_ids = [dst_domain_ids[i] for i in clean_pos]
                if not containers:
                    self.stats.batches += 1
                    return EncodedBatch(
                        [], [None] * total, (),
                        poisoned=poisoned, quarantine=True,
                    )
            buckets = self.scheduler.buckets(
                [c.plan_key for c in containers]
            )
            member_pos = member_positions(buckets, len(containers))
            # lazy staging: the decoder's worker concatenates and uploads
            # bucket k+1 while bucket k decodes
            groups = [
                functools.partial(
                    _stage_container_group,
                    [containers[i] for i in b.items], b.key,
                    self.scheduler.round, self.decoder.executor.host_buffer,
                    b.device, b.shard,
                )
                for b in buckets
            ]
            meta = [(c.signal_length, c.plan_key) for c in containers]
            flags = []
            shard_ids = [0] * len(containers)
            shard_devices = {}
            for b in buckets:
                shard_devices[b.shard] = b.device
                for i in b.items:
                    shard_ids[i] = b.shard
            group_shards = [b.shard for b in buckets]
        self.stats.batches += 1
        self.stats.signals += len(meta)

        lengths = [length for length, _ in meta]
        if dst_domain_ids is None and not isinstance(
            dst_tables, DomainTables
        ):
            dst_domain_ids = [key[0] for _, key in meta]

        # resolve the (source, target) plan pairings up front, and the
        # widest target bucket: it sizes the one pad that keeps every row
        # gather of the plain version in bounds
        dst_doms = (
            [dst_tables.domain_id] * len(meta)
            if isinstance(dst_tables, DomainTables) else list(dst_domain_ids)
        )
        max_width = 1
        for (length, src_key), dst_dom, shard in zip(
            meta, dst_doms, shard_ids
        ):
            src_tab = self.decoder._tables_for(src_key, src_tables)
            dst_tab = self.encoder._tables_for(dst_dom, dst_tables)
            self.plan_for(src_tab, dst_tab, shard_devices[shard])
            n_dst = dst_tab.config.n
            # the ENCODER's bucket rounding, exactly: a bucket's rows are
            # wp * n samples wide
            max_width = max(
                max_width,
                self.encoder.scheduler.round(
                    max(-(-length // n_dst), 1)
                ) * n_dst,
            )
        self.stats.plan_hits = self._plans.hits
        self.stats.plan_misses = self._plans.misses

        decoded = self.decoder.decode_streams(groups, src_tables)

        # flatten each shard's decoded window tensors once, on its device,
        # zero-padded by the widest bucket and then up to a bucket edge
        # (the reference's layout); each signal's samples are one
        # contiguous run of its shard's flat tensor
        tensors = decoded.device_windows
        starts = np.zeros((len(meta),), dtype=np.int64)
        flats: Dict[int, Optional[torch.Tensor]] = {}
        remaining: Dict[int, int] = {}
        if tensors:
            bases = [0] * len(tensors)
            for shard in sorted(set(group_shards)):
                gidx = [g for g, sh in enumerate(group_shards) if sh == shard]
                off = 0
                for g in gidx:
                    bases[g] = off
                    off += tensors[g].numel()
                if off + max_width > _I32_MAX:
                    # gather starts ride int32: a flat tensor past 2^31
                    # samples would wrap offsets negative and re-encode the
                    # wrong samples silently — refuse
                    raise ValueError(
                        f"shard {shard}'s decoded windows span "
                        f"{off + max_width} samples, past the int32 gather "
                        "range — transcode the archive in smaller batches"
                    )
                pad = torch.zeros(
                    self.scheduler.round(off + max_width) - off,
                    dtype=torch.float32, device=tensors[gidx[0]].device,
                )
                flats[shard] = torch.cat(
                    [tensors[g].reshape(-1) for g in gidx] + [pad])
                remaining[shard] = 0
            widths = [t.shape[1] for t in tensors]
            for i in range(len(meta)):
                s = decoded._slices[member_pos[i]]
                starts[i] = bases[s.group] + s.win_off * widths[s.group]
                remaining[shard_ids[i]] += 1
        # the windows live on in the flat copies only
        del decoded, tensors

        def stage(idxs, kp: int, wp: int, n: int, device) -> GatherStage:
            shard = shard_ids[idxs[0]]  # a bucket's rows share one shard
            st = np.zeros((kp,), dtype=np.int32)
            ln = np.zeros((kp,), dtype=np.int32)
            for row, i in enumerate(idxs):
                st[row] = starts[i]
                ln[row] = lengths[i]
            remaining[shard] -= len(idxs)
            last = remaining[shard] == 0
            out = GatherStage(flat=flats[shard], starts=st, lens=ln,
                              last_use=last)
            if last:  # the last bucket reading the flat tensor owns it now
                flats[shard] = None
            return out

        out = self.encoder.encode_staged(
            lengths, dst_tables,
            domain_ids=dst_domain_ids,
            stage=stage,
            pending_flags=flags,
            shard_ids=shard_ids,
            shard_devices=shard_devices,
            quarantine=quarantine,
        )
        if quarantine and src_batch is None and total:
            # restore source positions: poisoned slots hold their typed
            # error, clean slots keep their bucket/row slices
            full = [None] * total
            for j, i in enumerate(clean_pos):
                full[i] = out._slices[j]
            out = EncodedBatch(
                out._buckets, full, out._pending_flags,
                poisoned=poisoned, quarantine=True,
            )
        if src_batch is not None:
            # commit point: mark the source consumed only NOW, so any
            # earlier failure (bad routing, missing tables) left it
            # drainable
            src_batch._mark_consumed(
                "its device buffers were donated to a Transcoder — drain "
                "the transcode result instead"
            )
        return out

    def transcode_to_host(
        self,
        source: Source,
        src_tables: TablesArg,
        dst_tables: TablesArg,
        *,
        dst_domain_ids: Optional[Sequence[int]] = None,
    ) -> List[Container]:
        """Convenience: transcode + the single drain in one call."""
        return self.transcode(
            source, src_tables, dst_tables, dst_domain_ids=dst_domain_ids
        ).to_host()

    def close(self) -> None:
        """Join both engines' staging workers."""
        self.decoder.close()
        self.encoder.close()


# ---------------------------------------------------------------------------
# Process-wide default transcoders (codec.transcode rides the exact one).
# ---------------------------------------------------------------------------
_DEFAULTS: Dict[Tuple[Optional[int], str], Transcoder] = {}


def default_transcoder(chunk_size: Optional[int] = None,
                       device=None) -> Transcoder:
    """Shared transcoder per (chunk size, device).  ``None`` chunk size (the
    default) is *exact* packing mode — what ``core.codec.transcode`` rides;
    pass ``DEFAULT_CHUNK_SIZE`` (or any chunk) for chunk-parallel packing.
    Its plan caches keep recently used tables, and their device buffers,
    alive for the process lifetime."""
    dev = resolve_device(device)
    key = (chunk_size, str(dev))
    tc = _DEFAULTS.get(key)
    if tc is None:
        tc = _DEFAULTS[key] = Transcoder(chunk_size=chunk_size, device=dev)
    return tc
