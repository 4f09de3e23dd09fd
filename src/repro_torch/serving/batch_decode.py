"""Batched bucketed decode engine: one bucket decode for N containers.
Port of ``repro/serving/batch_decode.py``.

  * **Shape bucketing.**  A batch's streams are concatenated and padded to
    the policy's bucket edges (power of two by default), so per-container
    quantities ride in device arrays (the symlen sidecar drives all
    offsets) or stay host-side slice metadata.
  * **Concatenated-stream decode.**  SymLen words decode independently, so
    a whole bucket is one word axis, decoded by K2 (``kernels.
    decode_fused``) on the card; container boundaries fall out of the
    prefix sums of the concatenated sidecar.
  * **Persistent decode plans.**  Device tables, the iDCT basis and the
    dequant LUT upload once per (domain, config, device) into an LRU
    :class:`DecodePlan` cache; decoded samples stay on the device inside a
    :class:`DecodedBatch` until ``.to_host()`` drains them.  Each bucket's
    launch shapes come from the tuning cache (``kernels.decode_fused``
    resolves them once per bucket shape and cache epoch).
  * **Shards.**  ``devices=`` splits each (domain, config) group into
    contiguous per-device shards at cost-balanced boundaries
    (:meth:`~repro_torch.tuning.cost_model.CostModel.signal_decode_cost`);
    signals decode independently, so the bytes never depend on the split.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version.
The reference's ``use_kernels`` switch is gone: the tensors' device picks
the arm.  ``decode(..., quarantine=True)`` is the serving contract
(:mod:`repro_torch.serving.quarantine`): a poisoned container is excluded
from its bucket and its typed error rides the batch.
"""
from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.core.codec import validate_container_tables
from repro_torch.core.container import Container
from repro_torch.core.quantize import quant_grid
from repro_torch.kernels.decode_fused import decode_fused
from repro_torch.kernels.idct_dequant import idct_dequant
from repro_torch.serving._plans import (
    TRIVIAL_CODING,
    PlanCache,
    normalize_plan_key,
)
from repro_torch.serving.engine import (
    BucketScheduler,
    PipelineExecutor,
    SubmitBuffer,
    Upload,
    block_until_ready,
    fetch_to_host,
    member_positions,
    p2,
    putter,
    resolve_device,
    serving_devices,
    symlen_bucket,
)
from repro_torch.tuning.cost_model import CostModel, default_cost_model
from repro_torch.tuning.policy import PolicyArg

__all__ = [
    "BatchDecoder",
    "DecodedBatch",
    "DecodePlan",
    "StreamGroup",
    "streams_from_containers",
    "default_decoder",
]

TablesArg = Union[DomainTables, Mapping[int, DomainTables]]


# ---------------------------------------------------------------------------
# Decode plans: per-(domain, config, device) state, uploaded once.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Device-resident decode state for one (domain, config) on one device:
    the Huffman/quant tables, the iDCT basis and the 256-level dequant LUT
    (``quant_grid``), plus the statics that specialize the bucket decode."""

    tables: DeviceTables
    basis: torch.Tensor  # f32[E, N]
    lut: torch.Tensor  # f32[E, 256]
    n: int
    e: int
    l_max: int
    domain_id: int
    device: torch.device
    source: DomainTables  # host tables (kept so cache keys stay alive)
    coding: Tuple[int, int, bool] = TRIVIAL_CODING


def _build_decode_plan(tables: DomainTables, key, device) -> DecodePlan:
    domain_id, n, e, l_max, coding = normalize_plan_key(key)
    # the LUT is computed once on the host and uploaded, so every device
    # dequantizes from the same float values
    lut, _ = quant_grid(tables.quant)
    put = putter(device)
    return DecodePlan(
        tables=tables.device_tables(device),
        basis=put(dct.idct_basis(n, e)),
        lut=put(lut),
        n=n,
        e=e,
        l_max=l_max,
        domain_id=domain_id,
        device=device,
        source=tables,
        coding=coding,
    )


# ---------------------------------------------------------------------------
# The bucket decode contract.
# ---------------------------------------------------------------------------
def _decode_bucket_math(
    words: torch.Tensor,  # int64[Wp]: concatenated + zero-padded words
    sl: torch.Tensor,  # uint8[Wp]: symlen, 0 on padding words
    tables: DeviceTables,
    lut: torch.Tensor,  # f32[E, 256] quant_grid reconstruction LUT
    basis: torch.Tensor,  # f32[E, N]
    v3: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    l_max: int,
    max_symlen: int,
    num_windows: int,  # the bucket-rounded window count
    n: int,
    e: int,
    coding: Tuple[int, int, bool] = TRIVIAL_CODING,
) -> torch.Tensor:
    """Decode one concatenated bucket to windows f32[num_windows, N].

    The arguments are bucket-shaped only: every per-container quantity
    rides in the arrays (the symlen sidecar induces all word/symbol offsets
    through prefix sums) or stays host-side slice metadata.  Padding words
    scatter no symbols, and positions past the true symbol total read as
    level 0, so padding windows decode to ``lut[:, 0] @ basis`` rows that
    the host slicing never reads.  For a v3 coding, ``v3`` carries
    ``idx int32[num_windows * e]`` (-1 = suppressed or padding, expanding
    to the zero bin) and ``seg int32[num_windows]`` (each window's signal
    start; self for padding windows).  ``num_symbols`` is the
    ``num_windows * e`` capacity; ``idx`` never reads past the true coded
    total.  K2 (``kernels.decode_fused``) on CUDA tensors, its plain
    version on CPU tensors, at the tuning cache's launch shapes.
    """
    return decode_fused(
        words, sl, tables, lut, basis, v3,
        l_max=l_max, max_symlen=max_symlen, num_windows=num_windows,
        n=n, e=e, coding=coding,
    )


# ---------------------------------------------------------------------------
# Decoded batches: outputs stay on the device until explicitly drained.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Slice:
    """Where container i's samples live: rows [win_off, win_off + nw) of
    group ``group``'s window tensor, first ``signal_length`` samples."""

    group: int
    win_off: int
    num_windows: int
    signal_length: int


class DecodedBatch:
    """Result of :meth:`BatchDecoder.decode` — device-resident windows.

    ``to_host()`` is the only host sync, and it drains once: every bucket's
    d2h copy starts before any is read, then the windows are sliced back to
    per-container signals (input order preserved).  A second ``to_host()``
    raises.

    A quarantined decode carries a ``poisoned`` record per excluded
    container: its slice is None, ``to_host()`` returns the typed
    :class:`~repro_torch.serving.quarantine.PoisonedContainerError` at that
    position, and ``device_signal(i)`` raises it.
    """

    def __init__(self, groups: List[torch.Tensor],
                 slices: List[Optional[_Slice]], *,
                 poisoned: Optional[Dict[int, Exception]] = None):
        self._groups = groups  # per group: f32[num_windows_p, N]
        self._slices = slices
        self._poisoned: Dict[int, Exception] = dict(poisoned or {})
        self._drained = False

    def __len__(self) -> int:
        return len(self._slices)

    @property
    def device_windows(self) -> List[torch.Tensor]:
        """The raw per-bucket window tensors (on the decoder's device)."""
        return list(self._groups)

    def device_signal(self, i: int) -> torch.Tensor:
        """Container i's reconstructed signal as a device tensor (a view)."""
        if self._drained:
            raise RuntimeError("DecodedBatch was drained by to_host()")
        s = self._slices[i]
        if s is None:
            raise self._poisoned[i]
        rows = self._groups[s.group][s.win_off:s.win_off + s.num_windows]
        return rows.reshape(-1)[: s.signal_length]

    def block_until_ready(self) -> "DecodedBatch":
        """Wait until every bucket's windows are decoded; returns self."""
        block_until_ready(self._groups)
        return self

    def to_host(self) -> List[Any]:
        """Drain the batch: per container, its float32 samples (or, at a
        quarantined position, its typed error)."""
        if self._drained:
            raise RuntimeError("DecodedBatch.to_host() may be called once")
        self._drained = True
        host = fetch_to_host(self._groups)
        self._groups = []  # release the device buffers
        out: List[Any] = []
        for i, s in enumerate(self._slices):
            if s is None:
                out.append(self._poisoned[i])
                continue
            rows = host[s.group][s.win_off:s.win_off + s.num_windows]
            out.append(rows.reshape(-1)[: s.signal_length].copy())
        return out


# ---------------------------------------------------------------------------
# Pre-concatenated streams: the engine's input contract, exposed.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StreamGroup:
    """One (domain, config) group's concatenated SymLen stream, ready for
    one bucket decode.

    ``words`` (uint64 bit patterns as int64) and ``symlen`` (uint8) are
    arrays of one shared length — numpy, host tensors or tensors on the
    decoder's device; trailing padding words must carry ``symlen == 0``.
    ``members`` lists each signal's ``(num_windows, signal_length)`` in
    stream order.  ``max_symlen`` is a host-side bound on the per-word
    symbol count (<= 64).  ``live_words`` is the true word count when the
    producer knows it (padding statistics only).

    v3 groups (plan key with a non-trivial coding) also carry the
    coded-stream expansion: ``v3_idx`` ``int32[num_windows_bucketed * e]``
    and ``v3_seg`` ``int32[num_windows_bucketed]`` from
    ``symlen.v3_expand_index`` at the *scheduler-rounded* window count.
    ``device``/``shard`` place the group's bucket decode (None: the
    decoder's first device).
    """

    plan_key: tuple  # (domain_id, n, e, l_max, coding)
    words: Any
    symlen: Any
    max_symlen: int
    members: Sequence[Tuple[int, int]]  # (num_windows, signal_length)
    live_words: Optional[int] = None
    v3_idx: Any = None
    v3_seg: Any = None
    device: Any = None
    shard: int = 0

    @property
    def total_windows(self) -> int:
        return sum(nw for nw, _ in self.members)


def _zeros(size: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(size, dtype=dtype)


def _stage_container_group(
    members: Sequence[Container],
    key,
    rounder: Callable[[int], int] = p2,
    alloc: Callable[[int, torch.dtype], torch.Tensor] = _zeros,
    device: Any = None,
    shard: int = 0,
) -> StreamGroup:
    """Host-stage one bucket: concatenate member streams into zeroed word
    and symlen buffers padded to the bucket edge (``rounder``), allocated
    by ``alloc`` (pinned buffers when the decoder runs on the card).  For a
    v3 plan key the expansion index/segment arrays are built here too, at
    the rounded window count the dispatch will use.  ``device``/``shard``
    ride the group to its dispatch."""
    total_words = sum(c.num_words for c in members)
    wp = rounder(max(total_words, 1))
    words = alloc(wp, torch.int64)
    sl = alloc(wp, torch.uint8)
    words_np = words.numpy()
    sl_np = sl.numpy()
    woff = 0
    for c in members:
        words_np[woff:woff + c.num_words] = c.words.view(np.int64)
        sl_np[woff:woff + c.num_words] = c.symlen
        woff += c.num_words
    key = normalize_plan_key(key)
    v3_idx = v3_seg = None
    if key[4] != TRIVIAL_CODING:
        nwp = rounder(max(sum(c.num_windows for c in members), 1))
        v3_idx, v3_seg = symlen.v3_expand_index(
            [(c.num_windows, c.zrow, c.zcol) for c in members],
            key[2], total_windows=nwp,
        )
    return StreamGroup(
        plan_key=key,
        words=words,
        symlen=sl,
        max_symlen=max((c.max_symlen for c in members), default=0),
        members=[(c.num_windows, c.signal_length) for c in members],
        live_words=total_words,
        v3_idx=v3_idx,
        v3_seg=v3_seg,
        device=device,
        shard=shard,
    )


def streams_from_containers(
    containers: Sequence[Container],
    policy: PolicyArg = None,
) -> Tuple[List[StreamGroup], List[int]]:
    """Group host containers by plan_key and concatenate their streams (the
    eager public form of the staging :meth:`BatchDecoder.decode` pipelines
    lazily).  Returns the host :class:`StreamGroup` list (group order =
    first appearance; members in input order within a group) plus, per
    input container, its member position in the groups' flattened order."""
    containers = list(containers)
    scheduler = BucketScheduler(policy=policy)
    buckets = scheduler.buckets([c.plan_key for c in containers])
    groups = [
        _stage_container_group(
            [containers[i] for i in b.items], b.key, scheduler.round,
        )
        for b in buckets
    ]
    return groups, member_positions(buckets, len(containers))


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BatchDecoderStats:
    batches: int = 0  # decode() calls
    containers: int = 0  # items handed to decode(), poisoned ones included
    dispatches: int = 0  # bucket decodes launched
    quarantined: int = 0  # containers poisoned out of quarantine=True batches
    plan_hits: int = 0
    plan_misses: int = 0
    # per-dispatch padding/occupancy records (bounded history)
    bucket_pad: "deque[dict]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024)
    )


class BatchDecoder:
    """Decodes many containers in one bucket decode per (domain, config).

    Usage::

        dec = BatchDecoder()                     # the card; or device="cpu"
        batch = dec.decode(containers, tables)   # tables: DomainTables, or
                                                 # {domain_id: DomainTables}
        signals = batch.to_host()                # one sync, input order

    Containers are grouped by :attr:`Container.plan_key`; each group's
    streams are concatenated word-wise and padded to the ``policy`` ladder's
    bucket edges, then decoded by one K2 launch (``kernels.decode_fused``).
    ``pipeline`` double-buffers host staging/upload against device compute.
    With no ``device`` the decoder runs on the card and raises if there is
    none; ``device="cpu"`` runs the plain PyTorch versions.  ``devices``
    shards each group over several devices (``"auto"``: every visible
    card; a sequence, repeats allowed), split at cost-balanced boundaries
    over ``cost_model``'s per-container decode cost; ``device`` and
    ``devices`` together must agree.  Policy, pipelining and sharding
    change scheduling only, never bytes.
    """

    def __init__(
        self,
        *,
        device=None,
        devices=None,
        plan_cache_size: int = 32,
        pipeline: bool = True,
        prefetch: int = 2,
        policy: PolicyArg = None,
        cost_model: Optional[CostModel] = None,
    ):
        self.devices = serving_devices(devices, device)
        self.device = self.devices[0]
        self._plans = PlanCache(_build_decode_plan, plan_cache_size)
        self.scheduler = BucketScheduler(devices=self.devices, policy=policy)
        self.executor = PipelineExecutor(
            self.devices, pipeline=pipeline, prefetch=prefetch
        )
        self.cost_model = (
            cost_model if cost_model is not None
            else default_cost_model(self.device)
        )
        self.stats = BatchDecoderStats()
        self._pending = SubmitBuffer()

    # -- incremental submission ---------------------------------------------
    def submit(self, container: Container) -> int:
        """Queue one container for the next :meth:`flush` (thread-safe);
        returns its index in flush order."""
        return self._pending.submit(container)

    @property
    def pending(self) -> int:
        """Containers submitted since the last flush."""
        return len(self._pending)

    def flush(self, tables: TablesArg, *,
              quarantine: bool = False) -> DecodedBatch:
        """Decode everything submitted since the last flush as one batch
        (submission order).  An empty flush is a no-op empty batch."""
        return self.decode(self._pending.take(), tables,
                           quarantine=quarantine)

    # -- plan management ------------------------------------------------------
    @staticmethod
    def _tables_for(key, tables: TablesArg) -> DomainTables:
        if isinstance(tables, DomainTables):
            return tables
        domain_id = key[0]
        try:
            return tables[domain_id]
        except KeyError:
            raise KeyError(
                f"no DomainTables registered for domain_id={domain_id}"
            ) from None

    def _plan_for_key(self, key, tables: TablesArg,
                      device=None) -> DecodePlan:
        key = normalize_plan_key(key)
        tab = self._tables_for(key, tables)
        validate_container_tables(key, tab)
        return self._plans.get(
            tab, key, self.device if device is None else device)

    def plan_for(self, container: Container, tables: TablesArg,
                 device=None) -> DecodePlan:
        return self._plan_for_key(container.plan_key, tables, device)

    # -- fixed-rate (entropy-off) decode -------------------------------------
    def decode_fixed(
        self,
        levels,
        tables: DomainTables,
        *,
        length: Optional[int] = None,
        dtype=torch.float32,
    ) -> torch.Tensor:
        """Inverse of the reference's ``BatchEncoder.encode_fixed``:
        ``uint8[..., W, E]`` levels -> ``[..., T]`` samples (``T = W * n``,
        trimmed to ``length`` when given), on this decoder's device.

        Dequantizes inline and multiplies by the iDCT basis: K3
        (``kernels.idct_dequant``) on the card, its plain version on the
        CPU.  Tables and basis ride the persistent :class:`DecodePlan`.
        """
        cfg = tables.config
        key = (tables.domain_id, cfg.n, cfg.e, cfg.l_max, cfg.coding)
        plan = self._plan_for_key(key, tables)
        levels = torch.as_tensor(levels, device=self.device)
        if levels.shape[-1] != plan.e:
            raise ValueError(
                f"levels last axis {levels.shape[-1]} != domain E={plan.e}"
            )
        flat = levels.reshape(-1, plan.e)
        windows = idct_dequant(flat, plan.tables.quant, plan.basis)
        x = windows.reshape(levels.shape[:-2] + (-1,))
        self.stats.dispatches += 1
        if length is not None:
            x = x[..., :length]
        return x.to(dtype)

    # -- the batched decode -----------------------------------------------------
    def decode(
        self, containers: Sequence[Any], tables: TablesArg, *,
        quarantine: bool = False,
    ) -> DecodedBatch:
        """Decode a (possibly mixed-domain, mixed-length) batch of
        containers.  Returns a :class:`DecodedBatch`; nothing is synced to
        the host here.

        ``quarantine=True`` is the serving contract: items may be raw bytes
        or parsed :class:`Container` objects, each is wire-format and deep
        validated against ``tables`` before staging, and a poisoned item is
        excluded from its bucket instead of raising batch-wide — the clean
        ones decode exactly as in a clean batch and the poisoned slot's
        :class:`~repro_torch.serving.quarantine.PoisonedContainerError`
        rides the batch.  Without quarantine every item must be a
        :class:`Container` and any fault raises (the offline contract).
        """
        containers = list(containers)
        total = len(containers)
        self.stats.batches += 1
        self.stats.containers += total
        poisoned: Dict[int, Exception] = {}
        clean_pos = list(range(total))
        if quarantine:
            from repro_torch.serving.quarantine import validate_or_poison

            clean_pos, clean = [], []
            for i, item in enumerate(containers):
                c, err = validate_or_poison(item, i, tables)
                if err is not None:
                    poisoned[i] = err
                else:
                    clean_pos.append(i)
                    clean.append(c)
            self.stats.quarantined += len(poisoned)
            containers = clean
        if not containers:
            return DecodedBatch([], [None] * total, poisoned=poisoned)
        if isinstance(tables, DomainTables):
            # a single DomainTables means "decode everything with these" —
            # only coherent for a single-domain batch
            domains = {c.domain_id for c in containers}
            if len(domains) > 1:
                raise ValueError(
                    f"mixed-domain batch (domain_ids={sorted(domains)}) "
                    "needs a {domain_id: DomainTables} mapping, not a "
                    "single DomainTables"
                )
        # with several shards, split each group at cost-balanced (not
        # equal-count) boundaries over the model's per-container decode
        # cost — container metadata carries everything the model needs
        item_costs = None
        if self.scheduler.num_shards > 1:
            item_costs = [
                self.cost_model.signal_decode_cost(
                    c.num_words, c.num_windows,
                    e=c.e, n=c.n, max_symlen=symlen_bucket(c.max_symlen),
                )
                for c in containers
            ]
        buckets = self.scheduler.buckets(
            [c.plan_key for c in containers], item_costs=item_costs
        )
        member_pos = member_positions(buckets, len(containers))
        # staging stays lazy: the executor's worker runs the host concat +
        # upload of bucket k+1 while bucket k's kernels run
        lazy = [
            functools.partial(
                _stage_container_group,
                [containers[i] for i in b.items], b.key,
                self.scheduler.round, self.executor.host_buffer,
                b.device, b.shard,
            )
            for b in buckets
        ]
        batch = self.decode_streams(lazy, tables)
        # decode_streams orders slices by (group, member); restore the
        # caller's container order
        slices: List[Optional[_Slice]] = [None] * total
        for j, i in enumerate(clean_pos):
            slices[i] = batch._slices[member_pos[j]]
        return DecodedBatch(batch._groups, slices, poisoned=poisoned)

    def decode_streams(
        self,
        groups: Sequence[Union[StreamGroup, Callable[[], StreamGroup]]],
        tables: TablesArg,
    ) -> DecodedBatch:
        """Decode pre-concatenated bucket streams: one bucket decode per
        :class:`StreamGroup` (or zero-argument callable producing one — the
        executor's staging contract), on the group's ``device`` (the
        decoder's first device where it has none).  Signals come back group
        by group, in each group's ``members`` order."""
        groups = list(groups)

        def upload(g) -> Tuple[StreamGroup, Upload]:
            grp = g() if callable(g) else g
            dev = self.device if grp.device is None else grp.device
            # plan prefetch: tables + basis + LUT upload from the staging
            # worker, so the first dispatch on each device doesn't pay it
            self._plan_for_key(tuple(grp.plan_key), tables, dev)
            up = self.executor.put(
                [grp.words, grp.symlen, grp.v3_idx, grp.v3_seg], dev
            )
            return grp, up

        def dispatch(g, staged) -> Tuple[torch.Tensor, StreamGroup]:
            grp, up = staged
            dev = self.device if grp.device is None else grp.device
            plan = self._plan_for_key(tuple(grp.plan_key), tables, dev)
            words, sl, idx, seg = up.wait()
            if sl.dtype != torch.uint8:  # symlen <= 64: one byte holds it
                sl = sl.to(torch.uint8)
            num_windows = self.scheduler.round(max(grp.total_windows, 1))
            v3 = None
            if plan.coding != TRIVIAL_CODING:
                if idx is None or seg is None:
                    raise ValueError(
                        "v3-coded StreamGroup is missing its v3_idx/v3_seg "
                        "expansion arrays (build them with "
                        "symlen.v3_expand_index at the scheduler-rounded "
                        "window count)"
                    )
                v3 = (idx, seg)
            windows = _decode_bucket_math(
                words, sl, plan.tables, plan.lut, plan.basis, v3,
                l_max=plan.l_max,
                max_symlen=symlen_bucket(grp.max_symlen),
                num_windows=num_windows,
                n=plan.n,
                e=plan.e,
                coding=plan.coding,
            )
            self.stats.dispatches += 1
            self.stats.bucket_pad.append({
                "plan_key": tuple(grp.plan_key),
                "shard": grp.shard,
                "policy": self.scheduler.policy.name,
                "words": grp.live_words,
                "words_padded": int(words.shape[0]),
                "windows": grp.total_windows,
                "windows_padded": num_windows,
            })
            return windows, grp

        results = self.executor.run(groups, upload, dispatch)

        out_groups: List[torch.Tensor] = []
        slices: List[_Slice] = []
        for g, (windows, grp) in enumerate(results):
            win_off = 0
            for num_windows, signal_length in grp.members:
                slices.append(_Slice(
                    group=g,
                    win_off=win_off,
                    num_windows=num_windows,
                    signal_length=signal_length,
                ))
                win_off += num_windows
            out_groups.append(windows)

        self.stats.plan_hits = self._plans.hits
        self.stats.plan_misses = self._plans.misses
        return DecodedBatch(out_groups, slices)

    def decode_to_host(
        self, containers: Sequence[Container], tables: TablesArg
    ) -> List[np.ndarray]:
        """Convenience: decode + drain in one call."""
        return self.decode(containers, tables).to_host()

    def close(self) -> None:
        """Join the executor's staging worker."""
        self.executor.close()


# ---------------------------------------------------------------------------
# Process-wide default decoders (codec.decode_device rides these).
# ---------------------------------------------------------------------------
_DEFAULTS: Dict[str, BatchDecoder] = {}


def default_decoder(device=None) -> BatchDecoder:
    dev = resolve_device(device)
    dec = _DEFAULTS.get(str(dev))
    if dec is None:
        dec = _DEFAULTS[str(dev)] = BatchDecoder(device=dev)
    return dec
