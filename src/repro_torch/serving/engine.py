"""Shared serving-engine layer: device resolution, bucket scheduling,
multi-device shard splits and pipelined execution.  Port of
``repro/serving/engine.py``.

  * :func:`resolve_device` — the device entry points' rule: no device means
    the card, and no card means an error, never a quiet CPU run;
    :func:`serving_devices` — an engine's shard devices under that rule.
  * :class:`BucketScheduler` — grouping (first-appearance key order, members
    in input order), bucket-edge rounding under a
    :class:`~repro_torch.tuning.policy.BucketPolicy`, and shard assignment:
    with more than one shard each key group's members split into
    contiguous per-device shards, equal-count or balanced over per-item
    costs (:func:`_split_contiguous`, :func:`_split_balanced`).  Signals are
    independent, so a split needs no collective: each shard's bucket runs
    on its own device and stays there until the one drain.
  * :class:`PipelineExecutor` — per-bucket stage(upload) -> stage(dispatch)
    with double buffering.  On CUDA each bucket is staged into pinned host
    buffers and copied with ``non_blocking=True`` on a side stream of its
    own device; an event recorded after the copies is waited on by that
    device's compute stream before the bucket's kernels, so bucket k+1's
    upload overlaps bucket k's kernels.  One executor serves every shard
    device of an engine (one side stream per distinct device).
  * :func:`fetch_to_host` — the drain: every d2h copy starts (into pinned
    buffers) before any is read; :func:`fetch_to_host_stitched` overlaps a
    per-bucket host stitch with the later buckets' copies.
  * :class:`GatherStage` — the staging contract for device-resident encode
    staging: a bucket's rows as runs of a flat device tensor, gathered
    inside the bucket's encode (the transcoder's path).
  * :func:`putter` — the one placement idiom: host data to an explicit
    device without a host sync.

Pipelining and sharding change *when* and *where* buckets run — never what
they produce.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Dict,
    Hashable,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch.tuning.policy import BucketPolicy, PolicyArg

__all__ = [
    "MAX_SYMLEN_CAP",
    "p2",
    "symlen_bucket",
    "resolve_device",
    "serving_devices",
    "Bucket",
    "member_positions",
    "BucketScheduler",
    "SubmitBuffer",
    "Upload",
    "PipelineExecutor",
    "ExecutorStats",
    "block_until_ready",
    "fetch_to_host",
    "fetch_to_host_stitched",
    "GatherStage",
    "putter",
]

MAX_SYMLEN_CAP = 64  # a 64-bit word holds at most 64 one-bit codes

DevicesArg = Union[None, str, Sequence[Any]]


def p2(x: int) -> int:
    """Next power of two (>= 1) — the bucket rounding."""
    return 1 << max(int(x) - 1, 0).bit_length()


def symlen_bucket(x: int) -> int:
    """Round the slot-loop trip count up to a multiple of 8 (cap 64)."""
    return min(-(-max(int(x), 1) // 8) * 8, MAX_SYMLEN_CAP)


def resolve_device(device=None) -> torch.device:
    """The device a device entry point runs on.

    ``None`` means the card: ``cuda`` when one is present, and an error when
    none is — an entry point never falls back to the CPU on its own.  The
    CPU runs only when the caller asks for it (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def serving_devices(devices: DevicesArg = None,
                    device=None) -> Tuple[torch.device, ...]:
    """Resolve an engine's ``devices`` argument to the shard devices the
    scheduler splits over, each by :func:`resolve_device`'s rule.

    ``None`` — one shard on ``resolve_device(device)``.  ``"auto"`` — one
    shard per visible CUDA device (an error where there is none: the CPU
    runs only when asked for).  A sequence — those devices in order,
    repeats allowed (two shards on one card split the batch and run one
    after the other).  Passing both ``device`` and ``devices`` raises unless
    every shard device is ``device``.
    """
    if devices is None:
        return (resolve_device(device),)
    if isinstance(devices, str) and devices == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for devices='auto' (one shard "
                "per visible card); pass device='cpu' to run the plain "
                "PyTorch versions on the host"
            )
        devs = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    else:
        if isinstance(devices, (str, torch.device)):
            devices = (devices,)
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("devices must be None, 'auto', or a non-empty "
                             "sequence of devices")
    if device is not None:
        want = resolve_device(device)
        if any(d != want for d in devs):
            raise ValueError(
                f"device={want} and devices={[str(d) for d in devs]} "
                "disagree — pass one of them"
            )
    return devs


def putter(device) -> Callable[[Any], torch.Tensor]:
    """The engines' placement idiom for one explicit device: a numpy array
    or host tensor goes to ``device`` (on CUDA through pinned memory, a
    ``non_blocking`` copy on the current stream, so placing never waits on
    the device); a tensor already there passes through."""
    dev = torch.device(device)

    def put(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.device == dev:
            return x
        host = _host_tensor(x)
        if dev.type != "cuda":
            return host
        if not host.is_pinned():
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    return put


@dataclasses.dataclass
class GatherStage:
    """Stage an encode bucket by gathering its rows inside the bucket's
    encode (``encode_levels_gather`` on the card).

    Row ``r`` covers samples ``[starts[r], starts[r] + lens[r])`` of the
    flat device tensor ``flat`` and is exact zero past ``lens[r]``; rows
    past the real signals have ``lens == 0``.  ``flat`` carries at least
    the bucket width of trailing zeros past every start (the plain gather
    reads that far).  ``last_use`` marks the bucket as ``flat``'s last
    reader: the encoder drops the stage's reference once that bucket is
    launched, so the buffer returns to the allocator without waiting for
    the batch — PyTorch's stand-in for the reference's buffer donation.
    """

    flat: Optional[torch.Tensor]  # f32[T + width] on the device
    starts: Any  # int32[K]
    lens: Any  # int32[K]
    last_use: bool = False


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One schedulable unit of engine work: the members of one key group
    assigned to one shard.  ``items`` are caller-side indices in input
    order; ``device`` is the shard's device (None where the scheduler was
    given none: the engine's own)."""

    key: Hashable
    items: Tuple[int, ...]
    shard: int = 0
    device: Any = None


def member_positions(buckets: Sequence[Bucket], count: int) -> List[int]:
    """Per original index, its position in the buckets' flattened member
    order — what restores caller order after a bucket-ordered drain."""
    pos = [0] * count
    i = 0
    for b in buckets:
        for item in b.items:
            pos[item] = i
            i += 1
    return pos


class BucketScheduler:
    """Owns grouping, shard assignment and bucket rounding for the engines.

    Grouping preserves first-appearance key order with members in input
    order inside each group.  With ``num_shards > 1`` each group's members
    additionally split into contiguous per-device shards, so one bucket per
    (key, shard) runs on its own device.  ``devices`` is the engine's
    resolved shard devices (:func:`serving_devices`); the scheduler only
    hands them out, so any hashable stands in for a device in tests.
    ``None`` is one shard with no device of its own.

    ``policy`` picks the bucket-edge ladder every padded axis rounds with
    (:meth:`round`): a :class:`~repro_torch.tuning.policy.BucketPolicy`, a
    name, or None for the ``FPTC_BUCKET_POLICY`` default (``p2``).
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 policy: PolicyArg = None):
        self.devices = (None,) if devices is None else tuple(devices)
        if not self.devices:
            raise ValueError("a BucketScheduler needs at least one device")
        self.policy = BucketPolicy.of(policy)

    def round(self, x: int) -> int:
        """Bucket-edge rounding for a padded axis under this policy."""
        return self.policy.round(max(int(x), 1))

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    def device_of(self, shard: int) -> Any:
        return self.devices[shard]

    @staticmethod
    def group_by(keys: Sequence[Hashable]) -> Tuple[
        List[Hashable], Dict[Hashable, List[int]]
    ]:
        """Group indices by key: (first-appearance key order, key->indices
        in input order)."""
        order: List[Hashable] = []
        groups: "OrderedDict[Hashable, List[int]]" = OrderedDict()
        for i, key in enumerate(keys):
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(i)
        return order, groups

    def buckets(
        self,
        keys: Sequence[Hashable],
        shard_ids: Optional[Sequence[int]] = None,
        shard_devices: Optional[Dict[int, Any]] = None,
        item_costs: Optional[Sequence[float]] = None,
    ) -> List[Bucket]:
        """Schedule items into (key, shard) buckets.

        Without ``shard_ids``, each key group's members split into
        ``min(len(group), num_shards)`` contiguous shards on this
        scheduler's devices, the starting shard rotating across groups (an
        archive of many small groups still spreads over every device).
        The split is equal-count unless ``item_costs`` gives a predicted
        cost per item (e.g. :meth:`repro_torch.tuning.cost_model.CostModel.
        signal_decode_cost`); then each group splits at cost-balanced
        boundaries.  Splits stay contiguous either way, so member order
        (and hence bytes) never changes.  With ``shard_ids`` (one per item
        — a *pinning*, e.g. the transcoder keeping a signal's re-encode on
        the device that decoded it) members partition by their given shard
        instead, ascending shard order, relative order kept;
        ``shard_devices`` maps those shard ids to devices (required where
        the pinned ids come from another scheduler: the data's placement
        wins over this scheduler's devices).
        """
        order, groups = self.group_by(keys)
        out: List[Bucket] = []
        next_shard = 0  # rotating start keeps small groups off shard 0
        for key in order:
            idxs = groups[key]
            if shard_ids is None:
                if item_costs is not None and self.num_shards > 1:
                    parts = _split_balanced(
                        idxs, [float(item_costs[i]) for i in idxs],
                        self.num_shards,
                    )
                else:
                    parts = _split_contiguous(idxs, self.num_shards)
                shards = [
                    (next_shard + j) % self.num_shards
                    for j in range(len(parts))
                ]
                next_shard = (next_shard + len(parts)) % self.num_shards
            else:
                by_shard: "OrderedDict[int, List[int]]" = OrderedDict()
                for i in idxs:
                    by_shard.setdefault(int(shard_ids[i]), []).append(i)
                shards = sorted(by_shard)
                parts = [by_shard[s] for s in shards]
            for shard, part in zip(shards, parts):
                if shard_devices is not None:
                    device = shard_devices[shard]
                elif shard < len(self.devices):
                    device = self.devices[shard]
                else:
                    raise ValueError(
                        f"pinned shard id {shard} has no device: this "
                        f"scheduler holds {self.num_shards} shard(s) — "
                        "pass shard_devices when shard_ids come from "
                        "another scheduler"
                    )
                out.append(Bucket(key=key, items=tuple(part), shard=shard,
                                  device=device))
        return out


def _split_contiguous(items: List[int], num_shards: int) -> List[List[int]]:
    """Contiguous equal-count partition into <= ``num_shards`` parts."""
    k = min(len(items), max(num_shards, 1))
    if k <= 1:
        return [list(items)]
    q, r = divmod(len(items), k)
    out, off = [], 0
    for s in range(k):
        size = q + (1 if s < r else 0)
        out.append(items[off:off + size])
        off += size
    return out


def _split_balanced(
    items: List[int], costs: List[float], num_shards: int
) -> List[List[int]]:
    """Contiguous partition of ``items`` into <= ``num_shards`` parts with
    near-equal predicted cost: greedily close part ``s`` once its running
    cost reaches the ideal boundary ``total * (s+1) / k``.  Equal costs
    give the same +-1 size balance as the equal-count split; contiguity
    keeps member (and byte) order identical to the unweighted path."""
    k = min(len(items), max(num_shards, 1))
    total = sum(costs)
    if k <= 1 or not (total > 0.0):
        return _split_contiguous(items, num_shards)
    out: List[List[int]] = []
    part: List[int] = []
    acc = 0.0
    s = 0
    for j, (item, cost) in enumerate(zip(items, costs)):
        part.append(item)
        acc += cost
        remaining_items = len(items) - (j + 1)
        remaining_parts = k - (s + 1)
        if remaining_parts <= 0:
            continue
        # close this part at its ideal cost boundary, or when the leftover
        # items are only just enough to make every remaining part non-empty
        if acc >= total * (s + 1) / k or remaining_items <= remaining_parts:
            out.append(part)
            part = []
            s += 1
    if part:
        out.append(part)
    return out


class SubmitBuffer:
    """Thread-safe pending-work buffer behind the engines' ``submit`` /
    ``flush`` surface: ``submit`` appends one item (any thread) and returns
    its index in flush order; ``take`` atomically claims everything
    pending."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: List[Any] = []

    def submit(self, item: Any) -> int:
        with self._lock:
            self._items.append(item)
            return len(self._items) - 1

    def take(self) -> List[Any]:
        with self._lock:
            items, self._items = self._items, []
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


# ---------------------------------------------------------------------------
# The pipelined executor.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Upload:
    """Host arrays copied to the executor's device.  On CUDA the copies ran
    on a side stream; :meth:`wait` orders the caller's current stream after
    them and returns the tensors."""

    tensors: List[Optional[torch.Tensor]]
    event: Optional[torch.cuda.Event] = None
    device: Optional[torch.device] = None

    def wait(self) -> List[Optional[torch.Tensor]]:
        if self.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.event)
            for t in self.tensors:
                if t is not None:
                    # allocated on the copy stream, used on the compute one
                    t.record_stream(cur)
        return self.tensors


@dataclasses.dataclass
class ExecutorStats:
    runs: int = 0
    buckets: int = 0
    pipelined_buckets: int = 0  # buckets whose upload ran on the worker
    upload_s: float = 0.0  # host staging + h2d enqueue (worker or inline)
    dispatch_s: float = 0.0  # main-thread dispatch time (kernels are async)
    max_inflight: int = 0  # peak buckets simultaneously staged/dispatching


class PipelineExecutor:
    """Runs bucket work as stage(upload) -> stage(dispatch), double-buffered.

    ``upload(item)`` does the host staging and the h2d copy of one bucket
    (through :meth:`host_buffer` and :meth:`put`); ``dispatch(item,
    staged)`` launches its device work.  With ``pipeline=True`` and more
    than one bucket, one staging worker keeps up to ``prefetch`` uploads in
    flight ahead of the main thread's dispatches.  Dispatch order is always
    bucket order, so the pipelined path matches the serial one exactly.

    ``device`` is one device or an engine's shard devices (repeats
    allowed); :meth:`put` copies to its first unless told another.  One
    side stream per distinct device; the staging worker and the host
    buffers are shared, so a device named twice costs nothing more.
    """

    def __init__(self, device, *, pipeline: bool = True, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        devs = ([device] if isinstance(device, (str, torch.device))
                else list(device))
        if not devs:
            raise ValueError("a PipelineExecutor needs a device")
        self.devices = tuple(dict.fromkeys(torch.device(d) for d in devs))
        self.device = self.devices[0]
        self.pipeline = pipeline
        self.prefetch = prefetch
        self.stats = ExecutorStats()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._copy_streams: Dict[torch.device, Any] = {}
        self._lock = threading.Lock()
        self._inflight = 0

    @property
    def cuda(self) -> bool:
        return any(d.type == "cuda" for d in self.devices)

    @property
    def inflight(self) -> int:
        """Buckets currently staged or dispatching (0 between runs)."""
        with self._lock:
            return self._inflight

    def _inflight_add(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta
            if self._inflight > self.stats.max_inflight:
                self.stats.max_inflight = self._inflight

    # -- staging helpers (called from upload) --------------------------------
    def host_buffer(self, size: int, dtype: torch.dtype) -> torch.Tensor:
        """A zeroed host staging buffer (pinned when the device is CUDA)."""
        return torch.zeros(size, dtype=dtype, pin_memory=self.cuda)

    def put(self, arrays: Sequence[Any], device=None) -> Upload:
        """Move arrays (numpy, host tensors, or tensors already on the
        device; None passes through) to ``device`` (default: the first
        one).  On CUDA: pinned sources, ``non_blocking`` copies on the
        device's side stream, and one event after them."""
        dev = (self.device if device is None
               else device if isinstance(device, torch.device)
               else torch.device(device))
        on_device = [
            isinstance(a, torch.Tensor) and a.device == dev for a in arrays
        ]
        hosts = [
            a if a is None or here else _host_tensor(a)
            for a, here in zip(arrays, on_device)
        ]
        if dev.type != "cuda":
            return Upload(hosts)
        with self._lock:
            stream = self._copy_streams.get(dev)
            if stream is None:
                stream = self._copy_streams[dev] = torch.cuda.Stream(dev)
        out: List[Optional[torch.Tensor]] = []
        with torch.cuda.stream(stream):  # makes the stream's device current
            for h, here in zip(hosts, on_device):
                if h is None or here:
                    out.append(h)
                    continue
                if not h.is_pinned():
                    h = h.pin_memory()
                out.append(h.to(dev, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return Upload(out, event, dev)

    def _worker(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="fptc-stage"
                )
        return self._pool

    def close(self) -> None:
        """Join the staging worker (a later run starts a new one)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def run(
        self,
        work: Sequence[Any],
        upload: Callable[[Any], Any],
        dispatch: Callable[[Any, Any], Any],
    ) -> List[Any]:
        n = len(work)
        self.stats.runs += 1
        self.stats.buckets += n
        if n == 0:
            return []

        def timed_upload(b: Any) -> Any:
            t0 = time.perf_counter()
            try:
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        return upload(b)
                return upload(b)
            finally:
                self.stats.upload_s += time.perf_counter() - t0

        def timed_dispatch(b: Any, staged: Any) -> Any:
            t0 = time.perf_counter()
            try:
                return dispatch(b, staged)
            finally:
                self.stats.dispatch_s += time.perf_counter() - t0
                self._inflight_add(-1)

        if not self.pipeline or n == 1:
            out = []
            for b in work:
                self._inflight_add(1)
                try:
                    staged = timed_upload(b)
                except BaseException:
                    self._inflight_add(-1)
                    raise
                out.append(timed_dispatch(b, staged))
            return out

        pool = self._worker()
        results: List[Any] = [None] * n
        pending: "deque[Tuple[int, Any, Any]]" = deque()

        def pop_dispatch() -> None:
            j, bj, fut = pending.popleft()
            try:
                staged = fut.result()
            except BaseException:
                self._inflight_add(-1)
                raise
            results[j] = timed_dispatch(bj, staged)

        try:
            for i, b in enumerate(work):
                self._inflight_add(1)
                pending.append((i, b, pool.submit(timed_upload, b)))
                self.stats.pipelined_buckets += 1
                if len(pending) > self.prefetch:
                    pop_dispatch()
            while pending:
                pop_dispatch()
        finally:
            # on error, join the leftover staging futures so no upload
            # outlives this call, and unwind their in-flight count
            while pending:
                _, _, fut = pending.popleft()
                if not fut.cancel():
                    try:
                        fut.result()
                    except BaseException:
                        pass  # the primary exception is already in flight
                self._inflight_add(-1)
        return results


def _host_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(
                f"a {a.device} tensor is neither on the host nor on the "
                "executor's device"
            )
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)  # torch holds uint64 words as int64 bits
    return torch.from_numpy(a)


def _start_d2h(tensors: Sequence[torch.Tensor]):
    """Start the d2h copies of ``tensors`` into pinned buffers; returns the
    host tensors and one event recorded after the copies (None when none
    was needed)."""
    hosts = []
    event = None
    for t in tensors:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
            hosts.append(h)
        else:
            hosts.append(t)
    return hosts, event


def block_until_ready(tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """Wait until the device work that produces ``tensors`` has finished:
    synchronize each CUDA device they live on (a CPU tensor is ready when
    it is returned)."""
    for dev in {t.device for t in tensors
                if t is not None and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def fetch_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Drain device tensors: start EVERY d2h copy (into pinned buffers)
    before reading any of them."""
    staged = [_start_d2h([t]) for t in tensors]
    for _, ev in staged:
        if ev is not None:
            ev.synchronize()
    return [hosts[0].numpy() for hosts, _ in staged]


def fetch_to_host_stitched(
    bucket_tensors: Sequence[Sequence[torch.Tensor]],
    stitch: Callable[[int, List[np.ndarray]], Any],
) -> List[Any]:
    """Drain per-bucket device tensors and overlap the host-side stitch.

    Every bucket's d2h copies start up front (as :func:`fetch_to_host`);
    then the main thread waits for bucket ``k+1``'s copies while a single
    worker runs ``stitch(k, host_arrays)`` — so the host post-processing of
    bucket ``k`` overlaps the later copies instead of following all of
    them.  Results come back in bucket order; a stitch exception
    propagates to the caller.
    """
    staged = [_start_d2h(tensors) for tensors in bucket_tensors]
    if not staged:
        return []

    def host(b: int) -> List[np.ndarray]:
        hosts, ev = staged[b]
        if ev is not None:
            ev.synchronize()
        return [h.numpy() for h in hosts]

    if len(staged) == 1:
        return [stitch(0, host(0))]
    with ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="fptc-stitch"
    ) as pool:
        futures = [pool.submit(stitch, b, host(b))
                   for b in range(len(staged))]
        return [f.result() for f in futures]
