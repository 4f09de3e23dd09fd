"""Always-on serving front-end: adaptive deadline micro-batching over the
pipelined engines.  Port of ``repro/serving/frontend.py``.

Everything below this module is *offline*: callers hand
:class:`~repro_torch.serving.batch_decode.BatchDecoder` /
:class:`~repro_torch.serving.batch_encode.BatchEncoder` /
:class:`~repro_torch.serving.transcode.Transcoder` a fully formed batch.  A
production archive service absorbs an **open-loop request stream** — it
must form its own batches under latency SLOs, because the engines' fused
bucket dispatches only amortize their overhead when buckets stay full
(the throughput argument of the paper's GPU decode path), while a request
that waits for a full bucket under light load would blow its deadline.

:class:`ServingFrontend` is that batch-forming layer:

  * **Per-(kind, plan) request queues.**  Requests partition by traffic
    kind (decode / encode / transcode) and by the (domain, config) plan
    key — exactly the grouping the engines bucket by, so every flushed
    micro-batch maps onto whole engine buckets with no cross-key padding.
  * **Deadline micro-batching.**  A queue dispatches when it *fills* to
    the active :class:`~repro_torch.tuning.policy.BucketPolicy`'s largest
    bucket edge at or below ``max_batch`` (a full batch carries zero
    batch-dim padding under the engines' ladder), OR when its oldest
    request's deadline minus ``flush_slack_ms`` arrives — whichever is
    first.  Heavy load therefore serves full buckets (throughput);
    light load serves singleton buckets just-in-time (latency).
  * **Bounded queues with explicit load-shedding.**  Admission past
    ``max_queue_depth`` raises :class:`QueueFullError` (carrying the
    queue key, its depth and the bound) — the caller learns it was shed
    and can back off; nothing is ever silently dropped.  A request whose
    deadline already expired at admission raises
    :class:`DeadlineExpiredError` instead of being enqueued dead.
  * **Unified admission.**  All three traffic kinds feed one dispatcher
    and the engines' shared scheduling machinery; a mixed stream
    interleaves freely, and per-request responses are **byte-identical**
    to the offline engine path on the same inputs — micro-batching
    changes *when* buckets run, never bytes (every per-signal output is
    independent of which other requests share its bucket).
  * **Fault isolation.**  With ``config.quarantine`` (the default) a
    corrupt container poisons only its own request: the engines exclude
    it from its bucket and its future carries a typed
    :class:`~repro_torch.serving.quarantine.PoisonedContainerError` while its
    batch-mates complete byte-identically.  Transient engine faults
    retry with bounded exponential backoff + jitter
    (:class:`RetryPolicy`; poisoned payloads are never re-run — their
    outcome is a result, not a dispatch fault).  An optional watchdog
    (``config.watchdog_timeout_ms``) bounds every engine call: a hung
    dispatch fails its in-flight requests with a typed
    :class:`DispatchFailedError`, a fresh dispatcher generation takes
    over, and the queues keep draining.  :meth:`health` reports the
    degraded/ok state plus shed-rate and quarantine counters.

Threading model: admission (``submit_*``) is safe from any number of
threads and returns a :class:`concurrent.futures.Future`.  ONE dispatcher
thread owns batch formation and all engine calls — plan builds and kernel
launches stay on a single thread, on its current CUDA stream (the default
stream) — and hands device-resident batches to a small drain pool, so the
host-side ``to_host()`` stitch of micro-batch k overlaps the dispatch of
micro-batch k+1 (the request-level twin of the engines' double-buffered
staging).  A drain enqueues its device-to-host copies on the drain
thread's current stream, which is the same default stream, so they run
after the batch's kernels.  The watchdog replaces a
timed-out dispatcher with a new generation; the abandoned thread's
eventual result is discarded through a per-batch completion token, so a
request completes exactly once however the race resolves.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Dict,
    Hashable,
    List,
    Mapping,
    Optional,
    Tuple,
    Union,
)

import numpy as np

from repro_torch.core.calibration import DomainTables
from repro_torch.core.container import Container
from repro_torch.serving.batch_decode import BatchDecoder
from repro_torch.serving.batch_encode import BatchEncoder
from repro_torch.serving.transcode import Transcoder
from repro_torch.tuning.policy import BucketPolicy, PolicyArg

__all__ = [
    "DEADLINE",
    "FILL",
    "FORCED",
    "DispatchFailedError",
    "FrontendClosedError",
    "FrontendConfig",
    "FrontendError",
    "FrontendStats",
    "DeadlineExpiredError",
    "QueueFullError",
    "RequestFuture",
    "RetryPolicy",
    "ServingFrontend",
    "policy_fill_target",
    "settle_heap",
]

TablesArg = Union[DomainTables, Mapping[int, DomainTables]]

# dispatch reasons (stats + tests key on these)
FILL = "fill"  # the queue reached the policy-edge fill target
DEADLINE = "deadline"  # the oldest request's deadline slack arrived
FORCED = "forced"  # an explicit flush() or the closing drain


# ---------------------------------------------------------------------------
# Typed front-end errors: load shedding is a *response*, never a silent drop.
# ---------------------------------------------------------------------------
class FrontendError(RuntimeError):
    """Base class for serving front-end rejections/failures."""


class QueueFullError(FrontendError):
    """Admission rejected: the request's queue is at its depth bound.

    Carries the shed decision's evidence — ``queue`` (the (kind, plan)
    key), ``depth`` (pending requests at rejection) and ``bound`` — so
    callers and load balancers can report and back off instead of
    guessing.  Raised at admission; the request was never enqueued.
    """

    def __init__(self, queue: Hashable, depth: int, bound: int):
        self.queue = queue
        self.depth = depth
        self.bound = bound
        super().__init__(
            f"queue {queue!r} is full ({depth} pending >= bound {bound}); "
            "request shed — back off and retry"
        )


class DeadlineExpiredError(FrontendError):
    """Admission rejected: the request's deadline had already expired.

    Enqueueing it could only produce a guaranteed-late response that
    still costs a bucket slot; rejecting at admission is the honest
    failure.  Raised before enqueue; the request was never admitted.
    """

    def __init__(self, queue: Hashable, late_s: float):
        self.queue = queue
        self.late_s = late_s
        super().__init__(
            f"deadline for queue {queue!r} expired {late_s * 1e3:.2f} ms "
            "before admission"
        )


class FrontendClosedError(FrontendError):
    """The front-end is closed: no new admissions (and, on a non-draining
    close, the fate of requests that were still queued)."""


class DispatchFailedError(FrontendError):
    """A micro-batch's engine dispatch failed for good.

    The typed per-request outcome for a hung engine call the watchdog cut
    loose, or a transient fault that exhausted its :class:`RetryPolicy`
    budget (``__cause__`` carries the final attempt's exception).  The
    request itself may be perfectly valid — resubmitting it is safe and
    is exactly what the retry budget already did; this error says the
    *serving machinery* gave up, as opposed to a
    :class:`~repro_torch.serving.quarantine.PoisonedContainerError`, which says
    the *payload* is bad.
    """

    def __init__(self, queue: Hashable, message: str):
        self.queue = queue
        super().__init__(
            f"dispatch for queue {queue!r} failed: {message}"
        )


# ---------------------------------------------------------------------------
# Config + stats.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter for transient
    dispatch faults.

    A failed micro-batch's members requeue (at the head — retries never
    jump the FIFO order of their queue) at most ``max_retries`` times
    each, waiting ``base_backoff_ms * 2**attempt`` (capped at
    ``max_backoff_ms``) scaled down by up to ``jitter`` fraction at
    random — the standard thundering-herd spreader.  Only *transient*
    faults retry: :meth:`retryable` rejects deterministic errors
    (``ValueError`` / ``KeyError`` / ``TypeError`` /
    ``NotImplementedError``), every typed front-end error, and — the
    contract the quarantine depends on — poisoned payloads, which never
    reach retry at all because quarantine delivers them as per-request
    *results*, not dispatch faults.  ``max_retries=0`` disables retry.
    """

    max_retries: int = 2
    base_backoff_ms: float = 10.0
    max_backoff_ms: float = 1000.0
    jitter: float = 0.5

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), in seconds."""
        base = min(
            self.base_backoff_ms * (2.0 ** max(attempt - 1, 0)),
            self.max_backoff_ms,
        ) / 1e3
        return base * (1.0 - self.jitter * random.random())

    def retryable(self, exc: BaseException) -> bool:
        """Whether a dispatch fault is worth re-running the batch for."""
        from repro_torch.serving.quarantine import PoisonedContainerError

        if isinstance(exc, (PoisonedContainerError, FrontendError)):
            return False
        if isinstance(
            exc, (ValueError, KeyError, TypeError, NotImplementedError)
        ):
            return False  # deterministic: identical inputs fail identically
        return isinstance(exc, Exception)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Micro-batching knobs.  See the README knob table.

    ``max_batch`` bounds how many requests one flush takes; the effective
    *fill target* snaps DOWN to the engines' active bucket-policy edge
    (:func:`policy_fill_target`), so fill-triggered batches carry zero
    batch-dimension padding.  ``max_queue_depth`` is the per-queue
    admission bound (shedding past it); ``default_slo_ms`` the deadline
    assigned to requests that don't bring one; ``flush_slack_ms`` how far
    ahead of the oldest deadline a queue flushes (covers dispatch + drain
    latency); ``drain_workers`` sizes the pool that overlaps host drains
    with the next dispatch.

    Fault-isolation knobs: ``quarantine`` turns corrupt containers into
    per-request typed errors instead of batch failures (the serving
    default — flip off to get the offline engines' raise-on-first-fault
    contract); ``retry`` is the transient-fault :class:`RetryPolicy`;
    ``watchdog_timeout_ms`` > 0 arms the dispatcher watchdog (an engine
    call exceeding it fails its batch with :class:`DispatchFailedError`
    and a fresh dispatcher takes over), polled every
    ``watchdog_poll_ms``; ``degraded_window_s`` is how long a fault event
    keeps :meth:`ServingFrontend.health` reporting ``degraded``.
    """

    max_batch: int = 64
    max_queue_depth: int = 256
    default_slo_ms: float = 100.0
    flush_slack_ms: float = 5.0
    drain_workers: int = 1
    quarantine: bool = True
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    watchdog_timeout_ms: float = 0.0  # 0 = watchdog disabled
    watchdog_poll_ms: float = 50.0
    degraded_window_s: float = 30.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )
        if self.drain_workers < 1:
            raise ValueError(
                f"drain_workers must be >= 1, got {self.drain_workers}"
            )
        if self.flush_slack_ms < 0:
            raise ValueError(
                f"flush_slack_ms must be >= 0, got {self.flush_slack_ms}"
            )
        if self.watchdog_timeout_ms < 0:
            raise ValueError(
                "watchdog_timeout_ms must be >= 0 (0 disables), got "
                f"{self.watchdog_timeout_ms}"
            )
        if self.watchdog_poll_ms <= 0:
            raise ValueError(
                f"watchdog_poll_ms must be > 0, got {self.watchdog_poll_ms}"
            )


def settle_heap() -> int:
    """Collect garbage, then freeze every object alive now (``gc.freeze``),
    so later full collections skip the process's long-lived heap; returns
    the objects frozen.  ``gc.unfreeze()`` undoes it.

    A full collection walks every tracked object and stops every thread,
    the dispatcher, the drain and the request threads with them; in a
    serving process it lands in some request's admission or its
    flush-to-result and can break the SLO below the knee (``PERF.md``,
    F2).  Freezing the heap once the process is warm leaves the
    collections only the objects the serving itself makes.  The process's
    owner calls it once, before serving (``launch.serve`` does); a library
    cannot know when the heap has settled.
    """
    gc.collect()
    gc.freeze()
    return gc.get_freeze_count()


def policy_fill_target(policy: BucketPolicy, max_batch: int) -> int:
    """The largest ``policy`` bucket edge <= ``max_batch`` — the fill
    count at which a queue dispatches.  Snapping to an edge means a
    fill-triggered micro-batch pads by zero rows under the engines'
    bucket ladder (``policy.round(target) == target``)."""
    t = max(int(max_batch), 1)
    while t > 1 and policy.round(t) != t:
        t -= 1
    return t


@dataclasses.dataclass
class FrontendStats:
    """Counters the dispatcher/drain threads maintain (read them via
    :meth:`ServingFrontend.stats_snapshot` for a coherent copy)."""

    admitted: int = 0
    completed: int = 0
    failed: int = 0  # admitted but engine/drain raised (futures carry it)
    shed: int = 0  # rejected QueueFullError
    rejected_expired: int = 0  # rejected DeadlineExpiredError
    batches: int = 0
    fill_dispatches: int = 0
    deadline_dispatches: int = 0
    forced_dispatches: int = 0  # explicit flush() + the closing drain
    deadline_misses: int = 0  # completed after their own deadline
    max_inflight: int = 0  # peak requests dispatched-but-not-completed
    max_depth: int = 0  # peak single-queue depth observed at admission
    batch_size_sum: int = 0
    quarantined: int = 0  # requests whose future carries a poison outcome
    retries: int = 0  # member re-dispatches after a transient fault
    retry_successes: int = 0  # completed on a retry attempt
    dispatch_failures: int = 0  # members failed with DispatchFailedError
    watchdog_restarts: int = 0  # hung dispatches the watchdog cut loose
    dispatcher_restarts: int = 0  # dispatcher-loop crash recoveries

    @property
    def mean_batch_size(self) -> float:
        return self.batch_size_sum / self.batches if self.batches else 0.0


class RequestFuture(Future):
    """The future of one admitted request, with its timings on the
    front-end's clock: ``admitted_at``, the clock read at admission (the
    deadline's anchor), and once resolved ``flush_to_result_s``, from the
    moment its batch was last taken for dispatch to its result (None for a
    request that never dispatched)."""

    def __init__(self, admitted_at: float):
        super().__init__()
        self.admitted_at = admitted_at
        self.flush_to_result_s: Optional[float] = None


@dataclasses.dataclass
class _Pending:
    payload: Any
    future: RequestFuture
    deadline: float  # absolute, frontend clock
    admitted_at: float
    attempts: int = 0  # dispatch attempts already failed transiently
    not_before: float = 0.0  # retry backoff: not dispatchable before this
    flushed_at: Optional[float] = None  # its batch was last taken then


# ---------------------------------------------------------------------------
# The front-end.
# ---------------------------------------------------------------------------
class ServingFrontend:
    """Long-lived request front-end over the batched serving engines.

    Usage::

        with ServingFrontend(tables) as fe:          # tables: DomainTables
            fut = fe.submit_decode(container)        #   or {domain_id: ...}
            signal = fut.result()                    # np.float32 samples

    ``tables`` routes every traffic kind: decode requests resolve their
    container's domain, encode requests the ``domain_id`` they carry, and
    transcode requests both their source container's domain and their
    ``dst_domain_id`` target.  Engine knobs (``pipeline`` / ``device`` /
    ``devices`` / ``policy`` / ``chunk_size``) construct the three engines
    unless explicit engines are passed; the transcoder shares the
    front-end's decoder and encoder, so all traffic kinds warm ONE set of
    plan caches (per shard device).  With no ``device`` the engines run on
    the card (and raise without one); ``device="cpu"`` runs the plain
    PyTorch versions; ``devices`` shards each batch (``"auto"``: every
    visible card).
    ``clock`` is injectable for deterministic tests.

    ``fault_injector`` (an object with ``on_dispatch(key, members)``,
    e.g. :class:`repro_torch.testing.faults.DispatcherFaultInjector`) is called
    inside the watchdog-covered window at the top of every batch dispatch
    — the chaos harness's hook for raising, delaying or hanging engine
    calls; ``None`` (the default) costs nothing.

    The front-end starts its dispatcher on construction (it is
    *always-on*); ``close()`` — or leaving the context — drains every
    queue, completes every admitted future, joins the threads, and joins
    the staging workers of the engines it built itself.
    """

    def __init__(
        self,
        tables: TablesArg,
        *,
        config: Optional[FrontendConfig] = None,
        decoder: Optional[BatchDecoder] = None,
        encoder: Optional[BatchEncoder] = None,
        transcoder: Optional[Transcoder] = None,
        chunk_size: Optional[int] = None,
        pipeline: bool = True,
        device=None,
        devices=None,
        policy: PolicyArg = None,
        clock: Callable[[], float] = time.monotonic,
        fault_injector: Optional[Any] = None,
    ):
        self.config = config or FrontendConfig()
        self.tables: Mapping[int, DomainTables] = (
            {tables.domain_id: tables}
            if isinstance(tables, DomainTables) else dict(tables)
        )
        self.decoder = decoder or BatchDecoder(
            device=device, devices=devices, pipeline=pipeline, policy=policy,
        )
        self.encoder = encoder or BatchEncoder(
            device=device, devices=devices, pipeline=pipeline, policy=policy,
            **({} if chunk_size is None else {"chunk_size": chunk_size}),
        )
        # the transcoder RIDES the front-end's decoder/encoder: one set of
        # engines, one set of plan caches, one device for all three
        # traffic kinds
        self.transcoder = transcoder or Transcoder(
            decoder=self.decoder, encoder=self.encoder,
        )
        # the engines built here are the front-end's to close
        self._owned = [
            e for e, given in ((self.decoder, decoder),
                               (self.encoder, encoder))
            if given is None
        ]
        self._clock = clock
        self.fault_injector = fault_injector
        self._fill = policy_fill_target(
            self.decoder.scheduler.policy, self.config.max_batch
        )
        self.stats = FrontendStats()

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: "Dict[Hashable, deque[_Pending]]" = {}
        self._inflight = 0
        self._flush_all = False
        self._closed = False
        # fault-isolation state (all under self._lock):
        self._gen = 0  # dispatcher generation; watchdog bumps to restart
        self._watch: Optional[Dict[str, Any]] = None  # in-flight dispatch
        # batches taken from the queues but not yet dispatched, shared so
        # a watchdog restart can hand them to the replacement generation
        # instead of leaving them captive in the stuck thread's locals
        self._undispatched: List[Tuple[Hashable, List["_Pending"], str]] = []
        self._undispatched_gen = 0  # generation owning _undispatched
        self._scrub_pending = False  # abandoned dispatch may have leaked
        # submits into the engines' buffers; next dispatch discards them
        self._events: "deque[Tuple[float, str]]" = deque(maxlen=64)
        self._drain_pool = ThreadPoolExecutor(
            max_workers=self.config.drain_workers,
            thread_name_prefix="fptc-frontend-drain",
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, args=(0,),
            name="fptc-frontend-dispatch", daemon=True,
        )
        self._dispatcher.start()
        self._wd_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        if self.config.watchdog_timeout_ms > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="fptc-frontend-watchdog",
                daemon=True,
            )
            self._watchdog.start()

    # -- context management --------------------------------------------------
    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # -- introspection -------------------------------------------------------
    @property
    def fill_target(self) -> int:
        """Requests at which a queue dispatches on fill (the largest
        active-policy bucket edge <= ``config.max_batch``)."""
        return self._fill

    def inflight(self) -> int:
        """Requests dispatched to the engines but not yet completed."""
        with self._lock:
            return self._inflight

    def queue_depths(self) -> Dict[Hashable, int]:
        """Snapshot of per-queue pending counts (admitted, not yet taken
        by the dispatcher)."""
        with self._lock:
            return {k: len(q) for k, q in self._queues.items() if q}

    def stats_snapshot(self) -> FrontendStats:
        """A coherent copy of the counters (the live object mutates under
        the front-end's lock)."""
        with self._lock:
            return dataclasses.replace(self.stats)

    def health(self) -> Dict[str, Any]:
        """The ``/healthz`` contract: liveness + degraded-state evidence.

        ``status`` is ``"ok"``, ``"degraded"`` (a watchdog restart,
        dispatcher crash or dispatch failure happened within
        ``config.degraded_window_s`` — the frontend still serves, a load
        balancer should prefer healthier replicas) or ``"closed"``.
        ``shed_rate`` is sheds / admission attempts over the frontend's
        lifetime; ``events`` lists the recent fault descriptions backing
        a degraded verdict.
        """
        now = self._clock()
        window = self.config.degraded_window_s
        with self._lock:
            recent = [
                {"age_s": round(now - t, 3), "event": msg}
                for t, msg in self._events
                if now - t <= window
            ]
            attempts = self.stats.admitted + self.stats.shed
            status = "closed" if self._closed else (
                "degraded" if recent else "ok"
            )
            return {
                "status": status,
                "degraded": bool(recent),
                "events": recent,
                "shed_rate": self.stats.shed / attempts if attempts else 0.0,
                "quarantined": self.stats.quarantined,
                "retries": self.stats.retries,
                "retry_successes": self.stats.retry_successes,
                "dispatch_failures": self.stats.dispatch_failures,
                "watchdog_restarts": self.stats.watchdog_restarts,
                "dispatcher_restarts": self.stats.dispatcher_restarts,
                "inflight": self._inflight,
                "queued": sum(len(q) for q in self._queues.values()),
            }

    def _health_event(self, message: str) -> None:
        """Record a degraded-state event (caller holds the lock)."""
        self._events.append((self._clock(), message))

    # -- admission -----------------------------------------------------------
    def _tables_for(self, domain_id: int) -> DomainTables:
        try:
            return self.tables[domain_id]
        except KeyError:
            raise KeyError(
                f"no DomainTables registered for domain_id={domain_id}"
            ) from None

    def _route_container(self, container: Any) -> Tuple[Any, tuple]:
        """Resolve (payload, plan_key) for a decode/transcode admission.

        Raw bytes are admitted as-is under quarantine — routing reads the
        header via :meth:`Container.peek` (O(1), no CRC) and the full
        parse + validation happens at dispatch, where a corrupt payload
        poisons only its own request.  An unparseable *header* still
        fails here, at admission, with the typed
        :class:`~repro_torch.core.container.ContainerFormatError` — same
        contract as :class:`QueueFullError`: typed, immediate, never
        enqueued.  Without quarantine, bytes parse fully at admission.
        """
        if isinstance(container, Container):
            return container, container.plan_key
        if self.config.quarantine:
            hdr = Container.peek(container)
            return container, hdr.plan_key
        parsed = Container.from_bytes(container)
        return parsed, parsed.plan_key

    def submit_decode(
        self,
        container: Union[Container, bytes, bytearray, memoryview],
        *,
        deadline_ms: Optional[float] = None,
    ) -> "Future[np.ndarray]":
        """Admit one container (parsed, or raw wire bytes) for decoding;
        resolves to its float32 signal.  Raises :class:`QueueFullError` /
        :class:`DeadlineExpiredError` / :class:`FrontendClosedError` at
        admission (typed, never silent).  Under ``config.quarantine`` a
        corrupt payload resolves the future to a typed
        :class:`~repro_torch.serving.quarantine.PoisonedContainerError` instead
        of failing its batch-mates."""
        payload, plan_key = self._route_container(container)
        self._tables_for(plan_key[0])  # unroutable fails up front
        key = ("decode", plan_key)
        return self._admit(key, payload, deadline_ms)

    def submit_encode(
        self,
        signal: np.ndarray,
        domain_id: Optional[int] = None,
        *,
        deadline_ms: Optional[float] = None,
    ) -> "Future[Container]":
        """Admit one signal for encoding; resolves to its
        :class:`Container`.  ``domain_id`` defaults to the single
        registered domain (ambiguous with several — pass it)."""
        if domain_id is None:
            if len(self.tables) != 1:
                raise ValueError(
                    "domain_id is required when the front-end serves "
                    f"{len(self.tables)} domains"
                )
            domain_id = next(iter(self.tables))
        tab = self._tables_for(domain_id)
        cfg = tab.config
        key = ("encode", (domain_id, cfg.n, cfg.e, cfg.l_max, cfg.coding))
        return self._admit(key, (signal, domain_id), deadline_ms)

    def submit_transcode(
        self,
        container: Union[Container, bytes, bytearray, memoryview],
        dst_domain_id: int,
        *,
        deadline_ms: Optional[float] = None,
    ) -> "Future[Container]":
        """Admit one container (parsed, or raw wire bytes) for migration
        to ``dst_domain_id``'s tables; resolves to the re-encoded
        :class:`Container`."""
        payload, plan_key = self._route_container(container)
        self._tables_for(plan_key[0])
        self._tables_for(dst_domain_id)
        key = ("transcode", plan_key, dst_domain_id)
        return self._admit(key, (payload, dst_domain_id), deadline_ms)

    def _admit(
        self, key: Hashable, payload: Any, deadline_ms: Optional[float]
    ) -> Future:
        now = self._clock()
        slo = (
            self.config.default_slo_ms if deadline_ms is None
            else float(deadline_ms)
        )
        deadline = now + slo / 1e3
        with self._cond:
            if self._closed:
                raise FrontendClosedError(
                    "front-end is closed; no new admissions"
                )
            if deadline <= now:
                self.stats.rejected_expired += 1
                raise DeadlineExpiredError(key, now - deadline)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            depth = len(q)
            if depth >= self.config.max_queue_depth:
                self.stats.shed += 1
                self._health_event(f"request shed (queue {key!r} full)")
                raise QueueFullError(key, depth, self.config.max_queue_depth)
            fut = RequestFuture(now)
            q.append(_Pending(payload, fut, deadline, now))
            self.stats.admitted += 1
            if depth + 1 > self.stats.max_depth:
                self.stats.max_depth = depth + 1
            self._cond.notify_all()
        return fut

    def flush(self) -> None:
        """Force-dispatch everything currently queued, regardless of fill
        or deadlines (a no-op on empty queues).  Returns immediately; wait
        on the submitted futures for completion."""
        with self._cond:
            self._flush_all = True
            self._cond.notify_all()

    # -- the dispatcher ------------------------------------------------------
    def _take_ready(
        self, now: float, force: bool
    ) -> List[Tuple[Hashable, List[_Pending], str]]:
        """Pop every dispatchable micro-batch (caller holds the lock).

        A queue dispatches its oldest ``fill_target`` requests while it
        holds at least that many (reason FILL); once the oldest remaining
        request's ``deadline - flush_slack`` has arrived, whatever is left
        dispatches as one partial batch (reason DEADLINE).  ``force``
        (explicit flush / closing drain) takes everything in
        ``max_batch``-bounded slices — including members still inside a
        retry backoff, so close() never waits one out.  A queue whose head
        is backing off is otherwise skipped whole: retries requeue at the
        head, and dispatching past them would reorder the FIFO.
        """
        slack = self.config.flush_slack_ms / 1e3
        out: List[Tuple[Hashable, List[_Pending], str]] = []
        for key, q in self._queues.items():
            if q and not force and q[0].not_before > now:
                continue  # head is in retry backoff — don't reorder past it
            while len(q) >= self._fill:
                batch = [q.popleft() for _ in range(self._fill)]
                for r in batch:
                    r.flushed_at = now
                out.append((key, batch, FILL))
            retry_due = bool(q) and q[0].attempts > 0 and (
                q[0].not_before <= now
            )  # a retried head redispatches the moment its backoff ends:
            # it was already taken by a fill/deadline/flush trigger once
            if q and (force or retry_due or q[0].deadline - slack <= now):
                batch = []
                while q and len(batch) < self.config.max_batch:
                    r = q.popleft()
                    r.flushed_at = now
                    batch.append(r)
                out.append((key, batch, FORCED if force else DEADLINE))
        return out

    def _next_wake(self, now: float) -> Optional[float]:
        """Seconds until the earliest queued dispatch condition (None =
        sleep until notified): deadline-minus-slack, pushed back to the
        head's retry backoff expiry where one is pending."""
        slack = self.config.flush_slack_ms / 1e3
        earliest = None
        for q in self._queues.values():
            if q:
                if len(q) >= self._fill or q[0].attempts > 0:
                    t = q[0].not_before  # dispatch the moment backoff ends
                else:
                    t = max(q[0].deadline - slack, q[0].not_before)
                if earliest is None or t < earliest:
                    earliest = t
        if earliest is None:
            return None
        return max(earliest - now, 0.0)

    def _dispatch_loop(self, my_gen: int) -> None:
        while True:
            try:
                if self._dispatch_once(my_gen):
                    return
            except BaseException as e:  # noqa: BLE001 — keep draining
                # _dispatch_batch contains engine faults; anything landing
                # here is a dispatcher-loop bug.  Log it as a degraded
                # event and keep the loop alive — queues must keep
                # draining (futures of an affected batch were already
                # failed by _dispatch_batch's own handler).
                with self._cond:
                    if self._closed or self._gen != my_gen:
                        return
                    self.stats.dispatcher_restarts += 1
                    self._health_event(
                        f"dispatcher loop crashed and restarted: {e!r}"
                    )

    def _dispatch_once(self, my_gen: int) -> bool:
        """One batch-formation round.  Returns True when this dispatcher
        generation should exit (front-end closed+drained, or the watchdog
        superseded it)."""
        with self._cond:
            while True:
                if self._gen != my_gen:
                    return True  # superseded by a watchdog restart
                force = self._flush_all or self._closed
                self._flush_all = False
                batches = self._take_ready(self._clock(), force)
                if batches:
                    self.stats.batches += len(batches)
                    self._inflight += sum(len(b) for _, b, _ in batches)
                    if self._inflight > self.stats.max_inflight:
                        self.stats.max_inflight = self._inflight
                    for _, members, reason in batches:
                        self.stats.batch_size_sum += len(members)
                        if reason == FILL:
                            self.stats.fill_dispatches += 1
                        elif reason == DEADLINE:
                            self.stats.deadline_dispatches += 1
                        else:
                            self.stats.forced_dispatches += 1
                    break
                if self._closed:
                    return True  # closed and every queue drained
                self._cond.wait(timeout=self._next_wake(self._clock()))
            self._undispatched = list(batches)
            self._undispatched_gen = my_gen
        while True:
            with self._cond:
                if self._gen != my_gen:
                    # superseded mid-list: hand any still-untaken batches
                    # back to their queues (front, order preserved) for
                    # the new generation — never drop a request.  A
                    # watchdog restart usually already requeued them (and
                    # the replacement generation may own the list by now);
                    # this covers a supersede landing between batches.
                    if self._undispatched_gen == my_gen:
                        self._requeue_undispatched_locked()
                    return True
                if not self._undispatched:
                    return False
                key, members, _reason = self._undispatched.pop(0)
            self._dispatch_batch(key, members)

    def _requeue_undispatched_locked(self) -> None:
        """Return taken-but-undispatched batches to their queues (front,
        order preserved).  Caller holds ``self._cond``."""
        for k2, m2, _ in reversed(self._undispatched):
            q = self._queues.setdefault(k2, deque())
            for r in reversed(m2):
                q.appendleft(r)
            self._inflight -= len(m2)
        if self._undispatched:
            # the requeued requests were already due for dispatch (a
            # fill/deadline/flush trigger took them once); re-arm the
            # flush so the next round takes them again instead of
            # sleeping out their deadlines
            self._flush_all = True
        self._undispatched = []
        self._cond.notify_all()

    def _claim(self, token: Dict[str, bool]) -> bool:
        """Atomically claim a batch's completion token.  Exactly one of
        {dispatcher success path, dispatcher failure path, watchdog
        timeout} wins; the losers discard their outcome — this is what
        makes a watchdog-abandoned engine call's eventual return
        harmless."""
        with self._cond:
            if token["done"]:
                return False
            token["done"] = True
            return True

    def _dispatch_batch(
        self, key: Hashable, members: List[_Pending]
    ) -> None:
        """Run one micro-batch through its engine (dispatcher thread: all
        plan builds and kernel launches happen here) and hand the
        device-resident result to the drain pool.  The whole engine call
        sits inside a watchdog window with a per-batch completion token."""
        kind = key[0]
        quarantine = self.config.quarantine
        token: Dict[str, bool] = {"done": False}
        watch = {
            "token": token, "key": key, "members": members,
            "t0": self._clock(),
        }
        with self._lock:
            if self._scrub_pending:
                # an abandoned dispatch may have submitted members into the
                # engines' buffers without flushing; a stale leftover would
                # splice alien requests into this batch
                self.decoder._pending.take()
                self.encoder._pending.take()
                self.transcoder._pending.take()
                self._scrub_pending = False
            self._watch = watch
        try:
            if self.fault_injector is not None:
                self.fault_injector.on_dispatch(key, members)
            if kind == "decode":
                for r in members:
                    self.decoder.submit(r.payload)
                batch = self.decoder.flush(
                    self.tables, quarantine=quarantine
                )
            elif kind == "encode":
                for r in members:
                    signal, domain_id = r.payload
                    self.encoder.submit(signal, domain_id)
                batch = self.encoder.flush(self.tables, quarantine=quarantine)
            else:  # transcode
                for r in members:
                    container, dst = r.payload
                    self.transcoder.submit(container, dst)
                batch = self.transcoder.flush(
                    self.tables, self.tables, quarantine=quarantine
                )
        except BaseException as e:  # noqa: BLE001 — fate rides the futures
            with self._lock:
                if self._watch is watch:
                    self._watch = None
            self._fail_or_retry(key, members, e, token)
            return
        with self._lock:
            if self._watch is watch:
                self._watch = None
        if not self._claim(token):
            return  # watchdog already failed these members; drop the result
        self._drain_pool.submit(self._drain, key, batch, members)

    def _fail_or_retry(
        self,
        key: Hashable,
        members: List[_Pending],
        error: BaseException,
        token: Optional[Dict[str, bool]] = None,
    ) -> None:
        """Resolve a failed dispatch/drain: requeue transiently-failed
        members that still have retry budget (head of their queue, with
        backoff), fail the rest on their futures."""
        if token is not None and not self._claim(token):
            return  # the watchdog already resolved this batch
        policy = self.config.retry
        with self._lock:
            closed = self._closed
        retry: List[_Pending] = []
        fail: List[_Pending] = []
        if policy.max_retries > 0 and not closed and policy.retryable(error):
            for r in members:
                (retry if r.attempts < policy.max_retries else fail).append(r)
        else:
            fail = list(members)
        if fail:
            if policy.retryable(error):
                # transient fault out of budget: typed give-up, original
                # fault chained
                final: BaseException = DispatchFailedError(
                    key,
                    f"transient fault persisted through "
                    f"{policy.max_retries} retries: {error!r}",
                )
                final.__cause__ = error
            else:
                final = error
            with self._cond:
                if isinstance(final, DispatchFailedError):
                    self.stats.dispatch_failures += len(fail)
                self._health_event(
                    f"dispatch failed for {len(fail)} request(s) on queue "
                    f"{key!r}: {final!r}"
                )
            self._finish(fail, error=final)
        if retry:
            now = self._clock()
            with self._cond:
                q = self._queues.setdefault(key, deque())
                for r in reversed(retry):
                    r.attempts += 1
                    r.not_before = now + policy.backoff_s(r.attempts)
                    q.appendleft(r)
                self._inflight -= len(retry)
                self.stats.retries += len(retry)
                self._cond.notify_all()

    def _drain(
        self, key: Hashable, batch: Any, members: List[_Pending]
    ) -> None:
        """Drain worker: host-materialize one micro-batch and complete its
        futures (overlaps the dispatcher forming the next batch)."""
        try:
            results = batch.to_host()
        except BaseException as e:  # noqa: BLE001
            self._fail_or_retry(key, members, e)
            return
        self._finish(members, results=results)

    def _finish(
        self,
        members: List[_Pending],
        *,
        results: Optional[List[Any]] = None,
        error: Optional[BaseException] = None,
    ) -> None:
        now = self._clock()
        done = failed = misses = poisoned = retry_ok = 0
        for i, r in enumerate(members):
            if r.flushed_at is not None:
                r.future.flush_to_result_s = now - r.flushed_at
            try:
                if error is not None:
                    r.future.set_exception(error)
                    failed += 1
                elif isinstance(results[i], BaseException):
                    # a quarantined member's typed per-request outcome —
                    # its batch-mates' results are untouched
                    r.future.set_exception(results[i])
                    failed += 1
                    poisoned += 1
                else:
                    r.future.set_result(results[i])
                    done += 1
                    if r.attempts > 0:
                        retry_ok += 1
                    if now > r.deadline:
                        misses += 1
            except Exception:  # future already cancelled by the caller
                pass
        with self._cond:
            self._inflight -= len(members)
            self.stats.completed += done
            self.stats.failed += failed
            self.stats.quarantined += poisoned
            self.stats.retry_successes += retry_ok
            self.stats.deadline_misses += misses
            self._cond.notify_all()

    # -- the watchdog --------------------------------------------------------
    def _watchdog_loop(self) -> None:
        """Bound every engine call: a dispatch older than
        ``watchdog_timeout_ms`` fails its members with a typed
        :class:`DispatchFailedError` and a fresh dispatcher generation
        takes over the queues.  The abandoned thread keeps running its
        stuck call as a daemon; the completion token makes whatever it
        eventually produces inert."""
        timeout = self.config.watchdog_timeout_ms / 1e3
        poll = self.config.watchdog_poll_ms / 1e3
        while not self._wd_stop.wait(poll):
            with self._lock:
                watch = self._watch
            if watch is None:
                continue
            elapsed = self._clock() - watch["t0"]
            if elapsed <= timeout:
                continue
            if not self._claim(watch["token"]):
                continue  # the dispatch completed while we were deciding
            members = watch["members"]
            key = watch["key"]
            err = DispatchFailedError(
                key,
                f"engine call exceeded the watchdog timeout "
                f"({elapsed * 1e3:.0f} ms > "
                f"{self.config.watchdog_timeout_ms:.0f} ms); dispatcher "
                "restarted",
            )
            with self._cond:
                self._gen += 1
                new_gen = self._gen
                self._scrub_pending = True
                if self._watch is watch:
                    self._watch = None
                # free the batches the stuck thread had taken but not yet
                # dispatched: the replacement generation drains them now
                # instead of waiting for the stuck call to return
                self._requeue_undispatched_locked()
                self.stats.watchdog_restarts += 1
                self.stats.dispatch_failures += len(members)
                self._health_event(
                    f"watchdog cut a hung dispatch on queue {key!r} "
                    f"({len(members)} request(s) failed)"
                )
            # watchdog-timeout faults are NOT retried: the payload just
            # demonstrated it can wedge an engine call, and re-running it
            # would wedge the replacement dispatcher too
            self._finish(members, error=err)
            replacement = threading.Thread(
                target=self._dispatch_loop, args=(new_gen,),
                name=f"fptc-frontend-dispatch-g{new_gen}", daemon=True,
            )
            with self._lock:
                self._dispatcher = replacement
            replacement.start()

    # -- shutdown ------------------------------------------------------------
    def close(self, *, drain: bool = True) -> None:
        """Stop the front-end.  ``drain=True`` (default) flushes and
        completes everything already admitted before returning;
        ``drain=False`` fails queued requests with
        :class:`FrontendClosedError` (their futures carry it — still
        never a silent drop)."""
        with self._cond:
            if self._closed:
                self._cond.notify_all()
            else:
                self._closed = True
                if not drain:
                    for q in self._queues.values():
                        while q:
                            r = q.popleft()
                            try:
                                r.future.set_exception(FrontendClosedError(
                                    "front-end closed before this request "
                                    "dispatched"
                                ))
                            except Exception:
                                pass
                            self.stats.failed += 1
                self._cond.notify_all()
        # join whichever dispatcher generation is current — the watchdog
        # may replace a hung dispatcher while we wait, in which case the
        # replacement (not the stuck daemon) owns the closing drain
        while True:
            with self._lock:
                t = self._dispatcher
            t.join(timeout=0.2)
            with self._lock:
                current = self._dispatcher
            if current is not t:
                continue  # superseded mid-join; wait on the replacement
            if not t.is_alive():
                break
        self._wd_stop.set()
        if self._watchdog is not None:
            self._watchdog.join()
        self._drain_pool.shutdown(wait=True)
        for engine in self._owned:
            engine.close()
