"""Synthetic open-loop traffic for the serving front-end.  Port of
``repro/serving/traffic.py``: one seed draws the reference's stream.

An archive service's load is not a batch: requests arrive on their own
clock (open loop — arrivals don't wait for completions, so queueing
delay is *visible* instead of self-throttled away), sizes are heavy-
tailed (a few long recordings dominate bytes while short probes dominate
counts), and the stream mixes the four signal domains and all three
traffic kinds.  This module synthesizes exactly that stream,
deterministically:

  * **Poisson arrivals** — exponential inter-arrival gaps at the offered
    rate (the standard open-loop arrival model).
  * **Heavy-tailed sizes** — log-normal window counts, clipped to a
    ceiling; ``fixed_windows`` pins one size for shape-warm smoke runs.
  * **Four domains** — one representative dataset per paper domain
    (biomedical / seismic / power / meteorological), each with its own
    calibrated :class:`DomainTables`.
  * **Mixed kinds** — decode / encode / transcode drawn per-request from
    a configurable mix; decode and transcode payload containers are
    pre-encoded offline (byte-identical to what the front-end's encode
    path would produce) so replay measures *serving*, not setup.  The
    pre-encode runs on the card unless ``generate`` is given a device.

:func:`replay` drives a :class:`~repro_torch.serving.frontend.ServingFrontend`
with a generated stream and reports per-request latency percentiles,
achieved goodput, and shed/expired counts — the measurement
``chip_smoke.py``'s serve phase sweeps against offered load.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.calibration import DomainTables, calibrate
from repro_torch.core.config import DOMAIN_DEFAULTS
from repro_torch.core.container import Container
from repro_torch.data.signals import make_signal
from repro_torch.serving.batch_encode import BatchEncoder
from repro_torch.serving.frontend import (
    DeadlineExpiredError,
    QueueFullError,
    ServingFrontend,
)

__all__ = [
    "DOMAIN_DATASETS",
    "Request",
    "ReplayReport",
    "TrafficConfig",
    "build_domain_tables",
    "generate",
    "replay",
]

# one representative dataset per paper domain, in domain_id order
DOMAIN_DATASETS: Tuple[Tuple[str, str], ...] = (
    ("biomedical", "mitbih"),
    ("seismic", "seismic"),
    ("power", "load_power"),
    ("meteorological", "temperature"),
)

# synthesis floors: the seismic generator convolves with a 255-tap Ricker
# wavelet, so its signals can't be shorter than that
_MIN_SAMPLES = {"seismic": 255}


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs for one synthetic stream.

    ``rate`` is the offered load in requests/second (Poisson);
    ``duration_s`` how long arrivals keep coming.  ``mix`` weights the
    traffic kinds (normalized internally).  Sizes are log-normal in
    *windows*: ``median_windows`` the distribution median and ``sigma``
    the log-space shape (bigger = heavier tail), clipped to
    ``max_windows``; ``fixed_windows`` overrides the distribution with
    one constant size (deterministic shapes — smoke/CI runs).
    ``domains`` restricts which domain_ids generate traffic (None =
    all).  Everything derives from ``seed``.
    """

    rate: float = 100.0
    duration_s: float = 1.0
    mix: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {
            "decode": 0.6, "encode": 0.3, "transcode": 0.1,
        }
    )
    median_windows: int = 16
    sigma: float = 0.75
    max_windows: int = 256
    fixed_windows: Optional[int] = None
    domains: Optional[Tuple[int, ...]] = None
    seed: int = 0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if not self.mix or any(w < 0 for w in self.mix.values()):
            raise ValueError(f"mix weights must be >= 0, got {self.mix}")
        unknown = set(self.mix) - {"decode", "encode", "transcode"}
        if unknown:
            raise ValueError(
                f"unknown traffic kinds in mix: {sorted(unknown)}"
            )


@dataclasses.dataclass(frozen=True)
class Request:
    """One synthetic request: ``arrival`` is seconds from stream start;
    the payload is ``signal`` (encode) or ``container``
    (decode/transcode); transcode also carries ``dst_domain_id``."""

    arrival: float
    kind: str
    domain_id: int
    dataset: str
    num_windows: int
    signal: Optional[np.ndarray] = None
    container: Optional[Container] = None
    dst_domain_id: Optional[int] = None


def build_domain_tables(
    calib_len: int = 65536, seed: int = 1000
) -> Dict[int, DomainTables]:
    """Calibrate one :class:`DomainTables` per paper domain
    (domain_id = position in :data:`DOMAIN_DATASETS`)."""
    tables: Dict[int, DomainTables] = {}
    for domain_id, (domain, dataset) in enumerate(DOMAIN_DATASETS):
        tables[domain_id] = calibrate(
            make_signal(dataset, calib_len, seed=seed + domain_id),
            DOMAIN_DEFAULTS[domain],
            domain_id=domain_id,
        )
    return tables


def generate(
    cfg: TrafficConfig, tables: Mapping[int, DomainTables], *, device=None
) -> List[Request]:
    """Synthesize one open-loop stream (deterministic in ``cfg.seed``).

    Decode/transcode payload containers are pre-encoded here with an
    offline (sync) encoder on ``device`` — the card when it is None, the
    plain versions for ``"cpu"`` — so that replay exercises only the
    serving path.  Transcode targets are drawn uniformly from the *other*
    registered domains.
    """
    rng = np.random.default_rng(cfg.seed)
    domain_ids = sorted(
        cfg.domains if cfg.domains is not None else tables.keys()
    )
    if not domain_ids:
        raise ValueError("no domains to generate traffic for")
    kinds = sorted(cfg.mix)
    weights = np.array([cfg.mix[k] for k in kinds], dtype=np.float64)
    if weights.sum() <= 0:
        raise ValueError(f"mix weights sum to zero: {cfg.mix}")
    weights /= weights.sum()

    # arrivals: Poisson process at `rate` until `duration_s`
    arrivals: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / cfg.rate)
        if t >= cfg.duration_s:
            break
        arrivals.append(t)

    requests: List[Request] = []
    encode_jobs: List[Tuple[int, int]] = []  # (request index, domain_id)
    for i, arrival in enumerate(arrivals):
        kind = kinds[int(rng.choice(len(kinds), p=weights))]
        domain_id = int(domain_ids[int(rng.integers(len(domain_ids)))])
        dataset = DOMAIN_DATASETS[domain_id][1]
        if cfg.fixed_windows is not None:
            nw = int(cfg.fixed_windows)
        else:
            nw = int(np.clip(
                np.rint(cfg.median_windows * rng.lognormal(0.0, cfg.sigma)),
                1, cfg.max_windows,
            ))
        n = tables[domain_id].config.n
        nw = max(nw, -(-_MIN_SAMPLES.get(dataset, 1) // n))
        signal = make_signal(dataset, nw * n, seed=int(rng.integers(2**31)))
        dst = None
        if kind == "transcode" and len(domain_ids) > 1:
            others = [d for d in domain_ids if d != domain_id]
            dst = int(others[int(rng.integers(len(others)))])
        elif kind == "transcode":
            dst = domain_id  # single-domain stream: re-encode in place
        requests.append(Request(
            arrival=arrival, kind=kind, domain_id=domain_id,
            dataset=dataset, num_windows=nw,
            signal=signal if kind == "encode" else None,
            dst_domain_id=dst,
        ))
        if kind != "encode":
            encode_jobs.append((i, domain_id))

    # pre-encode decode/transcode payloads, batched per domain
    if encode_jobs:
        enc = BatchEncoder(pipeline=False, device=device)
        by_domain: Dict[int, List[int]] = {}
        for i, d in encode_jobs:
            by_domain.setdefault(d, []).append(i)
        for d, idxs in by_domain.items():
            containers = enc.encode_to_host(
                [make_signal(
                    requests[i].dataset,
                    requests[i].num_windows * tables[d].config.n,
                    seed=cfg.seed + 7_000_000 + i,
                ) for i in idxs],
                tables[d],
            )
            for i, c in zip(idxs, containers):
                requests[i] = dataclasses.replace(requests[i], container=c)
    return requests


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one open-loop replay against a front-end."""

    offered_rps: float
    achieved_rps: float  # completed / wall duration
    submitted: int
    completed: int
    shed: int
    rejected_expired: int
    failed: int
    latencies_ms: List[float]  # per completed request, arrival -> result
    wall_s: float
    # per admitted request: scheduled arrival -> the return of its submit,
    # and its scheduled arrival (s after the replay's start)
    admit_lag_ms: List[float] = dataclasses.field(default_factory=list)
    admit_at_s: List[float] = dataclasses.field(default_factory=list)
    # per completed request: its batch taken for dispatch -> its result
    flush_to_result_ms: List[float] = dataclasses.field(default_factory=list)
    # the process's garbage collections during the replay: (start s after
    # the replay's start, pause ms, generation)
    gc_pauses: List[Tuple[float, float, int]] = dataclasses.field(
        default_factory=list)
    started_at: float = 0.0  # time.monotonic() at the replay's start

    def percentile(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(self.latencies_ms, q))

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile(99)

    def timings(self) -> Dict[str, float]:
        """p50/p99 of the admission lag (scheduled arrival to the return of
        its submit: the replay thread's lateness plus admission) and of the
        flush-to-result time (its batch taken for dispatch to its result:
        the engine call, the drain and the futures), in ms — where a
        request's sojourn goes besides its queue wait.  Beside them the
        garbage collections during the replay (a collection stops every
        thread) and the admissions late by more than 10 ms, with those
        whose lateness overlaps a collection."""
        out = {}
        for name, xs in (("admit_lag", self.admit_lag_ms),
                         ("flush_to_result", self.flush_to_result_ms)):
            for q in (50, 99):
                out[f"{name}_p{q}_ms"] = (
                    float(np.percentile(xs, q)) if xs else float("nan"))
        pauses = [(t, t + ms / 1e3) for t, ms, _ in self.gc_pauses]
        late = [(t, t + lag / 1e3) for t, lag in zip(self.admit_at_s,
                                                     self.admit_lag_ms)
                if lag > 10.0]
        out.update(
            gc_collections=len(self.gc_pauses),
            gc_full_collections=sum(g == 2 for *_, g in self.gc_pauses),
            gc_max_ms=max((ms for _, ms, _ in self.gc_pauses), default=0.0),
            gc_total_ms=sum(ms for _, ms, _ in self.gc_pauses),
            late_admits=len(late),
            late_admits_in_gc=sum(
                any(a < g1 and g0 < b for g0, g1 in pauses)
                for a, b in late),
        )
        return out

    def summary(self) -> Dict[str, float]:
        return {
            "offered_rps": self.offered_rps,
            "achieved_rps": self.achieved_rps,
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "rejected_expired": self.rejected_expired,
            "failed": self.failed,
            "p50_ms": self.p50_ms,
            "p95_ms": self.percentile(95),
            "p99_ms": self.p99_ms,
            "wall_s": self.wall_s,
        }


def replay(
    frontend: ServingFrontend,
    requests: List[Request],
    *,
    deadline_ms: Optional[float] = None,
    time_scale: float = 1.0,
) -> ReplayReport:
    """Drive ``frontend`` with ``requests`` open-loop.

    Each request is submitted at ``arrival * time_scale`` seconds after
    the replay starts, whether or not earlier requests completed — so
    queueing shows up as latency (and, past the queue bounds, as shed),
    exactly like a service behind real clients.  Latency is measured
    from *scheduled arrival* to result materialization (sojourn time:
    submit lateness under overload counts against the server, not the
    clock).  Returns once every submitted request resolved.  The report
    also times each request's admission lag and flush-to-result time
    (:meth:`ReplayReport.timings`).
    """
    lock = threading.Lock()
    latencies: List[float] = []
    flush_to_result: List[float] = []
    admit_lag: List[float] = []
    admit_at: List[float] = []
    gc_pauses: List[Tuple[float, float, int]] = []
    failed = [0]
    shed = 0
    expired = 0
    start = time.monotonic()
    gc_began = [0.0]

    def on_gc(phase: str, info: dict) -> None:
        now = time.monotonic()
        if phase == "start":
            gc_began[0] = now
        else:
            gc_pauses.append((gc_began[0] - start,
                              (now - gc_began[0]) * 1e3,
                              int(info["generation"])))

    def on_done(arrival_abs: float):
        def cb(fut):
            end = time.monotonic()
            with lock:
                if fut.exception() is None:
                    latencies.append((end - arrival_abs) * 1e3)
                    took = getattr(fut, "flush_to_result_s", None)
                    if took is not None:
                        flush_to_result.append(took * 1e3)
                else:
                    failed[0] += 1
        return cb

    gc.callbacks.append(on_gc)
    try:
        pending = []
        for r in requests:
            target = start + r.arrival * time_scale
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                if r.kind == "decode":
                    fut = frontend.submit_decode(
                        r.container, deadline_ms=deadline_ms
                    )
                elif r.kind == "encode":
                    fut = frontend.submit_encode(
                        r.signal, r.domain_id, deadline_ms=deadline_ms
                    )
                else:
                    fut = frontend.submit_transcode(
                        r.container, r.dst_domain_id, deadline_ms=deadline_ms
                    )
            except QueueFullError:
                shed += 1
                continue
            except DeadlineExpiredError:
                expired += 1
                continue
            admit_lag.append((time.monotonic() - target) * 1e3)
            admit_at.append(target - start)
            fut.add_done_callback(on_done(target))
            pending.append(fut)

        frontend.flush()
        for fut in pending:
            try:
                fut.result()
            except Exception:
                pass  # counted by the done callback
        wall = time.monotonic() - start
    finally:
        gc.callbacks.remove(on_gc)
    with lock:
        lat = list(latencies)
        ftr = list(flush_to_result)
        nfail = failed[0]
    span = requests[-1].arrival * time_scale if requests else 0.0
    offered = len(requests) / span if span > 0 else 0.0
    return ReplayReport(
        offered_rps=offered,
        achieved_rps=len(lat) / wall if wall > 0 else 0.0,
        submitted=len(pending),
        completed=len(lat),
        shed=shed,
        rejected_expired=expired,
        failed=nfail,
        latencies_ms=lat,
        wall_s=wall,
        admit_lag_ms=admit_lag,
        admit_at_s=admit_at,
        flush_to_result_ms=ftr,
        gc_pauses=list(gc_pauses),
        started_at=start,
    )
