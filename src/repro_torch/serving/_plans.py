"""Shared LRU plan cache for the serving engines (port of
``repro/serving/_plans.py``).

The engines memoize device-resident per-(domain, config) state — decode
plans (tables, iDCT basis, dequant LUT), encode plans (tables, DCT basis)
and the transcoder's (source, target) pairings of the two — keyed by
(tables identity, plan_key, device).  Keying by ``id(tables)`` is safe only
because each plan keeps its source :class:`DomainTables` alive (the
``source`` field; a :class:`TranscodePlan` through its two sub-plans), so
an id can never be reused while its cache entry exists.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Tuple, TypeVar

Plan = TypeVar("Plan")
# (domain_id, n, e, l_max, coding) — coding is the container-v3 triple
# (pred_id, predict_bands, zero_planes), (0, 0, False) for v1/v2 streams.
# Plans with different codings run different bucket math, so the coding
# splits the cache exactly like the shape parameters do.
PlanKey = Tuple[int, int, int, int, Tuple[int, int, bool]]

TRIVIAL_CODING = (0, 0, False)


def normalize_plan_key(key) -> PlanKey:
    """Accept legacy 4-tuple (domain_id, n, e, l_max) keys by appending the
    trivial coding; 5-tuples pass through."""
    key = tuple(key)
    if len(key) == 4:
        return key + (TRIVIAL_CODING,)
    if len(key) != 5:
        raise ValueError(f"malformed plan key {key!r}")
    return key[:4] + (tuple(key[4]),)


@dataclasses.dataclass(frozen=True)
class TranscodePlan:
    """Device-resident state for one (source, target) transcode pairing.

    Pairs the source's :class:`~repro_torch.serving.batch_decode.DecodePlan`
    and the target's :class:`~repro_torch.serving.batch_encode.EncodePlan`
    under one cache key, so a transcode route resolves both halves in one
    LRU lookup.  The sub-plans come from (and stay shared with) the
    decoder's and encoder's own caches, so a transcoder never duplicates
    device buffers the engines already hold.
    """

    decode: object  # DecodePlan for the source (domain, config)
    encode: object  # EncodePlan for the target (domain, config)
    src_key: PlanKey
    dst_key: PlanKey


class PlanCache:
    """Tiny LRU over plans built by an engine-supplied factory.

    ``get`` is thread-safe and **single-flight per key**: the factory runs
    OUTSIDE the cache lock (so a hit never stalls behind a concurrent
    build of a *different* key), but concurrent misses on the SAME key
    coalesce — the first caller builds, later callers wait on that build
    and share its plan.  The decode engine prefetches plans from the
    :class:`~repro_torch.serving.engine.PipelineExecutor`'s staging worker
    while the main thread dispatches, so without coalescing both could
    upload their own copy of the tables.  A failed build clears its
    in-flight marker and re-raises; coalesced waiters then retry the build
    themselves (the failure may have been the leader's alone).
    """

    def __init__(self, factory: Callable[..., Plan], maxsize: int = 32):
        self._factory = factory
        self.maxsize = maxsize
        self._plans: "OrderedDict[tuple, Plan]" = OrderedDict()
        self._building: dict = {}  # cache_key -> threading.Event
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.coalesced = 0  # gets served by waiting on another thread's build

    def get(self, tables, key, device: Any = None) -> Plan:
        """The plan for ``(tables, key, device)``, built on a miss.
        ``tables`` may be one object or a tuple of them (the transcode
        pairing); identity keying covers every element."""
        ident = (tuple(id(t) for t in tables) if isinstance(tables, tuple)
                 else id(tables))
        cache_key = (ident, key, str(device))
        waited = False
        while True:
            with self._lock:
                plan = self._plans.get(cache_key)
                if plan is not None:
                    self._plans.move_to_end(cache_key)
                    if not waited:  # a coalesced get counts once, as coalesced
                        self.hits += 1
                    return plan
                done = self._building.get(cache_key)
                if done is None:
                    # we are the build leader for this key
                    done = self._building[cache_key] = threading.Event()
                    self.misses += 1
                    break
                # same-key build in flight: wait for it, then re-check
                if not waited:
                    self.coalesced += 1
            waited = True
            done.wait()
        try:
            plan = self._factory(tables, key, device)
        except BaseException:
            with self._lock:
                self._building.pop(cache_key, None)
            done.set()  # wake waiters; they retry and surface their own error
            raise
        with self._lock:
            self._plans[cache_key] = plan
            self._building.pop(cache_key, None)
            while len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
        done.set()
        return plan

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)
