"""Deterministic fault injection: corrupt containers + sabotage dispatch.
Port of ``repro/testing/faults.py`` (numpy and threads; the offline oracle
builds the port's engines).

Two halves of one chaos harness:

  * :func:`corrupt` — seeded, reproducible corruption of a container's
    wire bytes, one function per fault class the serving quarantine must
    catch (``tests/golden/corrupt/`` freezes one blob per class with
    pinned seeds; the chaos soak draws fresh ones per run).  The map
    :data:`EXPECTED_FAULT` pins which
    :class:`~repro_torch.serving.quarantine.PoisonedContainerError` fault class
    each corruption must surface as — the error taxonomy is a contract,
    tested like byte-identity is.
  * :class:`DispatcherFaultInjector` — the hook a
    :class:`~repro_torch.serving.frontend.ServingFrontend` calls at the top of
    every watchdog-covered batch dispatch: raise on the nth dispatch,
    inject artificial latency, simulate a lost device, or hang outright
    (the watchdog's prey).  Counting is process-global per injector and
    thread-safe; every injected fault is logged so tests can assert the
    chaos actually happened.

:func:`chaos_replay` drives both through an open-loop request replay and
returns a per-request outcome report — the engine of
``tests/test_torch_chaos.py`` and ``chip_smoke.py``'s serve phase.
"""
from __future__ import annotations

import dataclasses
import struct
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.container import HEADER_BYTES

__all__ = [
    "CONTAINER_FAULTS",
    "EXPECTED_FAULT",
    "ChaosReport",
    "DispatcherFaultInjector",
    "InjectedDispatchError",
    "InjectedDeviceLossError",
    "chaos_replay",
    "corrupt",
    "offline_expected",
]

_HDR = struct.Struct("<4sHHHHIQIQHHI")  # mirrors core.container._HDR
_EXT3_SIZE = 4

# byte offsets of the header fields corruption targets (see container.py)
_OFF_VERSION = 4
_OFF_NUM_WINDOWS = 24
_OFF_MAX_SYMLEN = 36
_OFF_DOMAIN_ID = 38
_OFF_CRC = 40

#: every container fault class :func:`corrupt` can inject, in the order
#: the chaos soak cycles through them
CONTAINER_FAULTS: Tuple[str, ...] = (
    "flip-words",
    "flip-sidecar",
    "flip-crc",
    "flip-header",
    "truncate",
    "version-skew",
    "bad-magic",
    "reserved-flags",
    "wrong-table",
)

#: corruption -> the fault class(es) the quarantine must report it as.
#: "wrong-table" depends on routing: a flipped domain_id lands on
#: plan-mismatch when the new id resolves to differently-configured
#: tables, unroutable when it resolves to nothing.
EXPECTED_FAULT: Dict[str, Tuple[str, ...]] = {
    "flip-words": ("crc-mismatch",),
    "flip-sidecar": ("crc-mismatch",),
    "flip-crc": ("crc-mismatch",),
    "flip-header": ("header-mismatch",),
    "truncate": ("truncated",),
    "version-skew": ("bad-version",),
    "bad-magic": ("bad-magic",),
    "reserved-flags": ("reserved-flags",),
    "wrong-table": ("plan-mismatch", "unroutable"),
}


def _layout(data: bytes) -> Tuple[int, int, int]:
    """(payload_off, words_bytes, sidecar_bytes) of a well-formed blob."""
    (_, version, _, _, _, num_words, _, _, _, _, _, _) = _HDR.unpack_from(
        data, 0
    )
    off = HEADER_BYTES + (_EXT3_SIZE if version == 3 else 0)
    return off, num_words * 8, num_words


def corrupt(data: bytes, fault: str, seed: int = 0) -> bytes:
    """Return ``data`` corrupted with ``fault``, deterministically.

    ``data`` must be a well-formed container blob (the function reads its
    header to aim); the same ``(data, fault, seed)`` triple always
    produces the same corrupt bytes — a quarantine record is reproducible
    from its fault class and seed alone.
    """
    rng = np.random.default_rng(seed)
    buf = bytearray(data)
    off, words_bytes, sidecar_bytes = _layout(data)
    if fault == "flip-words":
        if not words_bytes:
            raise ValueError("container has no words to corrupt")
        pos = off + int(rng.integers(0, words_bytes))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
    elif fault == "flip-sidecar":
        pos = off + words_bytes + int(rng.integers(0, sidecar_bytes))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
    elif fault == "flip-crc":
        buf[_OFF_CRC + int(rng.integers(0, 4))] ^= 1 << int(
            rng.integers(0, 8)
        )
    elif fault == "flip-header":
        # num_windows: CRC-blind, caught only by the deep header-vs-grid
        # consistency check — the exact hole this fault class pins
        buf[_OFF_NUM_WINDOWS] ^= 0x01
    elif fault == "truncate":
        cut = int(rng.integers(8, len(buf)))
        del buf[cut:]
    elif fault == "version-skew":
        struct.pack_into("<H", buf, _OFF_VERSION, 9)
    elif fault == "bad-magic":
        buf[0:4] = b"JUNK"
    elif fault == "reserved-flags":
        (_, version, *_rest) = _HDR.unpack_from(data, 0)
        if version != 3:
            raise ValueError(
                "reserved-flags needs a v3 container (the flags word is "
                f"the v3 extension), got v{version}"
            )
        buf[HEADER_BYTES + 1] |= 0x80  # set flags bit 15 (reserved)
    elif fault == "wrong-table":
        buf[_OFF_DOMAIN_ID] ^= 0x01
    else:
        raise ValueError(
            f"unknown fault {fault!r}; choose from {CONTAINER_FAULTS}"
        )
    return bytes(buf)


# ---------------------------------------------------------------------------
# Dispatcher sabotage.
# ---------------------------------------------------------------------------
class InjectedDispatchError(RuntimeError):
    """A deliberately injected transient dispatch fault (retryable)."""


class InjectedDeviceLossError(RuntimeError):
    """A deliberately injected simulated device loss (retryable — the
    serving story for device loss is fail-over to a re-dispatch)."""


class DispatcherFaultInjector:
    """Sabotage hook for a
    :class:`~repro_torch.serving.frontend.ServingFrontend`.

    Pass as ``fault_injector=``; the frontend calls
    :meth:`on_dispatch` inside the watchdog window at the top of every
    micro-batch dispatch.  Dispatches are numbered 1, 2, 3, ... in call
    order (thread-safe), and each schedule keys on that number:

    ``fail_on``
        dispatch numbers that raise :class:`InjectedDispatchError` —
        a transient engine crash the retry policy should absorb.
    ``latency_on``
        ``{dispatch_number: seconds}`` of artificial stall before the
        engine call — deadline pressure without failure.
    ``hang_on``
        dispatch numbers that block until :meth:`release` (or
        ``hang_timeout_s`` as a test-deadlock backstop) — the watchdog's
        target.
    ``device_loss_on``
        dispatch numbers that raise :class:`InjectedDeviceLossError`.

    ``injected`` logs every fault actually fired as ``(n, kind)`` so a
    chaos test can assert its faults happened (a soak that silently
    injected nothing proves nothing).
    """

    def __init__(
        self,
        *,
        fail_on: Iterable[int] = (),
        latency_on: Optional[Dict[int, float]] = None,
        hang_on: Iterable[int] = (),
        device_loss_on: Iterable[int] = (),
        hang_timeout_s: float = 30.0,
    ):
        self.fail_on = set(fail_on)
        self.latency_on = dict(latency_on or {})
        self.hang_on = set(hang_on)
        self.device_loss_on = set(device_loss_on)
        self.hang_timeout_s = hang_timeout_s
        self._release = threading.Event()
        self._lock = threading.Lock()
        self._count = 0
        self.injected: List[Tuple[int, str]] = []

    @property
    def dispatches(self) -> int:
        """Dispatch calls observed so far."""
        with self._lock:
            return self._count

    def release(self) -> None:
        """Unblock every hung dispatch (hangs are one-shot per number)."""
        self._release.set()

    def on_dispatch(self, key: Any, members: Sequence[Any]) -> None:
        with self._lock:
            self._count += 1
            n = self._count
        if n in self.latency_on:
            with self._lock:
                self.injected.append((n, "latency"))
            time.sleep(self.latency_on[n])
        if n in self.hang_on:
            with self._lock:
                self.injected.append((n, "hang"))
            self._release.wait(self.hang_timeout_s)
        if n in self.device_loss_on:
            with self._lock:
                self.injected.append((n, "device-loss"))
            raise InjectedDeviceLossError(
                f"injected device loss on dispatch #{n} (queue {key!r})"
            )
        if n in self.fail_on:
            with self._lock:
                self.injected.append((n, "fail"))
            raise InjectedDispatchError(
                f"injected transient fault on dispatch #{n} (queue {key!r})"
            )


# ---------------------------------------------------------------------------
# The chaos soak driver.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChaosReport:
    """Per-request accounting of one :func:`chaos_replay` run.

    The zero-silent-drops invariant is structural: every submitted
    request lands in exactly one of ``ok`` / ``poisoned`` /
    ``dispatch_failed`` / ``rejected`` / ``untyped_failures`` /
    ``hangs``, and their sum is ``total``.
    """

    total: int = 0
    clean: int = 0  # submitted uncorrupted
    corrupted: int = 0  # submitted with injected corruption
    ok: int = 0  # resolved with a result
    poisoned: int = 0  # typed poison outcome (future or admission)
    dispatch_failed: int = 0  # typed DispatchFailedError
    rejected: int = 0  # typed admission rejection (shed/expired/closed)
    untyped_failures: int = 0  # anything else — a chaos-test FAILURE
    hangs: int = 0  # futures that never resolved — a chaos-test FAILURE
    clean_mismatches: int = 0  # clean result != offline expected — FAILURE
    clean_ok: int = 0  # clean requests that resolved with a result
    outcomes: List[Tuple[int, str, str]] = dataclasses.field(
        default_factory=list
    )  # (request index, outcome, detail)

    @property
    def accounted(self) -> int:
        return (
            self.ok + self.poisoned + self.dispatch_failed + self.rejected
            + self.untyped_failures + self.hangs
        )


def chaos_replay(
    frontend,
    requests: Sequence[Any],
    *,
    corrupt_frac: float = 0.05,
    seed: int = 0,
    faults: Sequence[str] = CONTAINER_FAULTS,
    expected: Optional[Dict[int, Any]] = None,
    result_timeout_s: float = 120.0,
    deadline_ms: Optional[float] = None,
) -> ChaosReport:
    """Open-loop replay of ``requests`` with seeded payload corruption.

    ``requests`` are :class:`repro_torch.serving.traffic.Request` records (only
    ``kind`` / ``signal`` / ``domain_id`` / ``container`` /
    ``dst_domain_id`` are read).  A deterministic ``corrupt_frac``
    fraction of the container-carrying requests (decode/transcode) is
    corrupted, cycling through ``faults``; every request is submitted
    (stragglers shed by admission count as typed rejections), then every
    future is awaited with a hard timeout — an unresolved future is a
    **hang**, the one outcome the chaos contract forbids outright.

    ``expected`` maps request index -> the offline engines' result for
    clean requests (``np.ndarray`` for decode/encode, container bytes for
    transcode/encode); mismatches count in ``clean_mismatches``.
    """
    from repro_torch.core.container import ContainerFormatError
    from repro_torch.serving.frontend import (
        DispatchFailedError,
        FrontendError,
    )
    from repro_torch.serving.quarantine import PoisonedContainerError

    rng = np.random.default_rng(seed)
    report = ChaosReport(total=len(requests))
    corruptible = [
        i for i, r in enumerate(requests)
        if r.kind in ("decode", "transcode")
    ]
    n_corrupt = int(round(corrupt_frac * len(corruptible)))
    corrupt_idx = {
        int(i): faults[k % len(faults)]
        for k, i in enumerate(
            rng.choice(corruptible, size=n_corrupt, replace=False)
            if n_corrupt else []
        )
    }

    futures: List[Optional[Any]] = []
    admission: List[Optional[Tuple[str, str]]] = []
    for i, r in enumerate(requests):
        fault = corrupt_idx.get(i)
        if fault is None:
            report.clean += 1
        else:
            report.corrupted += 1
        fut = None
        outcome = None
        try:
            if r.kind == "encode":
                fut = frontend.submit_encode(
                    np.asarray(r.signal), r.domain_id,
                    deadline_ms=deadline_ms,
                )
            else:
                blob = r.container.to_bytes()
                if fault is not None:
                    try:
                        blob = corrupt(blob, fault, seed=seed + i)
                    except ValueError:
                        # version-gated fault (reserved-flags needs a v3
                        # blob): substitute a CRC flip so the request is
                        # still corrupted, deterministically
                        fault = "flip-crc"
                        corrupt_idx[i] = fault
                        blob = corrupt(blob, fault, seed=seed + i)
                if r.kind == "decode":
                    fut = frontend.submit_decode(
                        blob, deadline_ms=deadline_ms
                    )
                else:
                    fut = frontend.submit_transcode(
                        blob, r.dst_domain_id, deadline_ms=deadline_ms
                    )
        except (ContainerFormatError, PoisonedContainerError) as e:
            # typed poison caught at admission (header-visible corruption)
            outcome = ("poisoned", f"admission: {e}")
        except KeyError as e:
            # unroutable (e.g. wrong-table flipped to an unknown domain)
            outcome = ("poisoned", f"admission: {e}")
        except DispatchFailedError as e:
            outcome = ("dispatch-failed", f"admission: {e}")
        except FrontendError as e:
            outcome = ("rejected", f"admission: {e}")
        futures.append(fut)
        admission.append(outcome)

    frontend.flush()
    deadline = time.monotonic() + result_timeout_s
    for i, (fut, outcome) in enumerate(zip(futures, admission)):
        fault = corrupt_idx.get(i)
        if outcome is None:
            try:
                left = max(deadline - time.monotonic(), 0.0)
                result = fut.result(timeout=left)
                outcome = ("ok", "")
            except PoisonedContainerError as e:
                outcome = ("poisoned", str(e))
            except DispatchFailedError as e:
                outcome = ("dispatch-failed", str(e))
            except FrontendError as e:
                outcome = ("rejected", str(e))
            except TimeoutError:
                outcome = ("hang", "future never resolved")
            except BaseException as e:  # noqa: BLE001 — tallied as untyped
                outcome = ("untyped", repr(e))
        kind, detail = outcome
        if kind == "ok":
            report.ok += 1
            if fault is None:
                report.clean_ok += 1
                want = (expected or {}).get(i)
                if want is not None and not _results_equal(result, want):
                    report.clean_mismatches += 1
                    outcome = ("ok", "MISMATCH vs offline")
        elif kind == "poisoned":
            report.poisoned += 1
        elif kind == "dispatch-failed":
            report.dispatch_failed += 1
        elif kind == "rejected":
            report.rejected += 1
        elif kind == "hang":
            report.hangs += 1
        else:
            report.untyped_failures += 1
        report.outcomes.append((i, outcome[0], outcome[1]))
    return report


def offline_expected(
    requests: Sequence[Any], tables, *, device=None
) -> Dict[int, Any]:
    """Index -> the offline (sync, unpipelined) engines' result for every
    request in a :mod:`repro_torch.serving.traffic` stream — the
    byte-identity oracle :func:`chaos_replay` compares clean results
    against (``np.ndarray`` for decode, container bytes for
    encode/transcode).  The engines run on ``device``: the card when it is
    None (and an error without one), the plain versions for ``"cpu"``."""
    from repro_torch.serving.batch_decode import BatchDecoder
    from repro_torch.serving.batch_encode import BatchEncoder
    from repro_torch.serving.transcode import Transcoder

    dec = BatchDecoder(pipeline=False, device=device)
    enc = BatchEncoder(pipeline=False, device=device)
    tr = Transcoder(decoder=dec, encoder=enc)
    by_dec: Dict[int, List[int]] = {}
    by_enc: Dict[int, List[int]] = {}
    by_tr: Dict[Tuple[int, int], List[int]] = {}
    for i, r in enumerate(requests):
        if r.kind == "decode":
            by_dec.setdefault(r.domain_id, []).append(i)
        elif r.kind == "encode":
            by_enc.setdefault(r.domain_id, []).append(i)
        else:
            by_tr.setdefault((r.domain_id, r.dst_domain_id), []).append(i)
    expected: Dict[int, Any] = {}
    for d, idxs in by_dec.items():
        out = dec.decode(
            [requests[i].container for i in idxs], tables[d]
        ).to_host()
        expected.update(zip(idxs, out))
    for d, idxs in by_enc.items():
        out = enc.encode(
            [requests[i].signal for i in idxs], tables[d]
        ).to_host()
        expected.update((i, c.to_bytes()) for i, c in zip(idxs, out))
    for (src, dst), idxs in by_tr.items():
        out = tr.transcode(
            [requests[i].container for i in idxs],
            tables[src], tables[dst],
            dst_domain_ids=[dst] * len(idxs),
        ).to_host()
        expected.update((i, c.to_bytes()) for i, c in zip(idxs, out))
    return expected


def _results_equal(got: Any, want: Any) -> bool:
    to_bytes = getattr(got, "to_bytes", None)
    if to_bytes is not None:
        got = to_bytes()
    if isinstance(want, (bytes, bytearray)):
        return bytes(got) == bytes(want)
    return np.array_equal(np.asarray(got), np.asarray(want))
