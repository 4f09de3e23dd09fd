"""Per-request poison quarantine: the serving fault taxonomy.  Port of
``repro/serving/quarantine.py``.

FPTC's asymmetry puts the server on the receiving end of containers from
flaky low-power encoders over lossy links.  Offline, a corrupt blob raising
out of ``decode()`` is right — the caller owns the batch.  In serving, one
poisoned container must not take down the requests that share its batch:
the engines' ``quarantine=True`` mode excludes the poisoned signal from its
bucket (the rest of the batch completes byte-identically to a clean run —
per-signal streams are independent, so exclusion changes padding only) and
the drain returns a typed per-signal outcome instead of raising batch-wide.

This module owns that outcome type (:class:`PoisonedContainerError`), the
fault-class vocabulary (the wire-format faults of
:mod:`repro_torch.core.container`, plus the engine-level classes below),
and the deep validation pass that runs at staging:

  * wire-format parse — :meth:`Container.from_bytes` (magic / version /
    reserved flags / truncation / CRC / max_symlen), typed with byte
    offsets;
  * **header consistency** — the common header is not covered by the CRC,
    so CRC-blind header flips are caught structurally: ``num_windows`` must
    equal ``ceil(signal_length / n)`` and ``num_symbols`` must match the
    window grid (minus the zero planes for v3);
  * **sidecar consistency** — ``sum(symlen) == num_symbols`` ties the
    CRC-covered sidecar to the CRC-blind header count;
  * **plan routing** — an unknown ``domain_id`` or a container/tables
    config mismatch (``core.codec.validate_container_tables``).

The device-side histogram-gap flag (an encode-time fault) rides the same
taxonomy: ``EncodedBatch`` drains demote it from batch-fatal to per-signal
under ``quarantine=True``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from repro_torch.core.calibration import DomainTables
from repro_torch.core.codec import validate_container_tables
from repro_torch.core.container import (
    FAULT_BAD_MAGIC,
    FAULT_BAD_VERSION,
    FAULT_CRC_MISMATCH,
    FAULT_HEADER_MISMATCH,
    FAULT_RESERVED_FLAGS,
    FAULT_TRUNCATED,
    Container,
    ContainerFormatError,
)

__all__ = [
    "PoisonedContainerError",
    "FAULT_BAD_MAGIC",
    "FAULT_BAD_VERSION",
    "FAULT_CRC_MISMATCH",
    "FAULT_HEADER_MISMATCH",
    "FAULT_RESERVED_FLAGS",
    "FAULT_TRUNCATED",
    "FAULT_SIDECAR_MISMATCH",
    "FAULT_PLAN_MISMATCH",
    "FAULT_UNROUTABLE",
    "FAULT_HISTOGRAM_GAP",
    "FAULT_UNKNOWN",
    "classify_fault",
    "validate_container",
    "validate_or_poison",
]

# Engine-level fault classes (the wire-format classes come from
# core.container).
FAULT_SIDECAR_MISMATCH = "sidecar-mismatch"
FAULT_PLAN_MISMATCH = "plan-mismatch"
FAULT_UNROUTABLE = "unroutable"
FAULT_HISTOGRAM_GAP = "histogram-gap"
FAULT_UNKNOWN = "unknown"


class PoisonedContainerError(Exception):
    """One signal's typed per-request outcome after quarantine.

    Carries the quarantine record: ``index`` (the signal's position in its
    submitted batch), ``fault`` (one of the ``FAULT_*`` classes) and
    ``offset`` (the byte offset of the offending field, where the
    wire-format parse knows one).  Raised per signal — never batch-wide —
    by the engines' ``quarantine=True`` drains.
    """

    def __init__(
        self,
        message: str,
        *,
        index: Optional[int] = None,
        fault: str = FAULT_UNKNOWN,
        offset: Optional[int] = None,
    ):
        super().__init__(message)
        self.index = index
        self.fault = fault
        self.offset = offset

    def __str__(self) -> str:
        where = []
        if self.index is not None:
            where.append(f"container[{self.index}]")
        if self.offset is not None:
            where.append(f"byte offset {self.offset}")
        loc = f" ({', '.join(where)})" if where else ""
        return f"[{self.fault}] {self.args[0]}{loc}"

    @classmethod
    def wrap(
        cls, exc: BaseException, index: Optional[int] = None
    ) -> "PoisonedContainerError":
        """Build the per-request outcome from a validation exception,
        keeping its fault class and offset when it carries them."""
        if isinstance(exc, PoisonedContainerError):
            if exc.index is None and index is not None:
                exc.index = index
            return exc
        fault = classify_fault(exc)
        offset = getattr(exc, "offset", None)
        if index is None:
            index = getattr(exc, "index", None)
        # ContainerFormatError decorates __str__ with the same record this
        # class renders; use its bare message so it is not printed twice
        if isinstance(exc, ContainerFormatError) and exc.args:
            message = str(exc.args[0])
        else:
            message = str(exc)
        err = cls(message, index=index, fault=fault, offset=offset)
        err.__cause__ = exc
        return err


def classify_fault(exc: BaseException) -> str:
    """Map a validation exception onto the fault-class vocabulary."""
    fault = getattr(exc, "fault", None)
    if fault is not None:
        return fault
    if isinstance(exc, KeyError):
        return FAULT_UNROUTABLE
    if isinstance(exc, ValueError):
        msg = str(exc)
        if "plan_key" in msg or "does not match" in msg:
            return FAULT_PLAN_MISMATCH
        if "histogram gap" in msg or "no codeword" in msg:
            return FAULT_HISTOGRAM_GAP
    return FAULT_UNKNOWN


def _lookup_tables(container: Container, tables) -> DomainTables:
    if isinstance(tables, DomainTables):
        return tables
    try:
        return tables[container.domain_id]
    except KeyError:
        raise PoisonedContainerError(
            f"no DomainTables registered for "
            f"domain_id={container.domain_id}",
            fault=FAULT_UNROUTABLE,
        ) from None


def validate_container(
    container: Container,
    tables: Union[DomainTables, dict, None] = None,
    *,
    index: Optional[int] = None,
) -> None:
    """Deep (engine-level) validation of an already-parsed container.

    ``from_bytes`` catches everything the CRC covers; the CRC does not cover
    the header, so this pass ties the header's CRC-blind counts to each
    other and to the CRC-covered sidecar, then checks the container/tables
    pairing.  Raises :class:`PoisonedContainerError`.
    """

    def _poison(message: str, fault: str) -> None:
        raise PoisonedContainerError(message, index=index, fault=fault)

    n, e = container.n, container.e
    if n <= 0 or e <= 0 or e > n:
        _poison(
            f"header config (n={n}, e={e}) is not a valid window shape",
            FAULT_HEADER_MISMATCH,
        )
    want_windows = -(-container.signal_length // n)
    if container.num_windows != want_windows:
        _poison(
            f"header num_windows={container.num_windows} does not cover "
            f"signal_length={container.signal_length} at n={n} "
            f"(want {want_windows})",
            FAULT_HEADER_MISMATCH,
        )
    if container.zero_planes:
        kept_rows = container.num_windows - int(container.zrow.sum())
        kept_cols = e - int(container.zcol.sum())
        want_symbols = kept_rows * kept_cols
    else:
        want_symbols = container.num_windows * e
    if container.num_symbols != want_symbols:
        _poison(
            f"header num_symbols={container.num_symbols} does not match "
            f"the window grid (want {want_symbols})",
            FAULT_HEADER_MISMATCH,
        )
    if int(container.symlen.sum()) != container.num_symbols:
        _poison(
            f"symlen sidecar sums to {int(container.symlen.sum())} "
            f"symbols but the header promises {container.num_symbols}",
            FAULT_SIDECAR_MISMATCH,
        )
    if tables is not None:
        tab = _lookup_tables(container, tables)
        try:
            validate_container_tables(container.plan_key, tab)
        except ValueError as exc:
            raise PoisonedContainerError(
                str(exc), index=index, fault=FAULT_PLAN_MISMATCH
            ) from exc


def validate_or_poison(
    item, index: int, tables=None
) -> Tuple[Optional[Container], Optional[PoisonedContainerError]]:
    """The quarantine staging pre-pass for one batch slot.

    ``item`` is raw bytes (any bytes-like) or a parsed :class:`Container`.
    Returns ``(container, None)`` when it survives the wire-format and deep
    validation against ``tables``, else ``(None, error)`` with the typed
    per-request outcome — it never raises.
    """
    try:
        if isinstance(item, Container):
            container = item
        else:
            container = Container.from_bytes(item, index=index)
        validate_container(container, tables, index=index)
        return container, None
    except Exception as exc:  # noqa: BLE001 — every fault becomes typed
        return None, PoisonedContainerError.wrap(exc, index)
