"""Compressed container: header + SymLen words + symlen sidecar.

The container is the unit of archival/transmission.  Header fields make every
container self-describing (given the domain's calibrated tables, which are
deployed once per domain — paper §3.4, Fig. 4).

Byte layout (little-endian), common header (all versions):
  magic           4 bytes  b"FPTC"
  version         u16      1, 2 or 3
  l_max           u16
  n, e            u16, u16
  num_words       u32
  num_symbols     u64      (v3: the CODED symbol count, post-suppression)
  num_windows     u32
  signal_length   u64
  max_symlen      u16
  domain_id       u16
  crc             u32      (fault detection; coverage is version-dependent)

Version 1/2 payload:
  words           num_words * 8 bytes (uint64 LE)
  symlen          num_words * 1 byte  (uint8; symlen <= 64)

Version 3 adds a 4-byte extension header immediately after the common
header, before the payload:
  flags           u16      bits 0-1: predictor id (0 none / 1 delta /
                           2 linear2); bit 2: zero-plane suppression;
                           bits 3-15 reserved, must be zero
  predict_bands   u16      leading coefficient bands the predictor covers

and, when flag bit 2 (zero planes) is set, two bitmaps after the symlen
sidecar:
  zrow bitmap     ceil(num_windows / 8) bytes (LSB-first per byte)
  zcol bitmap     ceil(e / 8) bytes

Port of ``repro/core/container.py``: the same wire format, numpy only.

**v3 design notes** (ROADMAP item 3).  v3 is a *lossless re-coding of the
quantized levels* — reconstruction at a given quant table is bit-identical
to v2; only the entropy-coded byte count changes.  Two optional stages, both
applied to the level grid ``[num_windows, e]`` before entropy coding:

  1. *Windowed prediction* (cuSZ+-style): bands ``k < predict_bands`` store
     the mod-256 residual against the previous window's level (delta) or a
     two-point linear extrapolation (linear2), with a virtual all-128
     history before the first window.  Smooth domains pile the residual
     histogram onto 128, which the canonical Huffman stage converts into
     shorter codes.  Exact math: ``repro_torch.core.quantize.predict_levels`` /
     ``unpredict_levels``.
  2. *Zero-plane suppression* (FZ-GPU-style): window rows and coefficient
     columns whose coded symbols are ALL the zero bin are dropped from the
     stream entirely and recorded as the two bitmaps — the bit-transposed
     zero indicator planes.  The surviving cells keep row-major order, so
     ``num_symbols`` shrinks to ``(rows kept) * (cols kept)``.  Layout
     contract: ``repro_torch.core.symlen.zero_plane_masks`` /
     ``v3_expand_index``.

The Huffman book of a v3 domain is calibrated on the *coded* symbols, so a
v3 container must decode with v3-calibrated tables — the coding triple is
part of the container's plan key and of table validation.

Checksum: version 2 writes one crc32 over words || symlen, so bit flips in
either the payload words or the sidecar fail loudly at ``from_bytes``;
version 3 extends the coverage to words || symlen || zrow || zcol.
Version-1 containers (whose crc covered only the symlen sidecar — payload
flips decoded silently to garbage) are still readable with the legacy
sidecar-only check.

**Forever-decode promise:** every version this module has ever written
(v1, v2, v3) stays readable by ``from_bytes`` permanently; the golden-blob
suite (tests/golden/) pins byte-exact decode of all of them.  Parsing is
zero-copy on the hot decode-staging path: header and payload sections are
sliced as ``memoryview``s and wrapped with ``np.frombuffer`` (no bytes
copies); the returned arrays alias — and keep alive — the input buffer.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Container",
    "ContainerFormatError",
    "ContainerHeader",
    "HEADER_BYTES",
    "SUPPORTED_VERSIONS",
    "FAULT_BAD_MAGIC",
    "FAULT_BAD_VERSION",
    "FAULT_RESERVED_FLAGS",
    "FAULT_CRC_MISMATCH",
    "FAULT_HEADER_MISMATCH",
    "FAULT_TRUNCATED",
]

_MAGIC = b"FPTC"
_VERSION = 2  # default wire version for trivially-coded containers
_V3 = 3  # written iff the coding triple is non-trivial
_HDR = struct.Struct("<4sHHHHIQIQHHI")
_EXT3 = struct.Struct("<HH")  # v3 extension: flags, predict_bands
HEADER_BYTES = _HDR.size
SUPPORTED_VERSIONS = (1, 2, 3)

_FLAG_PRED_MASK = 0x0003  # bits 0-1: predictor id
_FLAG_ZPLANES = 0x0004  # bit 2: zero-plane suppression

# Wire-format fault classes (the serving quarantine taxonomy).
FAULT_BAD_MAGIC = "bad-magic"
FAULT_BAD_VERSION = "bad-version"
FAULT_RESERVED_FLAGS = "reserved-flags"
FAULT_CRC_MISMATCH = "crc-mismatch"
FAULT_HEADER_MISMATCH = "header-mismatch"
FAULT_TRUNCATED = "truncated"

# Byte offsets of the header fields inside _HDR (for fault records).
_OFF_MAGIC = 0
_OFF_VERSION = 4
_OFF_SIGNAL_LENGTH = 28
_OFF_MAX_SYMLEN = 36
_OFF_CRC = 40


class ContainerFormatError(ValueError):
    """A buffer failed container wire-format validation.

    ``ValueError`` subclass so every legacy ``except ValueError`` call site
    keeps working; additionally carries the machine-readable quarantine
    record: the fault class (one of the ``FAULT_*`` constants), the byte
    ``offset`` of the offending field where known (``None`` otherwise), and
    the container's ``index`` within its submitted batch when the caller
    supplied one.
    """

    def __init__(self, message, *, fault, offset=None, index=None):
        super().__init__(message)
        self.fault = fault
        self.offset = offset
        self.index = index

    def __str__(self):
        where = []
        if self.index is not None:
            where.append(f"container[{self.index}]")
        if self.offset is not None:
            where.append(f"byte offset {self.offset}")
        loc = f" ({', '.join(where)})" if where else ""
        return f"[{self.fault}] {self.args[0]}{loc}"


@dataclasses.dataclass(frozen=True)
class ContainerHeader:
    """The parsed common header — what ``Container.peek`` returns.

    Admission-time routing (the serving frontend needs a plan key before it
    is worth paying for the full CRC pass) reads only this."""

    version: int
    n: int
    e: int
    l_max: int
    domain_id: int
    num_words: int
    num_symbols: int
    num_windows: int
    signal_length: int
    max_symlen: int
    coding: Tuple[int, int, bool]

    @property
    def plan_key(self) -> Tuple[int, int, int, int, Tuple[int, int, bool]]:
        return (self.domain_id, self.n, self.e, self.l_max, self.coding)


def _pack_bitmap(mask: np.ndarray) -> bytes:
    """bool[N] -> ceil(N/8) bytes, LSB-first within each byte."""
    return np.packbits(
        np.asarray(mask, dtype=bool), bitorder="little"
    ).tobytes()


def _unpack_bitmap(buf, n: int) -> np.ndarray:
    """ceil(n/8) bytes -> bool[n] (LSB-first)."""
    bits = np.unpackbits(
        np.frombuffer(buf, dtype=np.uint8), bitorder="little"
    )
    return bits[:n].astype(bool)


@dataclasses.dataclass
class Container:
    words: np.ndarray  # uint64[W]
    symlen: np.ndarray  # uint8[W]
    num_symbols: int
    num_windows: int
    signal_length: int
    n: int
    e: int
    l_max: int
    domain_id: int = 0
    # --- v3 coding state (all defaults give the classic v2 container) ---
    predictor: int = 0  # 0 none / 1 delta / 2 linear2
    predict_bands: int = 0
    zero_planes: bool = False
    zrow: Optional[np.ndarray] = None  # bool[num_windows] when zero_planes
    zcol: Optional[np.ndarray] = None  # bool[e] when zero_planes

    @property
    def num_words(self) -> int:
        return int(self.words.shape[0])

    @property
    def max_symlen(self) -> int:
        return int(self.symlen.max()) if self.symlen.size else 0

    @property
    def coding(self) -> Tuple[int, int, bool]:
        """The (pred_id, predict_bands, zero_planes) coding triple — matches
        ``CodecConfig.coding`` of the tables that encoded this container."""
        return (self.predictor, self.predict_bands, bool(self.zero_planes))

    @property
    def version(self) -> int:
        """Wire version ``to_bytes`` will emit: 3 iff any v3 stage is on."""
        return _V3 if self.coding != (0, 0, False) else _VERSION

    @property
    def plan_key(self) -> Tuple[int, int, int, int, Tuple[int, int, bool]]:
        """Grouping key for batched decoding: containers sharing a
        (domain_id, n, e, l_max, coding) decode with the same tables, iDCT
        basis, coding transform and kernel specialization, so they can ride
        one fused dispatch."""
        return (self.domain_id, self.n, self.e, self.l_max, self.coding)

    def words_u32(self) -> Tuple[np.ndarray, np.ndarray]:
        """Payload words as a (hi, lo) uint32 pair (the reference's TPU
        layout; the port's device path reads the native 64-bit words)."""
        from repro_torch.core.symlen import words_to_u32

        return words_to_u32(self.words)

    @property
    def compressed_bytes(self) -> int:
        total = HEADER_BYTES + self.num_words * 8 + self.num_words
        if self.version == _V3:
            total += _EXT3.size
            if self.zero_planes:
                total += (self.num_windows + 7) // 8 + (self.e + 7) // 8
        return total

    @property
    def original_bytes(self) -> int:
        return self.signal_length * 4  # float32 samples

    @property
    def compression_ratio(self) -> float:
        return self.original_bytes / max(self.compressed_bytes, 1)

    def to_bytes(self) -> bytes:
        words_b = self.words.astype("<u8").tobytes()
        symlen_b = self.symlen.astype(np.uint8).tobytes()
        version = self.version
        ext = b""
        bitmaps = b""
        if version == _V3:
            if not (0 <= self.predictor <= 2):
                raise ValueError(f"bad predictor id {self.predictor}")
            flags = self.predictor & _FLAG_PRED_MASK
            if self.zero_planes:
                flags |= _FLAG_ZPLANES
                if self.zrow is None or self.zcol is None:
                    raise ValueError(
                        "zero_planes container needs zrow/zcol masks"
                    )
                if len(self.zrow) != self.num_windows or len(
                    self.zcol
                ) != self.e:
                    raise ValueError("zrow/zcol mask length mismatch")
                bitmaps = _pack_bitmap(self.zrow) + _pack_bitmap(self.zcol)
            ext = _EXT3.pack(flags, self.predict_bands)
        crc = zlib.crc32(symlen_b, zlib.crc32(words_b))
        if bitmaps:
            crc = zlib.crc32(bitmaps, crc)
        hdr = _HDR.pack(
            _MAGIC,
            version,
            self.l_max,
            self.n,
            self.e,
            self.num_words,
            self.num_symbols,
            self.num_windows,
            self.signal_length,
            self.max_symlen,
            self.domain_id,
            crc,
        )
        return hdr + ext + words_b + symlen_b + bitmaps

    @staticmethod
    def _parse_header(mv: memoryview, index):
        """Validate and unpack the common (+v3 ext) header of ``mv``.

        Returns ``(header, payload_off, flags_faulty_checked)`` where
        ``payload_off`` is the byte offset of the words section.  Raises
        :class:`ContainerFormatError` (fault class + byte offset + batch
        ``index``) on every malformed-header path, including truncation —
        the quarantine layer keys off these records.
        """
        if len(mv) < HEADER_BYTES:
            raise ContainerFormatError(
                f"truncated container: {len(mv)} bytes is shorter than the "
                f"{HEADER_BYTES}-byte header",
                fault=FAULT_TRUNCATED,
                offset=len(mv),
                index=index,
            )
        (
            magic,
            version,
            l_max,
            n,
            e,
            num_words,
            num_symbols,
            num_windows,
            signal_length,
            max_symlen,
            domain_id,
            crc,
        ) = _HDR.unpack_from(mv, 0)
        if magic != _MAGIC:
            raise ContainerFormatError(
                "bad magic — not an FPTC container",
                fault=FAULT_BAD_MAGIC,
                offset=_OFF_MAGIC,
                index=index,
            )
        if version not in SUPPORTED_VERSIONS:
            raise ContainerFormatError(
                f"unsupported container version {version}; this build reads "
                f"versions {SUPPORTED_VERSIONS} (the forever-decode set)",
                fault=FAULT_BAD_VERSION,
                offset=_OFF_VERSION,
                index=index,
            )
        off = HEADER_BYTES
        predictor, predict_bands, zero_planes = 0, 0, False
        if version == _V3:
            if len(mv) < off + _EXT3.size:
                raise ContainerFormatError(
                    f"truncated container: {len(mv)} bytes cuts off the "
                    f"v3 extension header",
                    fault=FAULT_TRUNCATED,
                    offset=len(mv),
                    index=index,
                )
            flags, predict_bands = _EXT3.unpack_from(mv, off)
            off += _EXT3.size
            predictor = flags & _FLAG_PRED_MASK
            zero_planes = bool(flags & _FLAG_ZPLANES)
            if flags & ~(_FLAG_PRED_MASK | _FLAG_ZPLANES):
                raise ContainerFormatError(
                    f"v3 container sets reserved flag bits "
                    f"{flags:#06x} — written by a newer build?",
                    fault=FAULT_RESERVED_FLAGS,
                    offset=HEADER_BYTES,
                    index=index,
                )
        expected = off + num_words * 9
        if zero_planes:
            expected += (num_windows + 7) // 8 + (e + 7) // 8
        if len(mv) < expected:
            raise ContainerFormatError(
                f"truncated container: have {len(mv)} bytes, header "
                f"promises {expected}",
                fault=FAULT_TRUNCATED,
                offset=len(mv),
                index=index,
            )
        hdr = ContainerHeader(
            version=version,
            n=n,
            e=e,
            l_max=l_max,
            domain_id=domain_id,
            num_words=num_words,
            num_symbols=num_symbols,
            num_windows=num_windows,
            signal_length=signal_length,
            max_symlen=max_symlen,
            coding=(predictor, predict_bands, zero_planes),
        )
        return hdr, off, crc

    @classmethod
    def peek(cls, data, *, index=None) -> ContainerHeader:
        """Header-only parse: O(1), no CRC pass over the payload.

        The serving frontend routes raw bytes to a (kind, plan) queue at
        admission with this — the full :meth:`from_bytes` validation runs
        later at staging, inside the quarantine boundary.  Raises the same
        typed :class:`ContainerFormatError` records for malformed headers
        and truncation.
        """
        return cls._parse_header(memoryview(data), index)[0]

    @classmethod
    def from_bytes(cls, data, *, index=None) -> "Container":
        """Parse a serialized container from any bytes-like buffer.

        Zero-copy: payload sections are referenced through ``memoryview``
        slices (``np.frombuffer``), not copied — the hot decode-staging path
        reads them exactly once while bucketing, so a copy here would be
        pure overhead.  The returned arrays are read-only views keeping
        ``data`` alive.

        All validation failures raise :class:`ContainerFormatError` (a
        ``ValueError``) carrying the fault class, the byte offset of the
        offending field where known, and ``index`` (the container's position
        in its batch, when the caller supplies one) — the serving quarantine
        turns these into per-request outcomes.
        """
        mv = memoryview(data)
        hdr, off, crc = cls._parse_header(mv, index)
        version = hdr.version
        predictor, predict_bands, zero_planes = hdr.coding
        num_words = hdr.num_words
        words = np.frombuffer(mv, dtype="<u8", count=num_words, offset=off)
        off += num_words * 8
        symlen = np.frombuffer(
            mv, dtype=np.uint8, count=num_words, offset=off
        )
        off += num_words
        zrow = zcol = None
        crc_calc = zlib.crc32(symlen, zlib.crc32(words))
        if version == 1:  # legacy: crc covered only the symlen sidecar
            crc_calc = zlib.crc32(symlen)
        if zero_planes:
            nrow_b = (hdr.num_windows + 7) // 8
            ncol_b = (hdr.e + 7) // 8
            bitmaps = mv[off: off + nrow_b + ncol_b]
            zrow = _unpack_bitmap(bitmaps[:nrow_b], hdr.num_windows)
            zcol = _unpack_bitmap(bitmaps[nrow_b:], hdr.e)
            crc_calc = zlib.crc32(bitmaps, crc_calc)
        if crc_calc != crc:
            raise ContainerFormatError(
                "payload CRC mismatch — corrupt container",
                fault=FAULT_CRC_MISMATCH,
                offset=_OFF_CRC,
                index=index,
            )
        c = cls(
            words=words,
            symlen=symlen,
            num_symbols=hdr.num_symbols,
            num_windows=hdr.num_windows,
            signal_length=hdr.signal_length,
            n=hdr.n,
            e=hdr.e,
            l_max=hdr.l_max,
            domain_id=hdr.domain_id,
            predictor=predictor,
            predict_bands=predict_bands,
            zero_planes=zero_planes,
            zrow=zrow,
            zcol=zcol,
        )
        if c.max_symlen != hdr.max_symlen:
            raise ContainerFormatError(
                "max_symlen header mismatch — corrupt container",
                fault=FAULT_HEADER_MISMATCH,
                offset=_OFF_MAX_SYMLEN,
                index=index,
            )
        return c
