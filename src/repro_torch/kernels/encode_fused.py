"""K4: the bucket encode — signal rows -> SymLen chunk parts.

Replaces ``repro/kernels/encode_fused.py::encode_fused``, the TPU kernel
that runs DCT -> the exact ``quantize`` -> (container v3) ``predict_levels``
+ zero-plane masks -> a (code, length) lookup -> the chunk-parallel greedy
SymLen pack in one ``pallas_call``.  On the H100 it is two CUDA kernels in
a row (``csrc/encode_fused.cu``):

  * ``encode_levels`` — signals -> the coded level grid u8[K, Wp, E] (and
    under v3 the per-row ``ncoded`` and the zero-plane masks), on the DCT +
    quantize template K5 shares (``csrc/dct_quant.cuh``);
  * ``symlen_pack`` — grid + masks -> the chunk parts.

``encode_levels_gather`` is ``encode_levels`` reading its rows through a
``(flat, starts, lens)`` gather — the transcoder's decoded samples — in
place of a materialized ``f32[K, Wp * N]`` matrix; its levels equal
``encode_levels`` on the gathered matrix bit for bit.  The source's header
says what bounds each on the H100 and what its design does about it.  Packed words come back as ``(hi, lo)`` uint32 halves held
as the bit patterns of ``int32`` tensors.

``levels_kernel``'s register tile is tunable (``rw``, windows a thread;
:mod:`repro_torch.kernels.tiles`): the level wrappers take the tile they
are given (0: the kernel's own pick), and :func:`encode_fused` /
:func:`encode_fused_gather` resolve it from the tuning cache
(``tuned_blocks("encode", ...)``, the reference's
``ops.encode_bucket_fused`` consult, through this module's memo) unless
the caller pins it, as the sweep does.  No tile changes a level.

Plain versions: :func:`encode_levels_plain` and :func:`symlen_pack_plain`,
the math of the reference's XLA arm (``serving/batch_encode.py::
_encode_bucket_math(use_kernels=False)``), :func:`encode_fused_plain`, the
two in a row, and :func:`encode_levels_gather_plain`, the first after
:func:`gather_rows` (the reference's ``_gather_rows_math``).  Each wrapper here takes its plain version for CPU
tensors and launches its kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import symlen
from repro_torch.core.calibration import DeviceTables
from repro_torch.core.quantize import QuantTable, predict_levels, quantize
from repro_torch.kernels import ops
from repro_torch.kernels.dct_quant import check_quant_args
from repro_torch.kernels.tiles import coding_key
from repro_torch.tuning.autotune import BlockMemo

__all__ = [
    "TRIVIAL",
    "encode_levels",
    "encode_levels_plain",
    "symlen_pack",
    "symlen_pack_plain",
    "encode_fused",
    "encode_fused_plain",
    "gather_rows",
    "encode_levels_gather",
    "encode_levels_gather_plain",
    "encode_fused_gather",
    "tuning_plan_key",
]

TRIVIAL = (0, 0, False)  # no predictor, no zero planes: the v2 stream

Levels = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
               Optional[torch.Tensor]]


def _win_valid(counts, wp: int, e: int) -> torch.Tensor:
    """bool[K, Wp]: the true (non-padding) windows of each row."""
    win = torch.arange(wp, device=counts.device)
    return win[None, :] < (counts.long() // e)[:, None]


# ---------------------------------------------------------------------------
# Stage (a): signals -> coded grid (+ v3 masks and counts).
# ---------------------------------------------------------------------------
def encode_levels_plain(signals, counts, quant: QuantTable, basis, *, n: int,
                        e: int, coding=TRIVIAL) -> Levels:
    """The plain version of ``encode_levels`` (runs on any device).

    Returns ``(grid uint8[K, Wp, E], zrow, zcol, ncoded)``: ``grid`` is the
    quantized levels, re-coded by the v3 predictor when ``coding`` has one;
    under a v3 coding ``ncoded`` int32[K] counts each row's coded symbols,
    and with zero planes ``zrow`` bool[K, Wp] marks all-128 window rows
    (every window, padding included) and ``zcol`` bool[K, E] all-128 bands
    over the row's true windows.  v2 returns ``None`` for the last three.
    """
    coding = tuple(coding)
    k = signals.shape[0]
    levels = quantize(signals.reshape(k, -1, n) @ basis, quant)
    if coding == TRIVIAL:
        return levels, None, None, None
    pred_id, bands, zplanes = coding
    grid = predict_levels(levels, pred_id, bands)
    if not zplanes:
        return grid, None, None, counts.to(torch.int32)
    win_valid = _win_valid(counts, grid.shape[1], e)
    is_zero = grid == 128
    zrow = is_zero.all(dim=2)
    zcol = (is_zero | ~win_valid[:, :, None]).all(dim=1)
    valid = (win_valid & ~zrow)[:, :, None] & ~zcol[:, None, :]
    ncoded = valid.reshape(k, -1).sum(dim=1, dtype=torch.int32)
    return grid, zrow, zcol, ncoded


def encode_levels(signals, counts, quant: QuantTable, basis, *, n: int,
                  e: int, coding=TRIVIAL, rw: int = 0) -> Levels:
    """Signal rows f32[K, Wp * N] and true symbol counts int32[K] -> the
    coded grid and, under v3, ``(zrow, zcol, ncoded)`` (see
    :func:`encode_levels_plain`).  ``rw``: the kernel's register tile (1,
    2 or 4; 0 for its own pick, :func:`~repro_torch.kernels.tiles.
    dct_tile_shape`); the launcher refuses one that does not fit."""
    coding = tuple(coding)
    if not ops.is_cuda(signals):
        return encode_levels_plain(signals, counts, quant, basis, n=n, e=e,
                                   coding=coding)
    if signals.dtype != torch.float32 or signals.dim() != 2:
        raise TypeError(
            f"encode_levels takes f32 signal rows [K, Wp * N], got "
            f"{signals.dtype} {tuple(signals.shape)}"
        )
    k, width = signals.shape
    return _launch_levels("encode_levels", (signals.contiguous(),), k, width,
                          counts, quant, basis, n=n, e=e, coding=coding,
                          rw=rw)


def _launch_levels(name: str, rows, k: int, width: int, counts,
                   quant: QuantTable, basis, *, n: int, e: int,
                   coding, rw: int) -> Levels:
    """Check the arguments ``encode_levels`` and ``encode_levels_gather``
    share, allocate the outputs, and launch ``name``'s kernel on ``rows``
    (the signal matrix, or the flat tensor with its starts and lens)."""
    dev = rows[0].device
    if width % n or width == 0:
        raise ValueError(f"signal rows of {width} samples are not whole "
                         f"windows of N={n}")
    if counts.dtype != torch.int32 or counts.shape != (k,) or (
        counts.device != dev
    ):
        raise TypeError(f"counts must be int32[{k}] on {dev}")
    check_quant_args(dev, quant, basis, n, e, name)
    ops._check_encode_i32(width, e, n)
    if k > 65535:
        raise ValueError(f"{name} takes at most 65535 rows, got {k}")
    wp = width // n
    pred_id, bands, zplanes = coding
    counts = counts.contiguous()
    basis = basis.contiguous()
    grid = torch.empty(k, wp, e, dtype=torch.uint8, device=dev)
    zrow = zcol = ncoded = scratch = None
    if coding != TRIVIAL:
        ncoded = torch.empty(k, dtype=torch.int32, device=dev)
    if zplanes:
        zrow = torch.empty(k, wp, dtype=torch.bool, device=dev)
        zcol = torch.empty(k, e, dtype=torch.bool, device=dev)
        # per row: nonzero-band flags, kept windows, finished blocks
        scratch = torch.zeros(k, e + 2, dtype=torch.int32, device=dev)

    if k == 0:
        return grid, zrow, zcol, ncoded  # nothing to launch

    def ptr(t):
        return None if t is None else t.data_ptr()

    ops.launch(
        name, f"fptc_{name}", dev,
        *(t.data_ptr() for t in rows), counts.data_ptr(), k, wp, n, e,
        basis.data_ptr(),
        quant.zone.contiguous().data_ptr(),
        quant.scale.contiguous().data_ptr(), quant.mu.data_ptr(),
        quant.alpha1.data_ptr(), pred_id, bands, int(bool(zplanes)),
        grid.data_ptr(), ptr(zrow), ptr(zcol), ptr(ncoded), ptr(scratch),
        int(rw),
    )
    return grid, zrow, zcol, ncoded


# ---------------------------------------------------------------------------
# Stage (a), gathered: rows as runs of a flat sample tensor.
# ---------------------------------------------------------------------------
def gather_rows(flat, starts, lens, width: int) -> torch.Tensor:
    """Stage one encode bucket's signal matrix ``f32[K, width]`` from a flat
    sample tensor (the reference's ``_gather_rows_math``).

    Row ``r`` takes samples ``[starts[r], starts[r] + lens[r])`` of ``flat``
    and is exact zero past ``lens[r]`` — the layout ``BatchEncoder.encode``
    stages on the host (a decoded signal's own window tail is re-decoded
    data, not zeros, so the mask is what keeps device staging equal to the
    host path).  ``flat`` must carry at least ``width`` samples past every
    start (the transcoder pads it once by the widest bucket): this plain
    version reads the whole ``width`` before masking, as the reference's
    ``dynamic_slice`` does.
    """
    pos = torch.arange(width, device=flat.device)
    x = flat[starts.long()[:, None] + pos[None, :]]  # IndexError if short
    return torch.where(pos[None, :] < lens.long()[:, None], x,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))


def encode_levels_gather_plain(flat, starts, lens, counts, quant: QuantTable,
                               basis, *, width: int, n: int, e: int,
                               coding=TRIVIAL) -> Levels:
    """The plain version of ``encode_levels_gather`` (runs on any device):
    :func:`encode_levels_plain` of :func:`gather_rows`."""
    return encode_levels_plain(gather_rows(flat, starts, lens, width), counts,
                               quant, basis, n=n, e=e, coding=coding)


def encode_levels_gather(flat, starts, lens, counts, quant: QuantTable,
                         basis, *, width: int, n: int, e: int,
                         coding=TRIVIAL, rw: int = 0) -> Levels:
    """:func:`encode_levels` of the rows :func:`gather_rows` describes —
    flat f32[T], starts int32[K], lens int32[K] — without materializing
    them: the kernel stages each window block straight from ``flat``, and
    reads no sample past a row's ``lens``.  ``rw`` as
    :func:`encode_levels` takes it."""
    coding = tuple(coding)
    if not ops.is_cuda(flat):
        return encode_levels_gather_plain(flat, starts, lens, counts, quant,
                                          basis, width=width, n=n, e=e,
                                          coding=coding)
    dev = flat.device
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise TypeError(f"encode_levels_gather takes a flat f32 tensor, got "
                        f"{flat.dtype} {tuple(flat.shape)}")
    k = starts.shape[0] if starts.dim() == 1 else -1
    if any(t.dtype != torch.int32 or t.shape != (k,) or t.device != dev
           for t in (starts, lens)):
        raise TypeError(f"starts and lens must be int32[K] on {dev}, got "
                        f"{starts.dtype} {tuple(starts.shape)} and "
                        f"{lens.dtype} {tuple(lens.shape)}")
    return _launch_levels("encode_levels_gather",
                          (flat.contiguous(), starts.contiguous(),
                           lens.contiguous()),
                          k, width, counts, quant, basis, n=n, e=e,
                          coding=coding, rw=rw)


# ---------------------------------------------------------------------------
# Stage (b): grid + masks -> chunk parts.
# ---------------------------------------------------------------------------
def _valid_slots(grid, zrow, zcol, counts, coding) -> torch.Tensor:
    """bool[K, Wp * E]: the grid cells that enter the stream."""
    k, wp, e = grid.shape
    if tuple(coding) == TRIVIAL:
        slot = torch.arange(wp * e, device=grid.device)
        return slot[None, :] < counts.long()[:, None]
    win_valid = _win_valid(counts, wp, e)
    if coding[2]:
        valid = (win_valid & ~zrow)[:, :, None] & ~zcol[:, None, :]
    else:
        valid = win_valid[:, :, None].expand(k, wp, e)
    return valid.reshape(k, -1)


def symlen_pack_plain(grid, zrow, zcol, counts, codes, lengths, *,
                      chunk_size: int, coding=TRIVIAL, check_gaps=True):
    """The plain version of ``symlen_pack`` (runs on any device): per row,
    ``pack_symlen_chunked_parts`` of the valid cells, plus the per-row
    histogram-gap flag.  Returns ``(hi int32[K, B, C], lo int32[K, B, C],
    symlen int32[K, B, C], words_per_chunk int32[K, B], bad bool[K])``."""
    k = grid.shape[0]
    flat = grid.reshape(k, -1).long()
    valid = _valid_slots(grid, zrow, zcol, counts, coding)
    if check_gaps:
        bad = ((lengths.long()[flat] == 0) & valid).any(dim=1)
    else:
        bad = torch.zeros(k, dtype=torch.bool, device=grid.device)
    hi, lo, sl, wpc = symlen._chunked_parts(flat, valid, codes, lengths,
                                            chunk_size)
    return hi, lo, sl, wpc, bad


def symlen_pack(grid, zrow, zcol, counts, codes, lengths, *,
                chunk_size: int, coding=TRIVIAL, check_gaps=True):
    """Coded grid uint8[K, Wp, E] (+ the v3 zero-plane masks), true symbol
    counts int32[K], codes int64[256] (uint32 codewords) and lengths
    int32[256] -> the chunk parts and the gap flags (see
    :func:`symlen_pack_plain`)."""
    coding = tuple(coding)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if not ops.is_cuda(grid):
        return symlen_pack_plain(grid, zrow, zcol, counts, codes, lengths,
                                 chunk_size=chunk_size, coding=coding,
                                 check_gaps=check_gaps)
    dev = grid.device
    if grid.dtype != torch.uint8 or grid.dim() != 3:
        raise TypeError(f"symlen_pack takes a uint8 grid [K, Wp, E], got "
                        f"{grid.dtype} {tuple(grid.shape)}")
    k, wp, e = grid.shape
    if counts.dtype != torch.int32 or counts.shape != (k,):
        raise TypeError(f"counts must be int32[{k}]")
    if codes.dtype != torch.int64 or lengths.dtype != torch.int32 or (
        codes.shape != (256,) or lengths.shape != (256,)
    ):
        raise TypeError("symlen_pack takes int64 codes[256] and int32 "
                        "lengths[256]")
    zplanes = bool(coding[2])
    if zplanes:
        if zrow is None or zcol is None:
            raise ValueError("a zero-plane coding needs zrow and zcol")
        if zrow.shape != (k, wp) or zcol.shape != (k, e) or not all(
            t.dtype in (torch.bool, torch.uint8) for t in (zrow, zcol)
        ):
            raise ValueError(f"zrow/zcol must be bool[{k}, {wp}] / "
                             f"bool[{k}, {e}]")
    masks = (zrow, zcol) if zplanes else ()
    if any(t.device != dev for t in (counts, codes, lengths, *masks)):
        raise ValueError("symlen_pack inputs must share one CUDA device")
    sp = wp * e
    num_chunks = max(-(-sp // chunk_size), 1)
    grid = grid.contiguous()
    zr = zc = None
    if zplanes:
        zr = zrow.contiguous().data_ptr()
        zc = zcol.contiguous().data_ptr()
    hi = torch.empty(k, num_chunks, chunk_size, dtype=torch.int32, device=dev)
    lo = torch.empty_like(hi)
    sl = torch.empty_like(hi)
    wpc = torch.empty(k, num_chunks, dtype=torch.int32, device=dev)
    bad = torch.zeros(k, dtype=torch.bool, device=dev)
    if k == 0:
        return hi, lo, sl, wpc, bad  # nothing to launch
    ops.launch(
        "symlen_pack", "fptc_symlen_pack", dev,
        grid.data_ptr(), zr, zc, counts.contiguous().data_ptr(), k, wp, e,
        num_chunks, chunk_size, int(coding != TRIVIAL),
        codes.contiguous().data_ptr(), lengths.contiguous().data_ptr(),
        int(bool(check_gaps)), hi.data_ptr(), lo.data_ptr(), sl.data_ptr(),
        wpc.data_ptr(), bad.data_ptr(),
    )
    return hi, lo, sl, wpc, bad


# ---------------------------------------------------------------------------
# The whole bucket encode.
# ---------------------------------------------------------------------------
def tuning_plan_key(n: int, e: int, chunk_size: int, coding=TRIVIAL) -> tuple:
    """The tuning cache's plan key of a bucket encode (the reference's
    ``ops.encode_bucket_fused`` key): ``(n, e, chunk_size)``, then a
    non-trivial coding's three ints; the bucket shape ``(rows, width)``
    completes the entry's key."""
    return (int(n), int(e), int(chunk_size)) + coding_key(coding)


# the register tiles of the bucket encodes that do not pin them (the
# engines' among them), read from the tuning cache once per bucket shape
# and epoch
_BLOCKS = BlockMemo(tuning_plan_key)


def _tuned_rw(rows: int, width: int, device, *, n, e, chunk_size,
              coding) -> int:
    """The encode entry's ``levels_rw`` for this bucket on ``device``
    (0, the kernel's own pick, where the cache has none)."""
    blocks = _BLOCKS.get("encode", (n, e, chunk_size, tuple(coding)),
                         (rows, width), device)
    return blocks.get("levels_rw", 0)


def _compose(levels_fn, pack_fn, signals, counts, tables: DeviceTables,
             basis, *, n, e, chunk_size, check_gaps, coding, **levels_kw):
    coding = tuple(coding)
    grid, zrow, zcol, ncoded = levels_fn(signals, counts, tables.quant, basis,
                                         n=n, e=e, coding=coding, **levels_kw)
    hi, lo, sl, wpc, bad = pack_fn(
        grid, zrow, zcol, counts, tables.codes, tables.lengths,
        chunk_size=chunk_size, coding=coding, check_gaps=check_gaps,
    )
    if coding == TRIVIAL:
        return hi, lo, sl, wpc, bad
    return hi, lo, sl, wpc, bad, ncoded, zrow, zcol


def encode_fused_plain(signals, counts, tables: DeviceTables, basis, *,
                       n: int, e: int, chunk_size: int, check_gaps: bool,
                       coding=TRIVIAL):
    """The plain version of K4 (runs on any device)."""
    return _compose(encode_levels_plain, symlen_pack_plain, signals, counts,
                    tables, basis, n=n, e=e, chunk_size=chunk_size,
                    check_gaps=check_gaps, coding=coding)


def encode_fused(signals, counts, tables: DeviceTables, basis, *, n: int,
                 e: int, chunk_size: int, check_gaps: bool, coding=TRIVIAL,
                 levels_rw: Optional[int] = None):
    """Bucket encode: signal rows f32[K, Wp * N] (zero-padded) and true
    symbol counts int32[K] -> ``(hi, lo, symlen [K, B, C], words_per_chunk
    [K, B], bad bool[K])``, the reference's contract (``hi``/``lo`` as int32
    bit patterns of the uint32 halves).  A v3 ``coding`` appends ``ncoded
    int32[K]`` and, with zero planes, ``zrow bool[K, Wp]`` / ``zcol bool[K,
    E]`` (``None`` without).  ``levels_rw`` pins ``encode_levels``'
    register tile (0: its own pick); left None on the card it comes from
    the tuning cache's entry for this plan key and bucket shape."""
    if levels_rw is None:
        levels_rw = 0
        if ops.is_cuda(signals):
            levels_rw = _tuned_rw(*signals.shape, signals.device, n=n, e=e,
                                  chunk_size=chunk_size, coding=coding)
    return _compose(encode_levels, symlen_pack, signals, counts, tables,
                    basis, n=n, e=e, chunk_size=chunk_size,
                    check_gaps=check_gaps, coding=coding, rw=levels_rw)


def encode_fused_gather(flat, starts, lens, counts, tables: DeviceTables,
                        basis, *, width: int, n: int, e: int,
                        chunk_size: int, check_gaps: bool, coding=TRIVIAL,
                        levels_rw: Optional[int] = None):
    """Bucket encode of gathered rows (see :func:`gather_rows`):
    ``encode_levels_gather`` then ``symlen_pack`` on the card, the same
    outputs as :func:`encode_fused` on the gathered matrix.  ``levels_rw``
    as :func:`encode_fused` takes it (the same cache entry: the bucket's
    shape is ``(rows, width)`` either way)."""
    if levels_rw is None:
        levels_rw = 0
        if ops.is_cuda(flat):
            levels_rw = _tuned_rw(starts.shape[0], width, flat.device, n=n,
                                  e=e, chunk_size=chunk_size, coding=coding)

    def levels(_, counts, quant, basis, *, n, e, coding, rw):
        return encode_levels_gather(flat, starts, lens, counts, quant, basis,
                                    width=width, n=n, e=e, coding=coding,
                                    rw=rw)

    return _compose(levels, symlen_pack, None, counts, tables, basis, n=n,
                    e=e, chunk_size=chunk_size, check_gaps=check_gaps,
                    coding=coding, rw=levels_rw)
