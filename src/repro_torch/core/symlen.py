"""SymLen bitstream format (paper §4.1, Algorithm 1) — pack + parallel unpack.

Port of ``repro/core/symlen.py``.

Codewords are greedily packed MSB-first into fixed 64-bit words; a codeword
never straddles a word boundary.  The *symlen* sidecar stores, per word, the
number of symbols it contains — making every word independently decodable.

On-wire format: little-endian uint64 words.  The reference splits each word
into a (hi, lo) uint32 pair because TPU int64 is emulated; the port keeps
the native 64-bit word, held in torch as the bit pattern of an ``int64``
(``words.view(np.int64)``).  ``int64 >> k`` is an arithmetic shift in torch,
so every logical right shift here masks off the sign-extended bits.

  * ``pack_symlen_np``   — faithful Algorithm 1, host numpy.
  * ``pack_symlen_scan`` — the exact single-stream packer in torch.
  * ``pack_symlen_chunked[_parts]`` — chunk-parallel greedy packing in
                           plain torch: the plain version of the CUDA pack
                           kernel (``repro_torch.kernels.encode_fused``).
                           Packed words are ``(hi, lo)`` uint32 halves, as
                           in the reference's pack contract, held as the
                           bit patterns of ``int32`` tensors.
  * ``unpack_symlen_np`` — bit-serial LUT decode, host numpy (the oracle).
  * ``unpack_symlen``    — word-parallel decode in plain torch: the math of
                           the reference's XLA arm (slot loop + prefix-sum
                           compaction), and the plain version of the CUDA
                           decode kernel (``repro_torch.kernels.
                           huffman_decode``).
  * ``decode_tile``      — every slot of every word, uncompacted: the plain
                           version of the CUDA tile kernel (K6).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.huffman import HuffmanCodebook

__all__ = [
    "PackedStream",
    "pack_symlen_np",
    "pack_symlen_scan",
    "pack_symlen_chunked",
    "pack_symlen_chunked_parts",
    "stitch_chunk_parts",
    "chunk_words_bound",
    "stitch_capacity",
    "STITCH_CAPACITY_GRID",
    "unpack_symlen_np",
    "unpack_symlen",
    "compact_padded_scatter",
    "decode_tile",
    "decode_lut",
    "halves_to_words",
    "words_to_u32",
    "u32_to_words",
    "zero_plane_masks",
    "v3_expand_index",
]

WORD_BITS = 64
_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class PackedStream:
    """A SymLen-packed stream (host container; see core.container for I/O)."""

    words: np.ndarray  # uint64[W]
    symlen: np.ndarray  # int32[W]
    num_symbols: int

    @property
    def num_words(self) -> int:
        return int(self.words.shape[0])

    @property
    def max_symlen(self) -> int:
        return int(self.symlen.max()) if self.symlen.size else 0

    @property
    def payload_bytes(self) -> int:
        # words + symlen sidecar (uint8 is sufficient: symlen <= 64)
        return self.num_words * 8 + self.num_words


def words_to_u32(words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64[W] -> (hi uint32[W], lo uint32[W])."""
    w = np.asarray(words, dtype=np.uint64)
    hi = (w >> np.uint64(32)).astype(np.uint32)
    lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def u32_to_words(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64
    )


# ---------------------------------------------------------------------------
# Host reference encoder — Algorithm 1, line for line.
# ---------------------------------------------------------------------------
def pack_symlen_np(symbols: np.ndarray, book: HuffmanCodebook) -> PackedStream:
    symbols = np.asarray(symbols, dtype=np.uint8).ravel()
    codes = book.codes.tolist()  # Python ints: the loop below is per symbol
    lens = book.lengths.tolist()
    out_words = []
    out_symlen = []
    buffer = 0
    bit_size = 0
    count = 0
    for s in symbols.tolist():
        code = codes[s]
        code_len = lens[s]
        if code_len == 0:
            raise ValueError(f"symbol {s} has no codeword (histogram gap)")
        if bit_size + code_len > WORD_BITS:
            out_words.append(buffer)
            out_symlen.append(count)
            buffer = 0
            bit_size = 0
            count = 0
            # retry same symbol on the fresh word (always fits: len <= 64)
        shift = WORD_BITS - bit_size - code_len
        buffer |= code << shift
        bit_size += code_len
        count += 1
    if count > 0:
        out_words.append(buffer)
        out_symlen.append(count)
    return PackedStream(
        words=np.array(out_words, dtype=np.uint64),
        symlen=np.array(out_symlen, dtype=np.int32),
        num_symbols=int(symbols.size),
    )


# ---------------------------------------------------------------------------
# Device encoders in plain torch — the exact single-stream packer and the
# chunk-parallel one.  uint32 values are computed in int64 tensors (torch
# has no uint32 arithmetic) and returned as the bit patterns of int32.
# ---------------------------------------------------------------------------
def _precheck_symbols(symbols, lengths, num_symbols, valid=None) -> None:
    """Host-side guard against silent corruption: every symbol that occurs
    in the input must have a codeword (``lengths[sym] > 0``).

    A zero-length symbol would emit zero bits yet still increment the
    word's symlen count, so the stream *decodes* — to garbage.
    ``pack_symlen_np`` raises for this; the single-stream packers reject the
    same input.  The batched encode engine packs without it and checks a
    per-row device-side flag at drain time instead (one sync per batch, not
    one per call).
    """
    syms = torch.as_tensor(symbols).detach().cpu().reshape(-1)
    if valid is not None:
        syms = syms[torch.as_tensor(valid).detach().cpu().reshape(-1).bool()]
    else:
        syms = syms[: int(num_symbols)]
    if syms.numel() == 0:
        return
    lens = torch.as_tensor(lengths).detach().cpu().reshape(-1).numpy()
    hist = np.bincount(syms.numpy().astype(np.int64), minlength=lens.size)
    gaps = np.nonzero((hist[: lens.size] > 0) & (lens == 0))[0]
    if gaps.size:
        raise ValueError(
            f"symbol {int(gaps[0])} has no codeword (histogram gap); "
            f"{gaps.size} distinct input symbol(s) are unencodable"
        )


def _shl32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) left shift, defined 0 for s >= 32 or s < 0."""
    val = (x << torch.clamp(s, 0, 31)) & _U32
    return torch.where((s >= 32) | (s < 0), torch.zeros_like(val), val)


def _shr32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) logical right shift, defined 0 for s >= 32 or
    s < 0."""
    val = x >> torch.clamp(s, 0, 31)
    return torch.where((s >= 32) | (s < 0), torch.zeros_like(val), val)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) -> int32 tensor of the same bit patterns."""
    return _as_i32(x).to(torch.int32)


def _pack_chunk(
    symbols: torch.Tensor,  # int[..., M]
    valid: torch.Tensor,  # bool[..., M] — padding slots pack to nothing
    codes: torch.Tensor,  # int64[256] (uint32 codewords)
    lengths: torch.Tensor,  # int32[256]
):
    """Greedy packing of chunks ``[..., M]`` (each leading index one chunk).

    Returns (hi int32[..., M], lo int32[..., M], symlen int32[..., M],
    num_words int32[...]); a chunk's valid word prefix is ``num_words``.
    The (code, length) lookup happens here; the packing itself is
    :func:`_pack_chunk_emit`.
    """
    if symbols.shape[-1] == 0:
        z = torch.zeros(symbols.shape, dtype=torch.int32,
                        device=symbols.device)
        return z, z, z, torch.zeros(symbols.shape[:-1], dtype=torch.int32,
                                    device=symbols.device)
    s = symbols.long()
    # masked slots emit a zero-length, zero-valued code: a no-op
    code = torch.where(valid, codes.long()[s], torch.zeros_like(s))
    clen = torch.where(valid, lengths.long()[s], torch.zeros_like(s))
    return _pack_chunk_emit(code, clen, valid)


def _pack_chunk_emit(
    code: torch.Tensor,  # int64[..., M] right-aligned codewords (0 if masked)
    clen: torch.Tensor,  # int[..., M] codeword lengths (0 when masked)
    valid: torch.Tensor,  # bool[..., M]
):
    """Greedy word materialization from per-symbol (code, length) pairs.

    The only sequential part of greedy packing is the (bit offset, word
    index) recurrence, an O(1) carry per symbol: a loop over the M slots,
    each step vectorized over every chunk.  A word is flushed when the next
    codeword does not fit (``bit_size + clen > 64``), so no codeword
    straddles a word.  Symbol bits within a word occupy disjoint slots, so
    each word is the segment sum of its symbols' shifted codes (equal to
    their OR, and below 2**32 per half, so int64 sums never wrap).
    """
    cl = clen.long()
    lead = cl.shape[:-1]
    m = cl.shape[-1]
    bit = torch.zeros(lead, dtype=torch.int64, device=cl.device)
    w = torch.zeros(lead, dtype=torch.int64, device=cl.device)
    word_idx = torch.empty_like(cl)
    start = torch.empty_like(cl)
    for j in range(m):
        c = cl[..., j]
        flush = bit + c > WORD_BITS
        w = w + flush.long()
        st = torch.where(flush, torch.zeros_like(bit), bit)
        bit = st + c
        word_idx[..., j] = w
        start[..., j] = st
    # place right-aligned `code` of length clen at bit offset `start`
    # (MSB-first) of its word: hi takes the bits when shift >= 32
    shift = WORD_BITS - start - cl  # in [0, 64]; 64 only for clen == 0
    code = code.long() & _U32
    add_hi = torch.where(
        shift >= 32, _shl32(code, shift - 32), _shr32(code, 32 - shift)
    )
    add_lo = torch.where(shift >= 32, torch.zeros_like(code),
                         _shl32(code, shift))
    zeros = torch.zeros_like(cl)
    out_hi = zeros.scatter_add(-1, word_idx, add_hi)
    out_lo = zeros.scatter_add(-1, word_idx, add_lo)
    out_sl = zeros.scatter_add(-1, word_idx, valid.long())
    num_words = torch.where(valid, word_idx + 1, zeros).amax(dim=-1)
    return (_to_i32(out_hi), _to_i32(out_lo), out_sl.to(torch.int32),
            num_words.to(torch.int32))


def pack_symlen_scan(
    symbols: torch.Tensor,
    codes: torch.Tensor,  # int64[256] (uint32 right-aligned codewords)
    lengths: torch.Tensor,  # int32[256]
):
    """Returns (hi int32[S], lo int32[S], symlen int32[S], num_words int32):
    hi/lo hold the uint32 halves' bit patterns.

    The exact single-stream packer (Algorithm 1): output arrays are sized
    at the worst case (one word per symbol) and ``num_words`` gives the
    valid prefix.  The greedy recurrence is the same as one chunk of
    :func:`pack_symlen_chunked_parts` holding the whole stream, so this is
    that chunk (bit-identical to ``pack_symlen_np``).
    """
    symbols = torch.as_tensor(symbols).reshape(-1)
    n = symbols.shape[0]
    _precheck_symbols(symbols, lengths, n)
    valid = torch.ones(n, dtype=torch.bool, device=symbols.device)
    return _pack_chunk(symbols, valid, codes, lengths)


def chunk_words_bound(chunk_size: int, l_max: int) -> int:
    """Static upper bound on the words one chunk of ``chunk_size`` symbols
    can pack to.

    A word is flushed only when the next codeword (<= ``l_max`` bits) does
    not fit, so every flushed word carries more than ``64 - l_max`` bits and
    therefore at least ``floor(64 / l_max)`` symbols; only the chunk's last
    word may hold fewer (>= 1).  Hence
    ``words <= (chunk_size - 1) // floor(64 / l_max) + 1`` (and trivially
    ``words <= chunk_size``).
    """
    if chunk_size <= 0:
        return 0
    s_min = max(WORD_BITS // max(int(l_max), 1), 1)
    return min(int(chunk_size), (int(chunk_size) - 1) // s_min + 1)


# Stitched-stream capacities quantize to this grid, so the number of
# distinct decode bucket shapes stays O(log sizes) even when capacities are
# exact counts.
STITCH_CAPACITY_GRID = 256


def stitch_capacity(words: int, *, grid: int = STITCH_CAPACITY_GRID) -> int:
    """Round a stitched-stream word capacity up to the grid (deliberately
    not a power of two: the bound is already ~2-3x the true word count)."""
    return -(-max(int(words), 1) // grid) * grid


def stitch_chunk_parts(
    chunk_hi: torch.Tensor,  # int32[B, C]
    chunk_lo: torch.Tensor,  # int32[B, C]
    chunk_sl: torch.Tensor,  # int32[B, C]
    words_per_chunk: torch.Tensor,  # int32[B]
    *,
    capacity: int,
):
    """Device-side stitch: chunk parts -> one dense decoder-shaped stream.

    Chunk b's valid words (its row's first ``words_per_chunk[b]`` entries)
    land in the output run ``[cum[b-1], cum[b])`` — a pure gather (output
    position -> source chunk/slot).  Positions past the total word count
    are zero words with ``symlen == 0``.  Multi-signal parts ``[K, B, C]``
    stitch to one concatenated stream by reshaping to ``[K * B, C]``.

    Returns (hi int32[capacity], lo int32[capacity], symlen
    int32[capacity], num_words int32[]) — ``num_words`` is the live prefix
    (a tensor on the parts' device; no sync).
    """
    b = chunk_hi.shape[0]
    dev = chunk_hi.device
    if b == 0 or capacity == 0:
        z = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return z, z.clone(), z.clone(), torch.zeros((), dtype=torch.int32,
                                                    device=dev)
    wpc = words_per_chunk.long()
    cum = torch.cumsum(wpc, 0)  # inclusive prefix sum
    pos = torch.arange(capacity, device=dev)
    src = torch.clamp(torch.searchsorted(cum, pos, right=True), max=b - 1)
    slot = torch.clamp(pos - (cum[src] - wpc[src]),
                       max=chunk_hi.shape[1] - 1)
    live = pos < cum[-1]

    def take(parts):
        got = parts[src, slot]
        return torch.where(live, got, torch.zeros_like(got))

    return (take(chunk_hi), take(chunk_lo), take(chunk_sl),
            cum[-1].to(torch.int32))


def _chunked_parts(symbols, valid, codes, lengths, chunk_size: int):
    """:func:`pack_symlen_chunked_parts` without the host precheck, over
    streams ``[..., S]`` with a validity mask of the same shape (the
    batched encode engine's plain arm)."""
    s = symbols.shape[-1]
    num_chunks = max(-(-s // chunk_size), 1)
    cap = num_chunks * chunk_size
    if cap != s:
        pad = (0, cap - s)
        symbols = torch.nn.functional.pad(symbols, pad)
        valid = torch.nn.functional.pad(valid, pad)
    lead = symbols.shape[:-1]
    return _pack_chunk(
        symbols.reshape(lead + (num_chunks, chunk_size)),
        valid.reshape(lead + (num_chunks, chunk_size)),
        codes, lengths,
    )


def pack_symlen_chunked_parts(
    symbols: torch.Tensor,
    codes: torch.Tensor,  # int64[256]
    lengths: torch.Tensor,  # int32[256]
    *,
    chunk_size: int,
    num_symbols=None,
    valid=None,
):
    """Chunk-parallel SymLen packing, un-stitched.

    Splits the stream ``[S]`` into ``B = ceil(S / chunk_size)`` chunks and
    packs each greedily from a fresh 64-bit word.  Returns (hi int32[B, C],
    lo int32[B, C], symlen int32[B, C], words_per_chunk int32[B]); chunk b's
    valid words are its row's first ``words_per_chunk[b]`` entries, and the
    dense stream is their in-order concatenation.  SymLen words decode
    independently, so the chunked stream decodes bit-exactly; with
    ``chunk_size = S`` it equals ``pack_symlen_np``'s.

    ``num_symbols`` (a host int or a 0-dim tensor; default S) marks the
    slots at and past it as padding.  ``valid`` (bool[S], exclusive with
    ``num_symbols``) masks an arbitrary subset: masked slots emit nothing,
    advance nothing and are not counted, so the stream equals the greedy
    pack of the compacted valid subsequence (container-v3 zero planes).
    """
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    symbols = torch.as_tensor(symbols).reshape(-1)
    s = symbols.shape[0]
    if valid is not None:
        if num_symbols is not None:
            raise ValueError("pass num_symbols or valid, not both")
        valid = torch.as_tensor(valid, device=symbols.device).reshape(-1)
        valid = valid.bool()
        _precheck_symbols(symbols, lengths, None, valid)
    else:
        if num_symbols is None:
            num_symbols = s
        _precheck_symbols(symbols, lengths, num_symbols)
        valid = torch.arange(s, device=symbols.device) < torch.as_tensor(
            num_symbols, device=symbols.device)
    return _chunked_parts(symbols, valid, codes, lengths, chunk_size)


def pack_symlen_chunked(
    symbols: torch.Tensor,
    codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    chunk_size: int,
    num_symbols=None,
):
    """Chunk-parallel SymLen packing, stitched: (hi int32[C], lo int32[C],
    symlen int32[C], num_words int32[]) with capacity ``C = B *
    chunk_size``; the valid prefix is ``num_words``."""
    hi, lo, sl, wpc = pack_symlen_chunked_parts(
        symbols, codes, lengths, chunk_size=chunk_size,
        num_symbols=num_symbols,
    )
    return stitch_chunk_parts(hi, lo, sl, wpc,
                              capacity=hi.shape[0] * chunk_size)


# ---------------------------------------------------------------------------
# Container-v3 zero-plane stream layout (host side).  The coded symbol
# stream omits every grid cell (w, k) lying in an all-zero-bin window row
# (zrow[w]) or coefficient column (zcol[k]); the surviving cells keep
# row-major order.  The encoder's suppression mask and the decoder's
# expansion index both derive from these two helpers.
# ---------------------------------------------------------------------------
def zero_plane_masks(grid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(zrow bool[W], zcol bool[E]) of a coded level grid ``[W, E]``."""
    grid = np.asarray(grid)
    zrow = np.all(grid == 128, axis=1)
    zcol = np.all(grid == 128, axis=0)
    return zrow, zcol


def v3_expand_index(
    members,
    e: int,
    *,
    total_windows: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expansion metadata for a (possibly concatenated) v3 coded stream.

    ``members`` is a sequence of ``(num_windows, zrow, zcol)`` per signal in
    stream order (``zrow``/``zcol`` may be None for no suppression);
    ``total_windows`` pads the grid to the decode bucket's rounded window
    count.  Returns:

      idx int32[total_windows * e] — for each flat grid cell, its position
        in the dense coded stream, or -1 where the cell is suppressed or
        bucket padding (those expand to the zero bin).
      seg_start int32[total_windows] — the index of the first window of the
        cell's signal (its own index for padding windows, making each one a
        single-window segment that unpredicts to all-128).  Segments are
        contiguous runs: ``seg_start[w] == w`` exactly at a segment's first
        window, the layout the CUDA un-prediction kernel walks.
    """
    win_off = 0
    sym_off = 0
    nw_total = sum(int(m[0]) for m in members)
    if total_windows is None:
        total_windows = nw_total
    if total_windows < nw_total:
        raise ValueError(
            f"total_windows={total_windows} < member windows {nw_total}"
        )
    idx = np.full(total_windows * e, -1, dtype=np.int32)
    seg_start = np.arange(total_windows, dtype=np.int32)
    for num_windows, zrow, zcol in members:
        w = int(num_windows)
        mask = np.ones((w, e), dtype=bool)
        if zrow is not None:
            mask &= ~np.asarray(zrow, dtype=bool)[:, None]
        if zcol is not None:
            mask &= ~np.asarray(zcol, dtype=bool)[None, :]
        flat = mask.ravel()
        ncoded = int(np.count_nonzero(flat))
        local = np.cumsum(flat) - 1  # rank of each coded cell, row-major
        span = idx[win_off * e: win_off * e + w * e]
        span[flat] = (local[flat] + sym_off).astype(np.int32)
        seg_start[win_off: win_off + w] = win_off
        win_off += w
        sym_off += ncoded
    return idx, seg_start


# ---------------------------------------------------------------------------
# Host reference decoder (bit-serial, LUT-based — the paper's GPU semantics).
# ---------------------------------------------------------------------------
def unpack_symlen_np(
    stream: PackedStream, book: HuffmanCodebook
) -> np.ndarray:
    out = np.empty(stream.num_symbols, dtype=np.uint8)
    pos = 0
    lmax = book.l_max
    mask = (1 << lmax) - 1
    lut_symbol = book.lut_symbol.tolist()
    lut_length = book.lut_length.tolist()
    for w, sl in zip(stream.words.tolist(), stream.symlen.tolist()):
        cur = int(w)
        consumed = 0
        for _ in range(int(sl)):
            window = (cur >> max(WORD_BITS - lmax, 0)) & mask
            # if fewer than lmax bits remain, low bits are zero padding —
            # prefix-free codes still decode correctly (paper §4.2.1)
            l = lut_length[window]
            cur = (cur << l) & ((1 << WORD_BITS) - 1)
            consumed += l
            out[pos] = lut_symbol[window]
            pos += 1
        if consumed > WORD_BITS:
            raise ValueError("word decodes past its 64 bits: corrupt stream")
    if pos != stream.num_symbols:
        raise ValueError(
            f"stream holds {pos} symbols, header says {stream.num_symbols}"
        )
    return out


def compact_padded_scatter(
    padded: torch.Tensor,  # [W, max_symlen] (any integer dtype)
    symlen: torch.Tensor,  # int[W]
    num_symbols: int,
) -> torch.Tensor:
    """Compact a padded per-word symbol tile to a dense ``[num_symbols]``.

    One exclusive prefix-sum over the symlen sidecar gives every word its
    output offset; slot ``j`` of word ``w`` lands at ``offsets[w] + j`` when
    ``j < symlen[w]`` and is dropped otherwise (as is any position at or
    past ``num_symbols``).  Positions no word writes stay zero.
    """
    w, max_symlen = padded.shape
    sl = symlen.to(torch.int64)
    offsets = torch.cumsum(sl, 0) - sl
    slot = torch.arange(max_symlen, device=padded.device)
    idx = offsets[:, None] + slot[None, :]
    valid = (slot[None, :] < sl[:, None]) & (idx < num_symbols)
    out = torch.zeros(num_symbols, dtype=padded.dtype, device=padded.device)
    out[idx[valid]] = padded[valid]
    return out


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) reinterpreted as int32, as ``astype`` does."""
    return ((x + (1 << 31)) & _U32) - (1 << 31)


def unpack_symlen(
    words: torch.Tensor,  # int64[W]: the uint64 words' bit patterns
    symlen: torch.Tensor,  # int[W] (0 on padding words)
    dec_limit: torch.Tensor,  # int[L_max] = limit_shifted[1:]
    dec_first: torch.Tensor,  # int[L_max + 1] = first_code_shifted
    dec_rank: torch.Tensor,  # int[L_max + 1] = rank_offset
    dec_syms: torch.Tensor,  # int[256] = sorted_symbols
    *,
    l_max: int,
    max_symlen: int,
    num_symbols: int,
) -> torch.Tensor:
    """Decode all words in parallel and compact to a dense uint8[num_symbols].

    The reference's XLA-arm math: per slot (``max_symlen`` of them) every
    word decodes one symbol —

      1. prefix = top L_max bits of the remaining word
      2. length = min(1 + sum_l [prefix >= limit_shifted[l]], L_max)
      3. rank   = rank_offset[len] + ((prefix - first_code_shifted[len])
                  mod 2^32 >> (L_max - len)), as int32, clipped to [0, 255]
      4. symbol = sorted_symbols[rank]
      5. shift the word left by ``length``

    — and slot ``j`` of word ``w`` lands at the exclusive prefix sum of
    symlen plus ``j`` when ``j < symlen[w]``.  Positions past the true
    symbol total stay 0, like the XLA scatter's zero fill.  The slot tile
    is never materialized: each slot scatters as it is decoded.
    """
    sl = symlen.to(torch.int64)
    offsets = torch.cumsum(sl, 0) - sl
    tabs = _decode_tables(dec_limit, dec_first, dec_rank, dec_syms)
    out = torch.zeros(num_symbols, dtype=torch.uint8, device=words.device)
    cur = words.to(torch.int64)
    for j in range(max_symlen):
        sym, cur = _decode_slot(cur, tabs, l_max)
        pos = offsets + j
        keep = (sl > j) & (pos < num_symbols)
        out[pos[keep]] = sym[keep].to(torch.uint8)
    return out


def _decode_tables(dec_limit, dec_first, dec_rank, dec_syms):
    """The canonical decode tables as int64 (limit, first, rank, symbols)."""
    return tuple(t.to(torch.int64)
                 for t in (dec_limit, dec_first, dec_rank, dec_syms))


def _decode_prefix(prefix: torch.Tensor, tabs, l_max: int):
    """Steps 2-4 of :func:`unpack_symlen` for the top ``l_max`` bits
    ``prefix`` (int64) of words, with the length clamp and the rank clip,
    so every bit pattern decodes to a defined symbol.  Returns ``(symbol,
    length)``, both int64."""
    limit, first, rank_off, syms = tabs
    length = 1 + (prefix[None, :] >= limit[:, None]).sum(0)
    length = torch.clamp(length, max=l_max)
    diff = (prefix - first[length]) & _U32
    rank = rank_off[length] + _as_i32(diff >> (l_max - length))
    return syms[torch.clamp(rank, 0, 255)], length


def _decode_slot(cur: torch.Tensor, tabs, l_max: int):
    """Decode the symbol at the top of every word ``cur`` (int64 bit
    patterns) and consume its codeword: steps 1-5 of
    :func:`unpack_symlen`.  Returns ``(symbol int64[W], the shifted
    words)``."""
    prefix = (cur >> (WORD_BITS - l_max)) & ((1 << l_max) - 1)
    sym, length = _decode_prefix(prefix, tabs, l_max)
    return sym, cur << length


def decode_lut(dec_limit, dec_first, dec_rank, dec_syms, *,
               l_max: int) -> torch.Tensor:
    """The decode table of the canonical code: int16[2**l_max], entry ``p``
    the symbol (bits 0-7) and the codeword length (bits 8-15) that a word
    whose top ``l_max`` bits are ``p`` decodes to — :func:`_decode_slot`'s
    arithmetic for every prefix, so a table read and a shift by the length
    decode exactly as the arithmetic does (the paper's 2**l_max LUT)."""
    tabs = _decode_tables(dec_limit, dec_first, dec_rank, dec_syms)
    prefix = torch.arange(1 << l_max, dtype=torch.int64,
                          device=dec_syms.device)
    sym, length = _decode_prefix(prefix, tabs, l_max)
    return (sym | (length << 8)).to(torch.int16)


def decode_tile(words, dec_limit, dec_first, dec_rank, dec_syms, *,
                l_max: int, max_symlen: int) -> torch.Tensor:
    """Decode ``max_symlen`` slots of every word, whatever its symlen: the
    slot-major tile int32[max_symlen, W] of the reference's
    ``kernels/ref.py::huffman_decode_padded_ref`` (transposed), slots past a
    word's symlen included.  Compact it with
    :func:`compact_padded_scatter` (``tile.T``)."""
    tabs = _decode_tables(dec_limit, dec_first, dec_rank, dec_syms)
    out = torch.empty(max_symlen, words.shape[0], dtype=torch.int32,
                      device=words.device)
    cur = words.to(torch.int64)
    for j in range(max_symlen):
        sym, cur = _decode_slot(cur, tabs, l_max)
        out[j] = sym.to(torch.int32)
    return out


def halves_to_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """uint32 (hi, lo) halves held as int32 bit patterns -> the uint64
    words' bit patterns as int64, on the halves' device (the torch twin of
    :func:`u32_to_words`; no host copy)."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _U32)
