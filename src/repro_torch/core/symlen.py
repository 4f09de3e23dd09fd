"""SymLen bitstream format (paper §4.1, Algorithm 1) — pack + parallel unpack.

Port of ``repro/core/symlen.py`` (the parts the decode path needs, plus the
host packer the host encoder uses).

Codewords are greedily packed MSB-first into fixed 64-bit words; a codeword
never straddles a word boundary.  The *symlen* sidecar stores, per word, the
number of symbols it contains — making every word independently decodable.

On-wire format: little-endian uint64 words.  The reference splits each word
into a (hi, lo) uint32 pair because TPU int64 is emulated; the port keeps
the native 64-bit word, held in torch as the bit pattern of an ``int64``
(``words.view(np.int64)``).  ``int64 >> k`` is an arithmetic shift in torch,
so every logical right shift here masks off the sign-extended bits.

  * ``pack_symlen_np``   — faithful Algorithm 1, host numpy.
  * ``unpack_symlen_np`` — bit-serial LUT decode, host numpy (the oracle).
  * ``unpack_symlen``    — word-parallel decode in plain torch: the math of
                           the reference's XLA arm (slot loop + prefix-sum
                           compaction), and the plain version of the CUDA
                           decode kernel (``repro_torch.kernels.
                           huffman_decode``).
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
    "unpack_symlen_np",
    "unpack_symlen",
    "compact_padded_scatter",
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
    dev = words.device
    cur = words.to(torch.int64)
    sl = symlen.to(torch.int64)
    offsets = torch.cumsum(sl, 0) - sl
    limit = dec_limit.to(torch.int64)
    first = dec_first.to(torch.int64)
    rank_off = dec_rank.to(torch.int64)
    syms = dec_syms.to(torch.int64)
    out = torch.zeros(num_symbols, dtype=torch.uint8, device=dev)
    prefix_mask = (1 << l_max) - 1
    for j in range(max_symlen):
        prefix = (cur >> (WORD_BITS - l_max)) & prefix_mask
        length = 1 + (prefix[None, :] >= limit[:, None]).sum(0)
        length = torch.clamp(length, max=l_max)
        diff = (prefix - first[length]) & _U32
        rank = rank_off[length] + _as_i32(diff >> (l_max - length))
        sym = syms[torch.clamp(rank, 0, 255)]
        pos = offsets + j
        keep = (sl > j) & (pos < num_symbols)
        out[pos[keep]] = sym[keep].to(torch.uint8)
        cur = cur << length
    return out
