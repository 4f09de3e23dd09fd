"""Length-limited canonical Huffman coding (paper §3.3).

Code lengths come from the Larmore–Hirschberg *package-merge* algorithm, which
solves length-limited minimum-redundancy coding in O(sigma * L_max) for an
alphabet of sigma symbols (sigma = 256 here: 1-byte post-quantization values).
Codes are then canonized: symbols sorted by (length, value), codewords
assigned in increasing numeric order per length.

This module is **offline/host-side** (numpy): it runs during per-domain
calibration (paper §3.4.2, Fig. 4(2)) and produces the small decode tables
consumed by the torch decoders and the CUDA decode kernel:

  * ``first_code_shifted[l]`` — smallest L_max-bit-aligned prefix of length l
  * ``limit_shifted[l]``      — one past the largest prefix of length l
  * ``rank_offset[l]``        — rank of the first symbol with code length l
  * ``sorted_symbols[r]``     — symbol for canonical rank r

With these, decode needs **no 2^L_max LUT**: the code length of a prefix P is
``1 + sum_l [P >= limit_shifted[l]]`` (vectorized compares), and the symbol is
``sorted_symbols[rank_offset[len] + ((P - first_code_shifted[len]) >>
(L_max - len))]``.  A classic 2^L_max LUT is also built for the host
decoder and as a cross-check oracle.

Port of ``repro/core/huffman.py``.  :func:`codebook_from_lengths` splits the
canonical assignment out of :func:`build_codebook`, so a codebook can be
rebuilt from its 256 code lengths alone (the state carried across from a
reference ``DomainTables``; see ``calibration.tables_from_arrays``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "HuffmanCodebook",
    "package_merge_lengths",
    "build_codebook",
    "codebook_from_lengths",
    "kraft_sum",
]

ALPHABET = 256


def package_merge_lengths(freqs: np.ndarray, l_max: int) -> np.ndarray:
    """Optimal code lengths under max-length constraint via package-merge.

    Args:
      freqs: int64[ALPHABET] symbol frequencies; zero-frequency symbols get
        length 0 (no codeword).
      l_max: maximum codeword length.

    Returns:
      int32[ALPHABET] code lengths (0 for absent symbols).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    if freqs.ndim != 1:
        raise ValueError("freqs must be 1-D")
    active = np.nonzero(freqs > 0)[0]
    n = active.size
    lengths = np.zeros(freqs.shape[0], dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[active[0]] = 1
        return lengths
    if n > (1 << l_max):
        raise ValueError(f"{n} symbols cannot be coded with L_max={l_max}")

    # Package-merge: items are (weight, symbol-multiset as count vector over
    # active symbols). We track, per item, how many times each *original leaf*
    # appears, via index lists — classic implementation.
    base = [(int(freqs[s]), (i,)) for i, s in enumerate(active)]
    base.sort(key=lambda t: t[0])

    packages = list(base)
    for _ in range(l_max - 1):
        # package: pair up adjacent items
        merged = []
        for i in range(0, len(packages) - 1, 2):
            w = packages[i][0] + packages[i + 1][0]
            leaves = packages[i][1] + packages[i + 1][1]
            merged.append((w, leaves))
        # merge with the original leaves
        packages = sorted(base + merged, key=lambda t: t[0])

    # take the first 2n-2 items; each occurrence of leaf i adds 1 to its depth
    counts = np.zeros(n, dtype=np.int32)
    for w, leaves in packages[: 2 * n - 2]:
        for i in leaves:
            counts[i] += 1
    lengths[active] = counts
    return lengths


def kraft_sum(lengths: np.ndarray) -> float:
    """Kraft inequality sum; exactly 1.0 for a complete prefix code."""
    lens = np.asarray(lengths)
    lens = lens[lens > 0]
    return float(np.sum(2.0 ** (-lens.astype(np.float64))))


@dataclasses.dataclass(frozen=True)
class HuffmanCodebook:
    """Canonical length-limited codebook + decode tables (all host numpy)."""

    l_max: int
    lengths: np.ndarray  # int32[256] — 0 means absent
    codes: np.ndarray  # uint32[256] — canonical codeword (right-aligned)
    # --- decode tables (see module docstring) ---
    sorted_symbols: np.ndarray  # uint8[256], padded with 0 beyond num_active
    rank_offset: np.ndarray  # int32[l_max + 1]
    first_code_shifted: np.ndarray  # uint32[l_max + 1]
    limit_shifted: np.ndarray  # uint32[l_max + 1]
    lut_symbol: np.ndarray  # uint8[2**l_max]  (GPU-style LUT, CPU fast path)
    lut_length: np.ndarray  # uint8[2**l_max]

    @property
    def num_active(self) -> int:
        return int(np.sum(self.lengths > 0))

    def expected_bits(self, freqs: np.ndarray) -> float:
        freqs = np.asarray(freqs, dtype=np.float64)
        total = freqs.sum()
        if total == 0:
            return 0.0
        return float(np.sum(freqs * self.lengths) / total)

    def encode_lengths_of(self, symbols: np.ndarray) -> np.ndarray:
        return self.lengths[symbols]


def build_codebook(freqs: np.ndarray, l_max: int = 12) -> HuffmanCodebook:
    """Build the canonical length-limited codebook from a symbol histogram.

    Zero-frequency symbols receive no codeword: calibration (paper §3.4.2)
    applies Laplace smoothing upstream so every symbol that *can* occur at
    encode time has an entry.
    """
    if not (1 <= l_max <= 16):
        raise ValueError("l_max must be in [1, 16] (prefix must fit 16 bits)")
    return codebook_from_lengths(package_merge_lengths(freqs, l_max), l_max)


def codebook_from_lengths(lengths: np.ndarray, l_max: int) -> HuffmanCodebook:
    """The canonical codebook and decode tables for given code lengths.

    ``lengths`` is int[256] (0 = absent symbol), each at most ``l_max``.
    """
    if not (1 <= l_max <= 16):
        raise ValueError("l_max must be in [1, 16] (prefix must fit 16 bits)")
    lengths = np.asarray(lengths, dtype=np.int32)
    if lengths.shape != (ALPHABET,):
        raise ValueError(f"lengths must be int[{ALPHABET}], got {lengths.shape}")
    if lengths.min() < 0 or lengths.max() > l_max:
        raise ValueError(f"code lengths must lie in [0, l_max={l_max}]")

    # canonical assignment: sort by (length, symbol); assign increasing codes
    order = np.lexsort((np.arange(ALPHABET), lengths))
    order = order[lengths[order] > 0]
    codes = np.zeros(ALPHABET, dtype=np.uint32)
    code = 0
    prev_len = 0
    for sym in order:
        l = int(lengths[sym])
        code <<= l - prev_len
        codes[sym] = code
        code += 1
        prev_len = l

    # decode tables
    counts = np.bincount(lengths[lengths > 0], minlength=l_max + 1)
    sorted_symbols = np.zeros(ALPHABET, dtype=np.uint8)
    sorted_symbols[: order.size] = order.astype(np.uint8)
    rank_offset = np.zeros(l_max + 1, dtype=np.int32)
    first_code = np.zeros(l_max + 1, dtype=np.uint32)
    first_code_shifted = np.zeros(l_max + 1, dtype=np.uint32)
    limit_shifted = np.zeros(l_max + 1, dtype=np.uint32)
    rank = 0
    code = 0
    prev_len = 0
    full = np.uint32((1 << l_max))
    for l in range(1, l_max + 1):
        code <<= l - prev_len
        prev_len = l
        rank_offset[l] = rank
        first_code[l] = code
        first_code_shifted[l] = code << (l_max - l)
        code += int(counts[l])
        rank += int(counts[l])
        limit_shifted[l] = min(code << (l_max - l), int(full))
    # lengths with zero count get degenerate [first, limit) ranges that are
    # empty but keep limit_shifted monotone — required by the arithmetic
    # decoder's "1 + sum(P >= limit)" length rule.

    # GPU-style LUT (cross-check + CPU fast decode)
    lut_symbol = np.zeros(1 << l_max, dtype=np.uint8)
    lut_length = np.zeros(1 << l_max, dtype=np.uint8)
    for sym in order:
        l = int(lengths[sym])
        prefix = int(codes[sym]) << (l_max - l)
        span = 1 << (l_max - l)
        lut_symbol[prefix : prefix + span] = sym
        lut_length[prefix : prefix + span] = l

    return HuffmanCodebook(
        l_max=l_max,
        lengths=lengths,
        codes=codes,
        sorted_symbols=sorted_symbols,
        rank_offset=rank_offset,
        first_code_shifted=first_code_shifted,
        limit_shifted=limit_shifted,
        lut_symbol=lut_symbol,
        lut_length=lut_length,
    )


def decode_prefix_arith(
    book: HuffmanCodebook, prefix: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Arithmetic canonical decode of L_max-bit prefixes (numpy oracle).

    Mirrors exactly what the decode kernel does: length via compares
    against ``limit_shifted``, rank arithmetic, then symbol lookup.
    """
    prefix = np.asarray(prefix, dtype=np.uint32)
    limits = book.limit_shifted[1:, None]  # [L, ...]
    ge = prefix[None, :] >= limits
    length = 1 + np.sum(ge, axis=0)
    length = np.minimum(length, book.l_max).astype(np.int32)
    fcs = book.first_code_shifted[length]
    rank = book.rank_offset[length] + (
        (prefix - fcs) >> (book.l_max - length)
    ).astype(np.int32)
    rank = np.clip(rank, 0, ALPHABET - 1)
    return book.sorted_symbols[rank], length
