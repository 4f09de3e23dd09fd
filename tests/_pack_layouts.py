"""Adversarial inputs for K4's SymLen pack (``symlen_pack``), made with numpy
from a seed; shared by the CPU tests (the plain pack against the JAX
reference), the card's tests (the kernel against the plain pack) and
``chip_smoke.py`` (the same layouts at archive shape).  Imports neither JAX
nor either package.

The kernel packs each chunk in tiles of ``TILE`` symbols, carrying the open
word from tile to tile, so the layouts aim at what a tiled greedy pack can
get wrong:

  * ``exact64``      — every word exactly 64 bits (4 to 64 symbols), so the
    next codeword always flushes;
  * ``edge_on`` / ``edge_before`` / ``edge_after`` — 64-bit words laid out
    from each chunk's start so that a word starts on, one before and one
    after every tile edge of the chunk;
  * ``gap_after_full`` — a gap symbol (valid, code length 0) right after
    every third full word, and one at each chunk's start;
  * ``masked``       — zero planes: every tile-aligned run of windows and a
    band masked, one row masked whole (chunks with no word), the tail of
    each row padding;
  * ``one_bit`` / ``sixteen_bit`` — 1-bit codes (64 symbols a word) and
    16-bit codes (4 a word);
  * ``random``       — a skewed book, random symbols, rows cut at random
    counts (one mid-window).

``CHUNKS`` are the chunk sizes each layout runs at; ``None`` is exact mode
(one chunk per row, ``Wp * E`` symbols).  At the tests' shape (549 windows
of 8 bands, 4392 slots) no chunk size but 1 divides a row, so every one but
that ends in a partial chunk.
"""
import numpy as np

TILE = 1024
LAYOUTS = ("exact64", "edge_on", "edge_before", "edge_after",
           "gap_after_full", "masked", "one_bit", "sixteen_bit", "random")
CHUNKS = (1, 63, 1000, 1024, 4097, None)
GAP = 255  # the gap book's symbol with no codeword

_V2 = (0, 0, False)
_CODING = {"exact64": (1, 2, False), "masked": (2, 2, True),
           "sixteen_bit": (1, 1, False)}


def _book(rng, gaps: bool):
    """Symbol v has a code of length 1 + v % 16 with random bits (the pack
    needs no prefix code); with ``gaps`` symbol ``GAP`` has none."""
    lengths = (1 + np.arange(256) % 16).astype(np.int32)
    codes = rng.integers(0, 1 << lengths.astype(np.int64)).astype(np.int64)
    if gaps:
        lengths[GAP] = 0
        codes[GAP] = 0
    return codes, lengths


def _symbols_of(lens, rng):
    """A symbol of the book of :func:`_book` for each code length (0: the
    gap symbol)."""
    sym = (lens - 1) + 16 * rng.integers(0, 15, size=lens.size)
    return np.where(lens == 0, GAP, sym).astype(np.uint8)


def _exact_words(sizes, gap_after=None):
    """Code lengths of words of ``sizes`` symbols, each exactly 64 bits
    (sizes 4..64), a gap symbol (length 0) after each word flagged in
    ``gap_after``."""
    sizes = np.asarray(sizes, np.int64)
    extra = np.zeros_like(sizes) if gap_after is None else gap_after.astype(
        np.int64)
    unit = sizes + extra
    word = np.repeat(np.arange(sizes.size), unit)
    j = np.arange(unit.sum()) - np.repeat(np.cumsum(unit) - unit, unit)
    k = sizes[word]
    lens = np.minimum(64 // k + (j < 64 % k), 16)  # k < 4: a short last word
    return np.where(j < k, lens, 0)


def _edge_sizes(length: int, shift: int):
    """Word sizes filling ``length`` symbols so that a word starts at every
    ``TILE * m + shift`` (m >= 1) below ``length``: 16-symbol words, the
    last word of each span longer."""
    sizes = []
    start = 0
    for edge in list(range(TILE + shift, length, TILE)) + [length]:
        span = edge - start
        q, r = divmod(span, 16)
        if q == 0:
            sizes.append(span)
        else:
            sizes += [16] * (q - 1) + [16 + r]
        start = edge
    return sizes


def _row_lengths(name, sp, chunk, rng):
    """The code lengths of a row's slots (valid or not), the same for every
    row.  Words restart at each chunk, so the words are laid out per chunk
    (one run for chunks under 64 symbols, which hold no tile edge)."""
    if name == "one_bit":
        return np.ones(sp, np.int64)
    if name == "sixteen_bit":
        return np.full(sp, 16, np.int64)
    if chunk < 64:
        chunk = sp
    out = []
    for p0 in range(0, sp, chunk):
        n = min(chunk, sp - p0)
        if name.startswith("edge_"):
            shift = {"edge_on": 0, "edge_before": -1, "edge_after": 1}[name]
            lens = _exact_words([s for s in _edge_sizes(n, shift) if s])
        else:
            sizes = rng.integers(4, 65, size=n // 4 + 2)
            gaps = None
            if name == "gap_after_full":
                gaps = np.arange(sizes.size) % 3 == 0
            lens = _exact_words(sizes, gaps)
            if name == "gap_after_full":
                lens = np.concatenate([[0], lens])
        out.append(lens[:n])
    return np.concatenate(out)


def pack_case(name: str, chunk=None, *, rows: int = 2, windows: int = 549,
              e: int = 8, seed: int = 0):
    """Layout ``name`` for chunk size ``chunk`` (None: exact mode): a dict
    of numpy arrays ``grid`` u8[rows, windows, e], ``zrow`` bool[rows,
    windows] and ``zcol`` bool[rows, e] (None without zero planes),
    ``counts`` i32[rows], ``codes`` i64[256], ``lengths`` i32[256], and
    ``coding`` and ``chunk`` (the chunk size, exact mode resolved)."""
    if name not in LAYOUTS:
        raise ValueError(f"unknown pack layout {name!r}")
    rng = np.random.default_rng(seed + LAYOUTS.index(name))
    sp = windows * e
    chunk = sp if chunk is None else int(chunk)
    coding = _CODING.get(name, _V2)
    codes, lengths = _book(rng, gaps=name == "gap_after_full")
    counts = np.full(rows, sp, np.int32)
    zrow = zcol = None
    if name == "random":
        # skewed lengths: short codes common, as a Huffman book makes them
        lengths = np.clip(rng.geometric(0.25, 256), 1, 16).astype(np.int32)
        codes = rng.integers(0, 1 << lengths.astype(np.int64)).astype(
            np.int64)
        p = 2.0 ** -lengths
        grid = rng.choice(256, size=(rows, sp), p=p / p.sum()).astype(
            np.uint8)
        counts[1:] = rng.integers(0, sp + 1, size=rows - 1)
        counts[min(1, rows - 1)] = sp - 333  # ends mid-window
    else:
        lens = np.tile(_row_lengths(name, sp, chunk, rng), rows)
        grid = _symbols_of(lens, rng).reshape(rows, sp)
    if name == "masked":
        counts[:] = (windows - windows // 10) * e  # the tail is padding
        slot_w = np.arange(windows) * e
        # the windows that start in tiles 2-3, 6-7, ... (with e | 2048,
        # those tiles whole)
        zrow = np.broadcast_to(
            (slot_w // (2 * TILE)) % 2 == 1, (rows, windows)).copy()
        zrow[:, ::7] |= rng.random((rows, windows))[:, ::7] < 0.5
        zrow[min(1, rows - 1)] = True  # a row with no coded cell
        zcol = np.zeros((rows, e), bool)
        zcol[:, e // 2] = True
    return dict(grid=grid.reshape(rows, windows, e), zrow=zrow, zcol=zcol,
                counts=counts, codes=codes, lengths=lengths, coding=coding,
                chunk=chunk)
