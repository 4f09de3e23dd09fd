"""Adversarial inputs for the SymLen word decode (K1 ``symlen_decode`` and
K6 ``symlen_tile``, both on the decode table of ``csrc/symlen_step.cuh``),
made with numpy from a seed; shared by the CPU tests (the plain versions
against the JAX reference), the card's tests (the kernels against the plain
versions) and ``chip_smoke.py``.  Imports neither JAX nor either package.

K1 gives each warp of its persistent CTAs a contiguous segment of warp
tiles of ``TILE`` words (4 consecutive words a lane), each tile's output
bytes staged in shared memory (room for 16 a word) and stored as one run
from the tile's base; K6 gives each thread 4 words 32 apart.  Both decode
through a table of 2**l_max entries.  So the layouts aim at what a tiled,
table-driven decode can get wrong:

  * ``l_max`` 1, 2, 8, 12 (every archive plan), 13 and 16 (the table past
    8 KiB, up to 128 KiB of shared memory);
  * ``stream``   — a packed stream of a complete canonical code with codes
    up to l_max bits, an all-zero padding word (symlen 0) every 37th word
    and the last 3;
  * ``clamped``  — the same stream decoded at a ``max_symlen`` below many
    words' symlen: each such word writes ``max_symlen`` symbols and leaves
    a gap of zeros up to its next offset;
  * ``one_bit``  — words of 64 one-bit codes (symlen 64) between stream
    words of the same code;
  * ``overflow`` — only words of 64 one-bit codes at ``max_symlen`` 8: every
    tile's run outgrows the stage (so does one in two of ``one_bit``);
  * ``random``   — random 64-bit words with random symlen (0 to 72, some
    past ``max_symlen``), under a code of random lengths that may be
    incomplete or oversubscribed, so that the length clamp and the rank
    clip decide symbols;
  * word counts of 1, ``TILE`` - 1, ``TILE``, ``TILE`` + 1 and several
    tiles; on the card (``BIG``) enough that every warp of K1 walks more
    than 4 tiles (at 4 CTAs of 8 warps an SM);
  * ``num_symbols`` below the total of the raw symlen (the clip), equal to
    it, and above it (the zero tail) — :func:`num_symbols_cases`;
  * (in the tests) ``words`` and ``symlen`` as views at an odd offset of
    larger buffers.

``TILE`` is ``kTileWords`` of ``csrc/symlen_decode.cu``: change both
together.
"""
import numpy as np

TILE = 128
L_MAXES = (1, 2, 8, 12, 13, 16)
LAYOUTS = ("stream", "clamped", "one_bit", "overflow", "random")
COUNTS = (1, TILE - 1, TILE, TILE + 1, 12 * TILE + 5)
# K1's warps on an H100 (132 SMs x 4 CTAs x 8 warps), 5 tiles each, and a
# ragged end
BIG = 132 * 4 * 8 * 5 * TILE + 77
ONE = 200  # the one-bit code's symbol
_BLOCK = 8192  # words generated at once; bigger counts repeat a block


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """The canonical codewords (right-aligned, uint64) of code lengths
    int[256] (0 = no code): sorted by (length, symbol), increasing."""
    order = np.lexsort((np.arange(256), lengths))
    order = order[lengths[order] > 0]
    codes = np.zeros(256, np.uint64)
    code, prev = 0, 0
    for sym in order:
        code <<= int(lengths[sym]) - prev
        codes[sym] = code
        code += 1
        prev = int(lengths[sym])
    return codes


def complete_lengths(l_max: int, rng) -> np.ndarray:
    """A complete prefix code with codes up to ``l_max`` bits (at least one
    of ``l_max``) on random symbols: split random leaves of a binary tree
    until it has min(256, 2**l_max) leaves."""
    leaves = [0]
    target = min(256, 1 << l_max)
    while len(leaves) < target:
        if max(leaves) < l_max and len(leaves) + 1 == target:
            i = int(np.argmax(leaves))  # the last split reaches l_max
        else:
            cand = [i for i, d in enumerate(leaves) if d < l_max]
            i = cand[int(rng.integers(len(cand)))]
        d = leaves.pop(i)
        leaves += [d + 1, d + 1]
    lengths = np.zeros(256, np.int32)
    lengths[rng.permutation(256)[:len(leaves)]] = leaves
    return lengths


def one_bit_lengths(l_max: int) -> np.ndarray:
    """Symbol ``ONE`` a one-bit code, the rest of the code space in codes
    of ``l_max`` bits (one more one-bit code at l_max = 1)."""
    lengths = np.zeros(256, np.int32)
    others = np.delete(np.arange(256), ONE)
    lengths[others[:min(255, 1 << (l_max - 1))]] = l_max
    lengths[ONE] = 1
    return lengths


def _pack(lengths: np.ndarray, count: int, rng):
    """``count`` words packed greedily (Algorithm 1) from random symbols of
    the code, skewed towards short codes: (words uint64, symlen int,
    symbols per word)."""
    codes = canonical_codes(lengths)
    coded = np.flatnonzero(lengths > 0)
    p = 2.0 ** -lengths[coded].astype(np.float64)
    p /= p.sum()
    sym = rng.choice(coded, size=(count, 64), p=p)
    ln = lengths[sym].astype(np.int64)
    end = np.cumsum(ln, axis=1)
    fits = end <= 64
    n = fits.sum(axis=1)
    shift = np.where(fits, 64 - end, 0).astype(np.uint64)
    part = np.where(fits, codes[sym] << shift, np.uint64(0))
    words = np.bitwise_or.reduce(part, axis=1).astype(np.uint64)
    return words, n, sym


def _repeat(count: int, make):
    """``make(k)`` for k words, made once for up to ``_BLOCK`` words and
    repeated past it."""
    k = min(count, _BLOCK)
    parts = make(k)
    reps = -(-count // k)
    return tuple(np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:count]
                 for a in parts)


def _dense(sym, sl):
    """The first sl[w] symbols of each word, in order (None past
    ``_BLOCK`` words, where no test reads them)."""
    if sl.size > _BLOCK:
        return None
    return sym[np.arange(64)[None, :] < sl[:, None]].astype(np.uint8)


def bucket(x: int) -> int:
    """The engine's ``symlen_bucket``: up to a multiple of 8, cap 64."""
    return min(-(-max(int(x), 1) // 8) * 8, 64)


def symlen_case(l_max: int, layout: str, count: int, seed: int = 0) -> dict:
    """One decode input: ``words`` uint64[count], ``symlen`` uint8[count],
    the code ``lengths`` int32[256] (its decode tables come from the
    packages' ``codebook_from_lengths``), ``max_symlen``, ``total`` (the sum
    of the raw symlen) and, where the words are a packed stream decoded
    whole and ``count`` is at most 8192, ``symbols`` (the dense stream) —
    else None."""
    rng = np.random.default_rng([seed, l_max, LAYOUTS.index(layout), count])
    symbols = None
    if layout in ("stream", "clamped"):
        lengths = complete_lengths(l_max, rng)

        def make(k):
            words, n, sym = _pack(lengths, k, rng)
            pad = np.arange(k) % 37 == 36
            pad[max(k - 3, 1):] = True
            return (np.where(pad, np.uint64(0), words),
                    np.where(pad, 0, n), sym)

        words, sl, sym = _repeat(count, make)
        ms = bucket(sl.max())
        if layout == "clamped":
            ms = max(1, min(int(np.median(sl[sl > 0])), int(sl.max()) - 1))
        else:
            symbols = _dense(sym, sl)
    elif layout in ("one_bit", "overflow"):
        lengths = one_bit_lengths(l_max)
        one = np.uint64(0)
        for _ in range(64):
            one = (one << np.uint64(1)) | canonical_codes(lengths)[ONE]

        def make(k):
            words, n, sym = _pack(lengths, k, rng)
            ones = np.arange(k) % 2 == 0
            if layout == "overflow":
                ones[:] = True
            sym = np.where(ones[:, None], ONE, sym)
            return (np.where(ones, one, words), np.where(ones, 64, n), sym)

        words, sl, sym = _repeat(count, make)
        ms = 8 if layout == "overflow" else 64
        if layout == "one_bit":
            symbols = _dense(sym, sl)
    else:
        lengths = rng.integers(0, l_max + 1, size=256).astype(np.int32)
        lengths[int(rng.integers(256))] = l_max

        def make(k):
            w = rng.integers(0, 1 << 63, size=k, dtype=np.uint64)
            w = (w << np.uint64(1)) | rng.integers(0, 2, size=k,
                                                   dtype=np.uint64)
            return w, rng.integers(0, 73, size=k)

        words, sl = _repeat(count, make)
        ms = 64
    sl = sl.astype(np.uint8)
    return dict(words=words.astype(np.uint64), symlen=sl, lengths=lengths,
                max_symlen=ms, total=int(sl.astype(np.int64).sum()),
                symbols=symbols)


def num_symbols_cases(total: int):
    """``num_symbols`` below the total (the clip), at it, and past it (the
    zero tail); at least 1."""
    return sorted({max(1, total - max(1, total // 7)), max(1, total),
                   total + 37})
