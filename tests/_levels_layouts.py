"""Adversarial inputs for the DCT + quantize kernels (K4a ``encode_levels``
with its gather arm, and K5 ``dct_quant``), made with numpy from a seed;
shared by the CPU tests (the plain versions against the JAX reference), the
card's tests (the kernels against the plain versions) and ``chip_smoke.py``
(the same layouts at archive width).  Imports neither JAX nor either
package.

The kernels walk (row, block of ``bw`` windows) tiles with persistent CTAs,
copy each tile's windows into shared memory 16 or 4 bytes at a time, and
recompute the two windows before a block for the v3 prediction, so the
layouts aim at what a tiled, double-buffered DCT can get wrong:

  * widths (``wp``, windows a row) of 1, one block less 1, one block plus 1
    and 8192 + 3, at (N, E) pairs from (4, 1) to (128, 128) — odd N makes
    ``wp * n % 4 != 0``, so rows and gather starts are not 16-byte aligned;
  * rows whose live windows sit on both sides of every block edge and of
    the row's edges (the prediction's halo), with zero windows between
    them (zero planes), dense random rows, rows of one repeated window
    (all-128 residuals), and rows of zeros but for the block edges;
  * counts covering the row, ending mid-block, ending mid-window (a count
    that is not a multiple of E), and 0;
  * gathered rows (``flat``, ``starts``, ``lens``) whose starts fall on
    every residue mod 4 floats, whose lens end mid-window, are 0, equal
    the width, end mid-block, and two rows sharing one run; the floats
    between runs and past the last are NaN, so a kernel that reads past a
    row's lens changes its levels (the plain gather masks them to 0).

``block_windows`` is the launchers' rule for ``bw`` (``dct_tile_shape`` in
``csrc/dct_quant.cuh``); ``walk_rows`` gives enough rows that every
persistent CTA of an H100 walks more than 4 tiles.
"""
import numpy as np

THREADS = 256  # kDctThreads
STAGE_BUDGET = 80 * 1024  # kStageBudget: bytes of the two staging buffers
PAIRS = ((4, 1), (5, 3), (16, 16), (32, 6), (32, 8), (32, 32), (128, 128))
BIG = 8192 + 3
# (pred_id, predict_bands, zero_planes); bands -1 predicts every band
CODINGS = ((0, 0, False), (1, 2, True), (2, 2, True), (2, -1, False))
KINDS = 6  # row kinds, by row index mod 6
# an upper bound on an H100's resident CTAs of 256 threads: 132 SMs x 8
MAX_RESIDENT = 132 * 8


def block_windows(n: int, e: int) -> int:
    """Windows a tile: 4 a thread over 256 / ceil(E / 4) window groups,
    halved (windows a thread, then groups) until the two staging buffers
    of bw + 2 windows (the block and its history) at a stride of
    4 * (ceil(N / 4) | 1) floats fit STAGE_BUDGET.  K4 and K5 alike."""
    kg = -(-e // 4)
    stride = 4 * ((-(-n // 4)) | 1)
    wg, rw = THREADS // kg, 4
    while 2 * (wg * rw + 2) * stride * 4 > STAGE_BUDGET:
        if rw > 1:
            rw //= 2
        else:
            wg //= 2
    return wg * rw


def widths(n: int, e: int, big: bool = True):
    """The row widths (windows) a pair is tested at; without ``big`` (the
    CPU tests) the widest is two blocks plus 3, not 8192 + 3."""
    b = block_windows(n, e)
    return tuple(sorted({1, b - 1, b + 1, BIG if big else 2 * b + 3} - {0}))


def walk_rows(n: int, e: int, wp: int) -> int:
    """Rows that give every persistent CTA more than 4 tiles."""
    nblk = -(-wp // block_windows(n, e))
    return max(KINDS, -(-5 * MAX_RESIDENT // nblk))


def coding_of(coding, e: int):
    pred, bands, zp = coding
    return (pred, e if bands < 0 else bands, zp)


def quant_table(e: int, seed: int = 0):
    """zone int32[E] (0, 1, 2 by turns from a random start), scale f32[E],
    mu, alpha1."""
    rng = np.random.default_rng(seed)
    zone = ((np.arange(e) + rng.integers(0, 3)) % 3).astype(np.int32)
    scale = rng.uniform(0.5, 3.0, size=e).astype(np.float32)
    return zone, scale, np.float32(255.0), np.float32(0.15)


def _row(kind: int, wp: int, n: int, b: int, rng) -> np.ndarray:
    w = np.arange(wp)
    edge = (w % b >= b - 2) | (w % b < 2) | (w >= wp - 2) | (w < 2)
    if kind in (0, 4):  # live at block and row edges (4: only there)
        live = edge | (rng.random(wp) < (0.1 if kind == 0 else 0.0))
        x = rng.standard_normal((wp, n)) * 1.5 * live[:, None]
    elif kind == 5:  # one window repeated: every residual 128
        x = np.repeat(rng.standard_normal((1, n)) * 1.5, wp, axis=0)
    else:  # dense random
        x = rng.standard_normal((wp, n)) * 1.5
    return x.astype(np.float32).ravel()


def _nvalid(kind: int, wp: int, b: int) -> int:
    """True windows of a row of this kind (kind 3 adds half a window)."""
    if kind == 1:  # ending mid-block
        return min(wp, (wp - 1) // b * b + max(1, b // 2))
    if kind == 2:
        return 0
    if kind == 3:
        return wp // 2
    return wp


def levels_case(n: int, e: int, wp: int, coding, rows: int = KINDS,
                seed: int = 0) -> dict:
    """One encode_levels layout: ``signals`` f32[rows, wp * n] and
    ``counts`` i32[rows] for the dense arm; ``flat``, ``starts``, ``lens``
    and ``gcounts`` for the gather arm (its rows ``width = wp * n`` wide);
    the quant table (``zone``, ``scale``, ``mu``, ``alpha1``); ``coding``
    with its bands resolved."""
    rng = np.random.default_rng(seed + 1000 * n + 10 * e + wp)
    b = block_windows(n, e)
    width = wp * n
    signals = np.stack([_row(r % KINDS, wp, n, b, rng) for r in range(rows)])
    counts = np.array([_nvalid(r % KINDS, wp, b) * e
                       + (e // 2 if r % KINDS == 3 else 0)
                       for r in range(rows)], np.int32)
    # gather: row r's run is the first lens[r] samples of signals[r]
    lens = np.empty(rows, np.int64)
    for r in range(rows):
        kind = r % KINDS
        lens[r] = {0: width, 1: width - n // 2 - 1, 2: 0, 3: width,
                   4: (b // 2) * n + 1, 5: width}[kind]
    lens = np.clip(lens, 0, width)
    runs, starts, off = [], np.zeros(rows, np.int64), 0
    for r in range(rows):
        if r % KINDS == 3:  # shares the run of the row 3 before it
            starts[r] = starts[r - 3]
            lens[r] = lens[r - 3]
            continue
        gap = r % 4  # NaNs before the run: starts on every residue mod 4
        runs.append(np.full(gap, np.nan, np.float32))
        off += gap
        starts[r] = off if lens[r] else 0
        runs.append(signals[r, :lens[r]])
        off += lens[r]
    runs.append(np.full(width, np.nan, np.float32))  # the plain pad
    flat = np.concatenate(runs).astype(np.float32)
    gwin = -(-lens // n)
    gcounts = (gwin * e - np.where(np.arange(rows) % KINDS == 1, e // 2, 0))
    zone, scale, mu, alpha1 = quant_table(e, seed + e)
    return dict(n=n, e=e, wp=wp, width=width, coding=coding_of(coding, e),
                signals=signals, counts=counts, flat=flat,
                starts=starts.astype(np.int32), lens=lens.astype(np.int32),
                gcounts=np.maximum(gcounts, 0).astype(np.int32), zone=zone,
                scale=scale, mu=mu, alpha1=alpha1)


def dct_case(n: int, e: int, num_windows: int, seed: int = 0) -> dict:
    """One dct_quant layout: ``windows`` f32[num_windows + 1, n] (the
    kernels are also run on ``windows[1:]``, not 16-byte aligned for
    N % 4 != 0, and on num_windows windows from its second sample) and the
    quant table."""
    rng = np.random.default_rng(seed + 1000 * n + 10 * e + num_windows)
    x = np.cumsum(rng.standard_normal((num_windows + 1, n)), axis=1) * 0.5
    zone, scale, mu, alpha1 = quant_table(e, seed + e)
    return dict(n=n, e=e, windows=x.astype(np.float32), zone=zone,
                scale=scale, mu=mu, alpha1=alpha1)
