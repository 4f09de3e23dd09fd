"""Adversarial inputs for the dequant + iDCT kernels (K2's ``lut_idct`` and
K3 ``idct_dequant``, both on ``csrc/dequant_idct.cuh``), made with numpy
from a seed; shared by the CPU tests (the plain versions against the JAX
reference), the card's tests (the kernels against the plain versions) and
``chip_smoke.py``.  Imports neither JAX nor either package.

The kernel walks tiles of ``bw`` windows with persistent CTAs, each warp
taking window sets of a tile; a warp copies a set's level bytes into
shared memory 16 at a time from the first 16-byte boundary (single bytes
before it) and dequantizes four bands a 32-bit read where the bands allow,
so the layouts aim at what a tiled, double-buffered dequant + iDCT can get
wrong:

  * window counts of 1, less than one tile, one window past a multiple of
    the tile, and (on the card) enough tiles that every persistent CTA
    walks more than 4 of them, the last tile ragged and the CTAs' ranges
    uneven;
  * a levels base at every byte offset 0-15 (the caller slices a buffer);
  * (E, N) pairs of the archive and the KV block, odd ones (E and N not
    multiples of 4) and the largest the wrappers take (E = N = 128, where
    the register tile shrinks and two warps of a CTA do the work);
  * every one of the 256 levels in every band: row r < 256 holds level r in
    all bands, the rest are random.

``block_windows`` is the launcher's rule for ``bw`` (``idct_tile_shape`` in
``csrc/dequant_idct.cuh``): change both together.
"""
import numpy as np

from _levels_layouts import quant_table

THREADS = 256  # kIdctThreads
WARPS = THREADS // 32
TABLE_STRIDE = 257  # floats a band of the shared dequant table
MAX_SMEM = 232448  # an H100's shared memory a block may opt in to
# (E, N): the archive's widths, the KV block's, odd ones, the largest
PAIRS = ((6, 32), (8, 32), (16, 32), (32, 32), (16, 16), (5, 17), (64, 64),
         (128, 128))
# an upper bound on an H100's resident CTAs of 256 threads: 132 SMs x 8
MAX_RESIDENT = 132 * 8


def _align16(b: int) -> int:
    return (b + 15) & ~15


def tile_shape(e: int, n: int) -> dict:
    """``idct_tile_shape``: column groups of 4 padded (1, 2, 4 or a multiple
    of 4), 8 of them a warp where they come in eights (else at most 4), 32 /
    cgw windows a warp row; rw = 8 windows a thread, sets of sw = wgw * rw
    windows, 8 / cb sets a tile, and 8 warps with buffers; rw, then the
    warps with buffers, halved until the shared memory (the [E][257] table,
    the [E][np] basis, and each busy warp's [sw][ep] coefficients and two
    level buffers) fits MAX_SMEM."""
    cg = -(-n // 4)
    cgt = cg if cg <= 2 else 4 * (-(-cg // 4))
    cgw = 8 if cgt % 8 == 0 else (cgt if cgt < 4 else 4)
    wgw, cb = 32 // cgw, cgt // cgw
    np_, ep = 4 * cgt, 4 * ((-(-e // 4)) | 1)
    rw, sets, aw = 8, max(1, WARPS // cb), WARPS
    while True:
        sw = wgw * rw
        smem = (_align16(4 * e * TABLE_STRIDE) + _align16(4 * e * np_)
                + 4 * aw * sw * ep + 2 * aw * _align16(sw * e + 16))
        if smem <= MAX_SMEM:
            break
        if rw > 4:
            rw = 4
        elif aw > 1:
            aw //= 2
        else:
            break
    return dict(rw=rw, sets=sets, aw=aw, bw=sets * sw, smem=smem)


def block_windows(e: int, n: int) -> int:
    """Windows a tile."""
    return tile_shape(e, n)["bw"]


def walk_windows(e: int, n: int) -> int:
    """A window count whose tiles (the last one ragged) give every
    persistent CTA more than 4 tiles, in ranges of uneven length."""
    bw = block_windows(e, n)
    return bw * (5 * MAX_RESIDENT + 3) + bw // 3 + 1


def widths(e: int, n: int, big: bool = True):
    """The window counts a pair is tested at; without ``big`` (the CPU
    tests) the widest is 259 windows (every level in every band, and a
    few past) in place of ``walk_windows``."""
    b = block_windows(e, n)
    last = walk_windows(e, n) if big else 259
    return tuple(sorted({1, max(1, b // 2), 3 * b + 1, last}))


def idct_case(e: int, n: int, num_windows: int, seed: int = 0) -> dict:
    """One layout: ``levels`` u8[num_windows, e] (row r < 256 holds level r
    in every band), a ``lut`` f32[e, 256] and ``basis`` f32[e, n] of random
    normals, and a quant table (``zone``, ``scale``, ``mu``, ``alpha1``)."""
    rng = np.random.default_rng(seed + 1000 * n + 10 * e + num_windows)
    levels = rng.integers(0, 256, size=(num_windows, e), dtype=np.uint8)
    head = min(num_windows, 256)
    levels[:head] = np.arange(head, dtype=np.uint8)[:, None]
    lut = rng.standard_normal((e, 256)).astype(np.float32)
    basis = (rng.standard_normal((e, n)) * 0.5).astype(np.float32)
    zone, scale, mu, alpha1 = quant_table(e, seed + e)
    return dict(e=e, n=n, levels=levels, lut=lut, basis=basis, zone=zone,
                scale=scale, mu=mu, alpha1=alpha1)


def every_level(e: int, n: int):
    """The exhaustive dequant layout: levels u8[256, e] whose row r holds
    level r in every band, and the basis [I_E | 0] (f32[e, n]), so that
    ``out[:, :e]`` is the dequant table itself (transposed) and
    ``out[:, e:]`` zero."""
    levels = np.repeat(np.arange(256, dtype=np.uint8)[:, None], e, axis=1)
    basis = np.eye(e, n, dtype=np.float32)
    return levels, basis
