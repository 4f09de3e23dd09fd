"""The launch shapes of the tunable H100 kernels, mirrored on the host.

Three launch shapes of the CUDA kernels can be chosen by the caller (the
tuning cache, :mod:`repro_torch.tuning.autotune`) instead of the kernels'
own pick:

  * ``lut_idct``'s register tile, ``rw`` windows a thread, 4 or 8
    (``csrc/dequant_idct.cuh::idct_tile_shape``);
  * ``encode_levels``' (and its gather arm's) register tile, 1, 2 or 4
    (``csrc/dct_quant.cuh::dct_tile_shape``);
  * the v3 stage's tile, ``tile_windows`` windows a CTA, a multiple of 256
    whose tile and head flags fit 44 KiB of shared memory
    (``csrc/decode_fused.cu::fptc_v3_expand_unpredict``).

On the card the launchers answer for themselves: ``launcher_idct_tile``,
``launcher_dct_tile`` and ``launcher_v3_tile_ok`` ask the built library
(``fptc_idct_tile``, ``fptc_levels_tile``, ``fptc_v3_tile_ok``), and the
tuner offers and keeps only the shapes they accept (``launcher=True``
below).  The other functions here are the host's copy of those rules, for
the CPU, where there is no library: the cost model charges the tiles they
give, and the CPU's tests hold the tuner's rules with them.  A card test
(``tests/test_torch_gpu.py``) and ``chip_smoke.py``'s tune phase hold the
copy equal to the library at every (E, N) from 1 to 128.  A launcher
refuses an illegal shape with an error code; nothing clamps it.  No launch
shape changes an output bit (the kernels' bit contracts).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

__all__ = [
    "H100_SMEM_OPTIN",
    "H100_SMEM_PER_SM",
    "IDCT_RWS",
    "LEVELS_RWS",
    "V3_TILES",
    "IdctTile",
    "DctTile",
    "idct_tile_shape",
    "dct_tile_shape",
    "v3_tile_ok",
    "launcher_idct_tile",
    "launcher_dct_tile",
    "launcher_v3_tile_ok",
    "v3_tile_windows",
    "idct_rws",
    "levels_rws",
    "v3_tiles",
    "coding_key",
]

# the H100's shared memory: a block's opt-in maximum (the launchers read it
# from the device; this is its value on an H100 SXM) and an SM's capacity
H100_SMEM_OPTIN = 232448
H100_SMEM_PER_SM = 233472

IDCT_RWS = (8, 4)  # lut_idct's register tiles, the pick's order
LEVELS_RWS = (4, 2, 1)  # levels_kernel's register tiles, the pick's order
V3_TILES = (256, 512, 1024, 2048, 4096)  # v3 tiles the tuner offers

_WARP = 32
_IDCT_THREADS = 256
_IDCT_WARPS = _IDCT_THREADS // _WARP
_TABLE_STRIDE = 257
_DCT_THREADS = 256
_STAGE_BUDGET = 80 * 1024
_V3_THREADS = 256
_V3_SMEM = 44 * 1024


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class IdctTile:
    """``dequant_idct.cuh``'s ``IdctTile``: ``rw`` windows a thread,
    ``bw`` windows a tile, ``aw`` warps with buffers, ``smem`` bytes."""

    rw: int
    bw: int
    aw: int
    smem: int


@dataclasses.dataclass(frozen=True)
class DctTile:
    """``dct_quant.cuh``'s ``DctTile``: ``rw`` windows a thread, ``wg``
    window groups, ``bw`` windows a tile, ``smem`` bytes."""

    rw: int
    wg: int
    bw: int
    smem: int


def idct_tile_shape(e: int, n: int, rw: int = 0,
                    max_smem: int = H100_SMEM_OPTIN):
    """``idct_tile_shape(e, n, max_smem, rw)``: the tile ``lut_idct``
    launches at (E, N), or None where the launcher refuses ``rw``.  ``rw``
    0 is the kernel's pick: 8 windows a thread where the buffers of all 8
    warps fit ``max_smem``, else 4 and fewer warps with buffers.  A forced
    8 must fit with every warp buffered; a forced 4 halves the warps with
    buffers as the pick does."""
    if rw not in (0, 4, 8):
        return None
    cg = -(-n // 4)
    cgt = cg if cg <= 2 else 4 * (-(-cg // 4))
    cgw = 8 if cgt % 8 == 0 else (cgt if cgt < 4 else 4)
    wgw, cb = _WARP // cgw, cgt // cgw
    np_, ep = 4 * cgt, 4 * ((-(-e // 4)) | 1)
    t_rw = rw or 8
    sets, aw = max(1, _IDCT_WARPS // cb), _IDCT_WARPS
    while True:
        sw = wgw * t_rw
        smem = (_align16(4 * e * _TABLE_STRIDE) + _align16(4 * e * np_)
                + 4 * aw * sw * ep + 2 * aw * _align16(sw * e + 16))
        if smem <= max_smem:
            break
        if t_rw > 4:
            if rw:
                return None
            t_rw = 4
        elif aw > 1:
            aw //= 2
        else:
            break
    return IdctTile(rw=t_rw, bw=sets * sw, aw=aw, smem=smem)


def dct_tile_shape(n: int, e: int, rw: int = 0):
    """``dct_tile_shape(n, e, rw)``: the tile ``levels_kernel`` launches at
    (N, E), or None where the launcher refuses ``rw``.  ``rw`` 0 is the
    kernel's pick: 4 windows a thread and every thread busy, halved (rw,
    then the window groups) until the two staging buffers fit 80 KiB.  A
    forced rw must fit with every thread busy, except 1, which halves the
    window groups as the pick does."""
    if rw not in (0, 1, 2, 4):
        return None
    kg = -(-e // 4)
    ep = 4 * kg
    stride = 4 * ((-(-n // 4)) | 1)
    wg, t_rw = _DCT_THREADS // kg, rw or 4
    while 2 * (wg * t_rw + 2) * stride * 4 > _STAGE_BUDGET:
        if t_rw > 1:
            if rw:
                return None
            t_rw //= 2
        else:
            wg //= 2
    bw = wg * t_rw
    ls = 4 * (kg | 1)
    x = _align16(4 * n * ep) + _align16(4 * (2 * e + 3))
    nz = x + 4 * 2 * (bw + 2) * stride
    lv = nz + _align16(4 * (e + 2)) + _align16(bw)
    smem = lv + _align16((bw + 2) * ls) + _align16(2 * ls) + bw * e + 16
    return DctTile(rw=t_rw, wg=wg, bw=bw, smem=smem)


def v3_tile_ok(tile: int, e: int) -> bool:
    """Whether ``fptc_v3_expand_unpredict`` accepts ``tile`` windows a
    tile at ``e`` bands: a positive multiple of 256 whose tile and head
    flags fit 44 KiB."""
    return (isinstance(tile, int) and tile > 0 and tile % _V3_THREADS == 0
            and tile * (e + 1) <= _V3_SMEM)


def v3_tile_windows(e: int) -> int:
    """The v3 stage's own pick for ``e`` bands: a multiple of 256 (the
    scan's rounds), about 8 KiB of levels a tile, at most 1024 windows."""
    if not 1 <= e <= 128:
        raise ValueError(f"the v3 stage takes 1 <= e <= 128 bands, got {e}")
    return 256 * min(4, max(1, 8192 // (256 * e)))


def _ask(fn: str, *args) -> Optional[Tuple[int, ...]]:
    """Call the library's tile rule ``fn`` (four int64 results), or None
    where it refuses."""
    from repro_torch.kernels import ops

    out = (ctypes.c_int64 * 4)()
    if getattr(ops.library(), fn)(*args, out) != 0:
        return None
    return tuple(out)


def launcher_idct_tile(e: int, n: int, rw: int = 0, max_smem: int = 0):
    """The tile ``lut_idct``'s launcher takes at (E, N) for ``rw``, asked
    of the built library; ``max_smem`` 0 is the current device's opt-in
    maximum.  None where the launcher refuses ``rw``."""
    got = _ask("fptc_idct_tile", int(e), int(n), int(rw), int(max_smem))
    return None if got is None else IdctTile(*got)


def launcher_dct_tile(n: int, e: int, rw: int = 0):
    """The tile ``levels_kernel``'s launchers take at (N, E) for ``rw``,
    asked of the built library; None where they refuse ``rw``."""
    got = _ask("fptc_levels_tile", int(n), int(e), int(rw))
    return None if got is None else DctTile(*got)


def launcher_v3_tile_ok(tile: int, e: int) -> bool:
    """Whether the v3 stage's launcher accepts ``tile`` at ``e`` bands,
    asked of the built library."""
    from repro_torch.kernels import ops

    return bool(ops.library().fptc_v3_tile_ok(int(e), int(tile)))


def idct_rws(e: int, n: int, max_smem: int = H100_SMEM_OPTIN, *,
             launcher: bool = False) -> Tuple[int, ...]:
    """The register tiles ``lut_idct`` accepts at (E, N): by the host's
    copy of its rule, or (``launcher``) by the library's."""
    shape = launcher_idct_tile if launcher else idct_tile_shape
    return tuple(rw for rw in IDCT_RWS
                 if shape(e, n, rw, max_smem) is not None)


def levels_rws(n: int, e: int, *, launcher: bool = False
               ) -> Tuple[int, ...]:
    """The register tiles ``levels_kernel`` accepts at (N, E), as
    :func:`idct_rws` asks."""
    shape = launcher_dct_tile if launcher else dct_tile_shape
    return tuple(rw for rw in LEVELS_RWS if shape(n, e, rw) is not None)


def v3_tiles(e: int, *, launcher: bool = False) -> Tuple[int, ...]:
    """The v3 tiles the tuner offers at ``e`` bands, as :func:`idct_rws`
    asks."""
    ok = launcher_v3_tile_ok if launcher else v3_tile_ok
    return tuple(t for t in V3_TILES if ok(t, e))


def coding_key(coding) -> tuple:
    """A coding's part of a tuning plan key (the reference's
    ``ops._coding_key``): nothing for the trivial v1/v2 coding, else its
    three ints."""
    coding = tuple(coding)
    if coding == (0, 0, False):
        return ()
    return (int(coding[0]), int(coding[1]), int(bool(coding[2])))
