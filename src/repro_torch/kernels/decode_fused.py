"""K2: the bucket decode — packed words -> windows f32[num_windows, N].

Replaces ``repro/kernels/decode_fused.py::decode_fused``, the TPU
megakernel that runs K1's decode, then for container-v3 codings the
``expand_coded_stream`` gather and ``unpredict_levels`` segmented cumsum,
then the LUT dequant and the iDCT product, in one ``pallas_call``.  On the
H100 it is three launches for now (``csrc/symlen_decode.cu`` writes dense
u8 levels to device memory, ``csrc/decode_fused.cu`` expands and
un-predicts them for v3, then dequantizes and multiplies), until
measurements say fusing pays.  ``csrc/decode_fused.cu``'s header says what
bounds each stage and what its design does about it.

Plain version: :func:`decode_fused_plain`, the math of the reference's XLA
arm (``serving/batch_decode.py::_decode_bucket_math(use_kernels=False)``).
Each wrapper here takes its plain version for CPU tensors and launches its
kernel for CUDA tensors.

Two launch shapes are tunable (:mod:`repro_torch.kernels.tiles`):
``lut_idct``'s register tile (``rw``) and the v3 stage's tile
(``tile_windows``).  Their wrappers take the shape they are given (0 or
None: the kernels' own pick); :func:`decode_fused` resolves both from the
tuning cache (``tuned_blocks("decode", ...)``, the reference's
``ops.decode_bucket_fused`` consult, through this module's memo) unless
the caller pins them, as the sweep does.  No shape changes an output
bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.calibration import DeviceTables
from repro_torch.core.quantize import expand_coded_stream, unpredict_levels
from repro_torch.kernels import huffman_decode as _hd
from repro_torch.kernels import ops
from repro_torch.kernels.tiles import coding_key, v3_tile_windows
from repro_torch.tuning.autotune import BlockMemo

__all__ = [
    "TRIVIAL",
    "bucket_levels",
    "bucket_levels_plain",
    "v3_expand_unpredict_cuda",
    "v3_expand_unpredict_plain",
    "v3_tile_windows",
    "lut_idct",
    "lut_idct_plain",
    "decode_fused",
    "decode_fused_plain",
    "tuning_plan_key",
]

TRIVIAL = (0, 0, False)  # no predictor, no zero planes: the v1/v2 stream

V3 = Optional[Tuple[torch.Tensor, torch.Tensor]]

def _v3_arrays(v3: V3, coding) -> Tuple[torch.Tensor, torch.Tensor]:
    if v3 is None:
        raise ValueError(
            f"v3 coding {coding} needs the idx/seg expansion arrays "
            "(symlen.v3_expand_index)"
        )
    return v3


# ---------------------------------------------------------------------------
# Stages 1-2: words -> uint8 levels [num_windows, e].
# ---------------------------------------------------------------------------
def bucket_levels_plain(words, symlen, tables: DeviceTables, v3: V3 = None, *,
                        l_max: int, max_symlen: int, num_windows: int, e: int,
                        coding=TRIVIAL) -> torch.Tensor:
    """The plain version of K1 + the v3 expansion/un-prediction."""
    syms = _hd.huffman_decode_plain(
        words, symlen, tables, l_max=l_max, max_symlen=max_symlen,
        num_symbols=num_windows * e,
    )
    if tuple(coding) == TRIVIAL:
        return syms.reshape(num_windows, e)
    idx, seg = _v3_arrays(v3, coding)
    pred_id, bands, _ = coding
    return v3_expand_unpredict_plain(syms, idx, seg, num_windows=num_windows,
                                     e=e, pred_id=pred_id, bands=bands)


def v3_expand_unpredict_plain(dense, idx, seg, *, num_windows: int, e: int,
                              pred_id: int, bands: int) -> torch.Tensor:
    """The plain version of K2's v3 stage (runs on any device)."""
    grid = expand_coded_stream(dense, idx).reshape(num_windows, e)
    return unpredict_levels(grid, seg, pred_id, bands)


def v3_expand_unpredict_cuda(dense, idx, seg, *, num_windows: int, e: int,
                             pred_id: int, bands: int,
                             tile_windows: int = 0) -> torch.Tensor:
    """Launch K2's v3 stage on CUDA tensors: dense coded symbols uint8,
    idx int32[num_windows * e], seg int32[num_windows] -> uint8 levels
    ``[num_windows, e]``.  ``tile_windows``: windows a tile, 0 for the
    stage's own pick (:func:`~repro_torch.kernels.tiles.v3_tile_windows`);
    the launcher refuses a tile it cannot hold."""
    dev = dense.device
    if dense.dtype != torch.uint8 or dense.dim() != 1:
        raise TypeError("v3 dense symbols must be a flat uint8 tensor")
    if idx.dtype != torch.int32 or seg.dtype != torch.int32:
        raise TypeError("v3 idx/seg must be int32")
    if not 0 <= bands <= e:
        raise ValueError(f"predict_bands {bands} is not in [0, {e}]")
    if idx.shape != (num_windows * e,) or seg.shape != (num_windows,):
        raise ValueError(
            f"v3 idx {tuple(idx.shape)} / seg {tuple(seg.shape)} do not "
            f"match the bucket's {num_windows} windows x {e} bands"
        )
    if idx.device != dev or seg.device != dev:
        raise ValueError("v3 inputs must share the levels' CUDA device")
    tile = int(tile_windows) or v3_tile_windows(e)
    dense = dense.contiguous()
    idx = idx.contiguous()
    if idx.data_ptr() % 16:  # the kernel reads idx 16 bytes at a time
        idx = idx.clone()
    seg = seg.contiguous()
    grid = torch.empty(num_windows * e, dtype=torch.uint8, device=dev)
    tiles = -(-num_windows // tile)
    scratch = torch.empty(tiles * (bands + 1), dtype=torch.int32, device=dev)
    ops.launch(
        "v3_unpredict", "fptc_v3_expand_unpredict", dev,
        dense.data_ptr(), dense.shape[0], idx.data_ptr(), seg.data_ptr(),
        num_windows, e, bands, pred_id, tile, grid.data_ptr(),
        scratch.data_ptr(),
    )
    return grid.reshape(num_windows, e)


def bucket_levels(words, symlen, tables: DeviceTables, v3: V3 = None, *,
                  l_max: int, max_symlen: int, num_windows: int, e: int,
                  coding=TRIVIAL, v3_tile_windows: int = 0) -> torch.Tensor:
    """K1's decode, then (v3) expansion + un-prediction: uint8 levels
    ``[num_windows, e]``.  ``v3`` is ``(idx, seg)`` from
    ``symlen.v3_expand_index`` at this bucket's window count;
    ``v3_tile_windows`` the v3 stage's tile (0: its own pick)."""
    coding = tuple(coding)
    kw = dict(l_max=l_max, max_symlen=max_symlen, num_windows=num_windows,
              e=e, coding=coding)
    if not ops.is_cuda(words):
        return bucket_levels_plain(words, symlen, tables, v3, **kw)
    dense = _hd.huffman_decode_dense(
        words, symlen, tables, l_max=l_max, max_symlen=max_symlen,
        num_symbols=num_windows * e,
    )
    if coding == TRIVIAL:
        return dense.reshape(num_windows, e)
    idx, seg = _v3_arrays(v3, coding)
    pred_id, bands, _ = coding
    return v3_expand_unpredict_cuda(dense, idx, seg, num_windows=num_windows,
                                    e=e, pred_id=pred_id, bands=bands,
                                    tile_windows=v3_tile_windows)


# ---------------------------------------------------------------------------
# Stage 3: LUT dequant + iDCT.
# ---------------------------------------------------------------------------
def lut_idct_plain(levels, lut, basis) -> torch.Tensor:
    """coeffs[w, k] = lut[k, levels[w, k]], then coeffs @ basis."""
    e = lut.shape[0]
    k = torch.arange(e, device=levels.device)
    coeffs = lut[k[None, :], levels.long()]
    return coeffs @ basis


def lut_idct(levels, lut, basis, rw: int = 0) -> torch.Tensor:
    """levels uint8[W, E], lut f32[E, 256], basis f32[E, N] -> f32[W, N].
    ``rw``: the kernel's register tile, windows a thread (4 or 8; 0 for its
    own pick, :func:`~repro_torch.kernels.tiles.idct_tile_shape`); the
    launcher refuses an rw whose buffers do not fit."""
    if not ops.is_cuda(levels):
        return lut_idct_plain(levels, lut, basis)
    dev = levels.device
    w, e = levels.shape
    n = basis.shape[1]
    if levels.dtype != torch.uint8:
        raise TypeError(f"lut_idct takes uint8 levels, got {levels.dtype}")
    if lut.shape != (e, 256) or basis.shape[0] != e or not 1 <= e <= n <= 128:
        raise ValueError(
            f"lut {tuple(lut.shape)} / basis {tuple(basis.shape)} do not "
            f"match levels [{w}, {e}] (need E <= N <= 128)"
        )
    if lut.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError("lut_idct takes f32 lut and basis")
    if lut.device != dev or basis.device != dev:
        raise ValueError("lut_idct inputs must share one CUDA device")
    levels = levels.contiguous()
    lut = lut.contiguous()
    basis = basis.contiguous()
    out = torch.empty(w, n, dtype=torch.float32, device=dev)
    ops.launch(
        "lut_idct", "fptc_lut_idct", dev,
        levels.data_ptr(), w, e, n, lut.data_ptr(), basis.data_ptr(),
        out.data_ptr(), int(rw),
    )
    return out


# ---------------------------------------------------------------------------
# The whole bucket decode.
# ---------------------------------------------------------------------------
def decode_fused_plain(words, symlen, tables: DeviceTables, lut, basis,
                       v3: V3 = None, *, l_max: int, max_symlen: int,
                       num_windows: int, n: int, e: int,
                       coding=TRIVIAL) -> torch.Tensor:
    """The plain version of K2 (runs on any device)."""
    del n
    levels = bucket_levels_plain(
        words, symlen, tables, v3, l_max=l_max, max_symlen=max_symlen,
        num_windows=num_windows, e=e, coding=coding,
    )
    return lut_idct_plain(levels, lut, basis)


def tuning_plan_key(n: int, e: int, l_max: int, max_symlen: int,
                    coding=TRIVIAL) -> tuple:
    """The tuning cache's plan key of a bucket decode (the reference's
    ``ops.decode_bucket_fused`` key): ``(n, e, l_max, max_symlen)``, then
    a non-trivial coding's three ints; the bucket shape ``(words,
    num_windows)`` completes the entry's key."""
    return (int(n), int(e), int(l_max), int(max_symlen)) + coding_key(coding)


# the launch shapes of the bucket decodes that do not pin them (the
# engines' among them), read from the tuning cache once per bucket shape
# and epoch
_BLOCKS = BlockMemo(tuning_plan_key)


def decode_fused(words, symlen, tables: DeviceTables, lut, basis,
                 v3: V3 = None, *, l_max: int, max_symlen: int,
                 num_windows: int, n: int, e: int, coding=TRIVIAL,
                 idct_rw: Optional[int] = None,
                 v3_tile_windows: Optional[int] = None) -> torch.Tensor:
    """Packed bucket -> windows f32[num_windows, N] (Huffman + compaction +
    v3 expansion/un-prediction + LUT dequant + iDCT).

    Padding words carry ``symlen == 0``; positions past the stream's true
    symbol total read as level 0, so padding windows dequantize
    ``lut[:, 0]`` in both arms — the whole outputs compare, not only the
    live rows.

    ``idct_rw`` / ``v3_tile_windows`` pin the launch shapes (0: the
    kernels' own pick); left None on the card they come from the tuning
    cache's entry for this plan key and bucket shape, or the kernels' own
    pick where it has none.  They change no output bit.
    """
    ops.check_i32_offsets(num_windows * e, max_symlen)
    if basis.shape != (e, n):
        raise ValueError(f"basis {tuple(basis.shape)} is not [{e}, {n}]")
    coding = tuple(coding)
    if (idct_rw is None or v3_tile_windows is None) and ops.is_cuda(words):
        blocks = _BLOCKS.get("decode", (n, e, l_max, max_symlen, coding),
                             (words.shape[0], num_windows), words.device)
        if idct_rw is None:
            idct_rw = blocks.get("idct_rw", 0)
        if v3_tile_windows is None:
            v3_tile_windows = blocks.get("v3_tile_windows", 0)
    levels = bucket_levels(words, symlen, tables, v3, l_max=l_max,
                           max_symlen=max_symlen, num_windows=num_windows,
                           e=e, coding=coding,
                           v3_tile_windows=v3_tile_windows or 0)
    return lut_idct(levels, lut, basis, rw=idct_rw or 0)
