"""K1: word-parallel SymLen Huffman decode + compaction; K6: the slot-major
decode tile; and the decode table both run on.

CUDA kernel: ``csrc/symlen_decode.cu`` (``fptc_symlen_decode``), which
replaces ``repro/kernels/huffman_decode.py::huffman_decode_dense``.  The
source's header says what bounds it on the H100 and how its design differs
from the TPU kernel: two launches from one call — a reduce pass that sums
the symlen sidecar over each warp's segment of tiles and builds the decode
table in the workspace, then persistent CTAs whose warps walk their own
segments in order, decoding each word by table reads into a shared-memory
stage and storing each tile's contiguous run of output bytes in 16-byte
stores.  It writes every output byte, zeros included, so the output is
taken with ``torch.empty``; its scratch (the table and the segments' sums)
comes from :func:`ops.workspace`.

Plain version: :func:`repro_torch.core.symlen.unpack_symlen`, the math of
the reference's XLA arm.  :func:`huffman_decode_dense` takes it for CPU
tensors and launches the kernel for CUDA tensors.

K6, ``csrc/symlen_tile.cu`` (``fptc_symlen_tile``), replaces
``repro/kernels/huffman_decode.py::huffman_decode_tile``: every slot of
every word decoded into a slot-major int32 tile ``[max_symlen, W]``, no
compaction.  It lies on no serving path of either package; it is the staged
decode (tile, then ``core.symlen.compact_padded_scatter``) that holds K1
independently.  Plain version: :func:`huffman_decode_tile_plain`
(``core.symlen.decode_tile``), the twin of the reference's
``kernels/ref.py::huffman_decode_padded_ref``.

Both kernels decode through the table of ``csrc/symlen_step.cuh``: entry
``p`` of 2**l_max is the symbol and the codeword length of a word whose
top ``l_max`` bits are ``p``, built on the device by the canonical
arithmetic, so a symbol is one table read and a shift.  Plain version:
:func:`decode_lut_plain`; :func:`decode_lut` builds it on the card by K1's
first kernel (``fptc_symlen_lut``) for the checks.
"""
from __future__ import annotations

import torch

from repro_torch.core.calibration import DeviceTables
from repro_torch.core.symlen import decode_lut as _decode_lut
from repro_torch.core.symlen import decode_tile, unpack_symlen
from repro_torch.kernels import ops

__all__ = [
    "huffman_decode_dense",
    "huffman_decode_plain",
    "symlen_decode_cuda",
    "huffman_decode_tile",
    "huffman_decode_tile_plain",
    "huffman_decode_padded",
    "symlen_tile_cuda",
    "decode_lut",
    "decode_lut_plain",
    "symlen_lut_cuda",
]

# K1's workspace: the decode table's region (2**16 entries of 2 bytes),
# then the int64 sums of the decode's CTAs and of their 8 warps each, 72
# bytes a CTA: room for 910 CTAs (the launcher caps its grid there)
WORKSPACE_BYTES = (2 << 16) + 8 * 8192


def huffman_decode_plain(words, symlen, tables: DeviceTables, *, l_max: int,
                         max_symlen: int, num_symbols: int) -> torch.Tensor:
    """The plain PyTorch version (runs on any device)."""
    return unpack_symlen(
        words, symlen, tables.dec_limit, tables.dec_first, tables.dec_rank,
        tables.dec_syms,
        l_max=l_max, max_symlen=max_symlen, num_symbols=num_symbols,
    )


def _check_tables(name: str, tables: DeviceTables, l_max: int,
                  dev: torch.device) -> None:
    """int32 decode tables for ``l_max`` on ``dev``."""
    if not 1 <= l_max <= 16 or tables.dec_limit.shape[0] != l_max:
        raise ValueError(f"tables do not match l_max={l_max}")
    parts = (tables.dec_limit, tables.dec_first, tables.dec_rank,
             tables.dec_syms)
    if any(t.device != dev for t in parts):
        raise ValueError(f"{name} inputs must share one CUDA device")
    if any(t.dtype != torch.int32 for t in parts):
        raise TypeError(f"{name} decode tables must be int32")


def _check_decode_args(name: str, words, tables: DeviceTables,
                       l_max: int) -> None:
    """The checks K1 and K6 share: int64 words [W] and int32 tables for
    ``l_max``, on the words' CUDA device."""
    if words.dtype != torch.int64 or words.ndim != 1:
        raise TypeError(f"{name} takes int64 words [W], got {words.dtype} "
                        f"{tuple(words.shape)}")
    _check_tables(name, tables, l_max, words.device)


def _table_ptrs(tables: DeviceTables):
    return (tables.dec_limit.contiguous().data_ptr(),
            tables.dec_first.contiguous().data_ptr(),
            tables.dec_rank.contiguous().data_ptr(),
            tables.dec_syms.contiguous().data_ptr())


def symlen_decode_cuda(words, symlen, tables: DeviceTables, *, l_max: int,
                       max_symlen: int, num_symbols: int) -> torch.Tensor:
    """Launch K1 on CUDA tensors: words int64[W] (uint64 bit patterns),
    symlen uint8[W] -> dense uint8[num_symbols]."""
    dev = words.device
    _check_decode_args("symlen_decode", words, tables, l_max)
    if symlen.dtype != torch.uint8:
        raise TypeError(
            f"symlen_decode takes int64 words and uint8 symlen, got "
            f"{words.dtype} and {symlen.dtype}"
        )
    if symlen.shape != words.shape or symlen.device != dev:
        raise ValueError(
            f"symlen {tuple(symlen.shape)} on {symlen.device} does not match "
            f"words {tuple(words.shape)} on {dev}"
        )
    words = words.contiguous()
    symlen = symlen.contiguous()
    out = torch.empty(num_symbols, dtype=torch.uint8, device=dev)
    ws = ops.workspace(dev, WORKSPACE_BYTES)
    ops.launch(
        "symlen_decode", "fptc_symlen_decode", dev,
        words.data_ptr(), symlen.data_ptr(), words.shape[0],
        *_table_ptrs(tables), l_max, max_symlen, ws.data_ptr(), ws.numel(),
        out.data_ptr(), num_symbols,
    )
    return out


def huffman_decode_dense(words, symlen, tables: DeviceTables, *, l_max: int,
                         max_symlen: int, num_symbols: int) -> torch.Tensor:
    """SymLen decode + compaction: packed words -> dense uint8[num_symbols].

    ``words`` holds the uint64 words' bit patterns as int64; padding words
    carry ``symlen == 0``; positions past the true symbol total read 0.
    """
    ops.check_i32_offsets(num_symbols, max_symlen)
    kw = dict(l_max=l_max, max_symlen=max_symlen, num_symbols=num_symbols)
    if ops.is_cuda(words):
        return symlen_decode_cuda(words, symlen, tables, **kw)
    return huffman_decode_plain(words, symlen, tables, **kw)


# ---------------------------------------------------------------------------
# K6: the slot-major tile.
# ---------------------------------------------------------------------------
def huffman_decode_tile_plain(words, tables: DeviceTables, *, l_max: int,
                              max_symlen: int) -> torch.Tensor:
    """The plain version of K6 (runs on any device)."""
    return decode_tile(
        words, tables.dec_limit, tables.dec_first, tables.dec_rank,
        tables.dec_syms, l_max=l_max, max_symlen=max_symlen,
    )


def symlen_tile_cuda(words, tables: DeviceTables, *, l_max: int,
                     max_symlen: int) -> torch.Tensor:
    """Launch K6 on CUDA tensors: words int64[W] (uint64 bit patterns) ->
    int32[max_symlen, W]."""
    dev = words.device
    _check_decode_args("symlen_tile", words, tables, l_max)
    words = words.contiguous()
    n = words.shape[0]
    out = torch.empty(max_symlen, n, dtype=torch.int32, device=dev)
    if n == 0 or max_symlen == 0:
        return out  # nothing to launch
    ops.launch(
        "symlen_tile", "fptc_symlen_tile", dev,
        words.data_ptr(), n, *_table_ptrs(tables), l_max, max_symlen,
        out.data_ptr(),
    )
    return out


def huffman_decode_tile(words, tables: DeviceTables, *, l_max: int,
                        max_symlen: int) -> torch.Tensor:
    """Decode every slot of every word: words int64[W] (the uint64 words'
    bit patterns) -> the slot-major tile int32[max_symlen, W].

    Slot ``j`` of word ``w`` is ``tile[j, w]``; slots past a word's symlen
    and padding words decode whatever bits are left (the contract of the
    reference's tile, which its tests compare whole).  ``max_symlen`` is at
    most 64, the symbols a 64-bit word can hold.
    """
    if not 0 <= max_symlen <= 64:
        raise ValueError(f"max_symlen must be in [0, 64], got {max_symlen}")
    kw = dict(l_max=l_max, max_symlen=max_symlen)
    if ops.is_cuda(words):
        return symlen_tile_cuda(words, tables, **kw)
    return huffman_decode_tile_plain(words, tables, **kw)


def huffman_decode_padded(words, tables: DeviceTables, *, l_max: int,
                          max_symlen: int) -> torch.Tensor:
    """Word-major view of :func:`huffman_decode_tile`: [W, max_symlen]."""
    return huffman_decode_tile(words, tables, l_max=l_max,
                               max_symlen=max_symlen).T


# ---------------------------------------------------------------------------
# The decode table of K1 and K6.
# ---------------------------------------------------------------------------
def decode_lut_plain(tables: DeviceTables, *, l_max: int) -> torch.Tensor:
    """The plain version of the kernels' decode table (runs on any device):
    int16[2**l_max], entry ``p`` the symbol (bits 0-7) and codeword length
    (bits 8-15) of prefix ``p``."""
    return _decode_lut(tables.dec_limit, tables.dec_first, tables.dec_rank,
                       tables.dec_syms, l_max=l_max)


def symlen_lut_cuda(tables: DeviceTables, *, l_max: int) -> torch.Tensor:
    """Build the decode table on the card by K1's first kernel, the code
    that builds it for every decode: int16[2**l_max]."""
    dev = tables.dec_syms.device
    _check_tables("symlen_lut", tables, l_max, dev)
    out = torch.empty(1 << l_max, dtype=torch.int16, device=dev)
    ops.launch("symlen_lut", "fptc_symlen_lut", dev, *_table_ptrs(tables),
               l_max, out.data_ptr())
    return out


def decode_lut(tables: DeviceTables, *, l_max: int) -> torch.Tensor:
    """The decode table for ``tables``' device: built on the card by the
    kernels' own code for CUDA tables, the plain version on the CPU."""
    if ops.is_cuda(tables.dec_syms):
        return symlen_lut_cuda(tables, l_max=l_max)
    return decode_lut_plain(tables, l_max=l_max)
