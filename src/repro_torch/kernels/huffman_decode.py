"""K1: word-parallel SymLen Huffman decode + compaction.

CUDA kernel: ``csrc/symlen_decode.cu`` (``fptc_symlen_decode``), which
replaces ``repro/kernels/huffman_decode.py::huffman_decode_dense``.  The
source's header says what bounds it on the H100 and how its design differs
from the TPU kernel: a device-wide exclusive scan of the symlen sidecar in
place of the running base carried across the sequential TPU grid, one
thread per native 64-bit word, and the canonical tables in shared memory.

Plain version: :func:`repro_torch.core.symlen.unpack_symlen`, the math of
the reference's XLA arm.  :func:`huffman_decode_dense` takes it for CPU
tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.calibration import DeviceTables
from repro_torch.core.symlen import unpack_symlen
from repro_torch.kernels import ops

__all__ = ["huffman_decode_dense", "huffman_decode_plain", "symlen_decode_cuda"]

SCAN_BLOCK = 1024  # words per block of the kernel's offset scan


def huffman_decode_plain(words, symlen, tables: DeviceTables, *, l_max: int,
                         max_symlen: int, num_symbols: int) -> torch.Tensor:
    """The plain PyTorch version (runs on any device)."""
    return unpack_symlen(
        words, symlen, tables.dec_limit, tables.dec_first, tables.dec_rank,
        tables.dec_syms,
        l_max=l_max, max_symlen=max_symlen, num_symbols=num_symbols,
    )


def symlen_decode_cuda(words, symlen, tables: DeviceTables, *, l_max: int,
                       max_symlen: int, num_symbols: int) -> torch.Tensor:
    """Launch K1 on CUDA tensors: words int64[W] (uint64 bit patterns),
    symlen uint8[W] -> dense uint8[num_symbols]."""
    dev = words.device
    if words.dtype != torch.int64 or symlen.dtype != torch.uint8:
        raise TypeError(
            f"symlen_decode takes int64 words and uint8 symlen, got "
            f"{words.dtype} and {symlen.dtype}"
        )
    if words.ndim != 1 or symlen.shape != words.shape:
        raise ValueError(
            f"words {tuple(words.shape)} and symlen {tuple(symlen.shape)} "
            "must be matching 1-D arrays"
        )
    if not 1 <= l_max <= 16 or tables.dec_limit.shape[0] != l_max:
        raise ValueError(f"tables do not match l_max={l_max}")
    parts = (symlen, tables.dec_limit, tables.dec_first, tables.dec_rank,
             tables.dec_syms)
    if any(t.device != dev for t in parts):
        raise ValueError("symlen_decode inputs must share one CUDA device")
    if any(t.dtype != torch.int32 for t in parts[1:]):
        raise TypeError("symlen_decode decode tables must be int32")
    words = words.contiguous()
    symlen = symlen.contiguous()
    n = words.shape[0]
    out = torch.zeros(num_symbols, dtype=torch.uint8, device=dev)
    local = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    block = torch.empty(max(-(-n // SCAN_BLOCK), 1), dtype=torch.int32,
                        device=dev)
    ops.launch(
        "symlen_decode", "fptc_symlen_decode", dev,
        words.data_ptr(), symlen.data_ptr(), n, local.data_ptr(),
        block.data_ptr(), tables.dec_limit.contiguous().data_ptr(),
        tables.dec_first.contiguous().data_ptr(),
        tables.dec_rank.contiguous().data_ptr(),
        tables.dec_syms.contiguous().data_ptr(), l_max, max_symlen,
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
