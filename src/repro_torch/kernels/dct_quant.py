"""K5: fused forward DCT + 3-zone quantize — the fixed-rate (entropy-off)
encode of the KV cache.

CUDA kernel: ``csrc/dct_quant.cu`` (``fptc_dct_quant``, on the DCT +
quantize template ``csrc/dct_quant.cuh`` that K4 shares), which replaces
``repro/kernels/dct_quant.py::dct_quant``: ``windows @ dct_basis`` then the
3-zone quantizer, as u8 levels.  The TPU kernel's fast arm exists only for
the TPU's vector unit; on Hopper the exact quantizer costs the same, so
``exact=`` selects the one kernel either way.  The source's header says
what bounds it on the H100 and what its design does about it.

Plain version: :func:`dct_quant_plain`, ``quantize(windows @ basis)`` — the
math of the reference's XLA arm (``serving/batch_encode.py::
_encode_fixed_math``).  :func:`dct_quant` takes it for CPU tensors and
launches the kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dct
from repro_torch.core.quantize import QuantTable, quantize
from repro_torch.kernels import ops

__all__ = ["dct_quant", "dct_quant_plain", "check_quant_args"]


def dct_quant_plain(windows, quant: QuantTable, basis) -> torch.Tensor:
    """[W, N] windows -> @ basis -> quantize -> uint8 [W, E] (any device)."""
    return quantize(windows @ basis, quant)


def check_quant_args(dev: torch.device, quant: QuantTable, basis, n: int,
                     e: int, name: str) -> None:
    """The shared checks of the DCT + quantize kernels' table operands."""
    if quant.num_coeffs != e or basis.shape != (n, e) or not 1 <= e <= n <= 128:
        raise ValueError(
            f"{name}: quant table ({quant.num_coeffs} bins) / basis "
            f"{tuple(basis.shape)} do not match N={n}, E={e} (need "
            "E <= N <= 128)"
        )
    parts = (quant.zone, quant.scale, quant.mu, quant.alpha1, basis)
    if any(t.device != dev for t in parts):
        raise ValueError(f"{name} inputs must share one CUDA device")
    if quant.zone.dtype != torch.int32 or any(
        t.dtype != torch.float32 for t in parts[1:]
    ):
        raise TypeError(f"{name} takes an int32 zone and f32 tables")


def dct_quant(windows, quant: QuantTable, *, e: int,
              basis: Optional[torch.Tensor] = None,
              exact: bool = False) -> torch.Tensor:
    """Fused forward DCT + quantize: f32 [W, N] samples -> uint8 [W, E].

    ``basis`` (f32 [N, E]) lets a caller with a persistent encode plan pass
    its resident DCT basis.  ``exact`` is kept for the reference's
    signature; both values run the exact quantizer (see the module note).
    """
    del exact
    n = windows.shape[-1]
    if basis is None:
        basis = dct.dct_basis(n, e, device=windows.device)
    if not ops.is_cuda(windows):
        return dct_quant_plain(windows, quant, basis)
    dev = windows.device
    if windows.dtype != torch.float32 or windows.dim() != 2:
        raise TypeError(
            f"dct_quant takes f32 windows [W, N], got {windows.dtype} "
            f"{tuple(windows.shape)}"
        )
    check_quant_args(dev, quant, basis, n, e, "dct_quant")
    w = windows.shape[0]
    windows = windows.contiguous()
    basis = basis.contiguous()
    out = torch.empty(w, e, dtype=torch.uint8, device=dev)
    if w == 0:
        return out  # nothing to launch
    ops.launch(
        "dct_quant", "fptc_dct_quant", dev,
        windows.data_ptr(), w, n, e, basis.data_ptr(),
        quant.zone.contiguous().data_ptr(),
        quant.scale.contiguous().data_ptr(), quant.mu.data_ptr(),
        quant.alpha1.data_ptr(), out.data_ptr(),
    )
    return out
