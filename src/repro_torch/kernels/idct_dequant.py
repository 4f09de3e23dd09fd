"""K3: fused 3-zone dequant + inverse DCT for fixed-rate (entropy-off)
blocks — the KV-cache decode.

CUDA kernel: ``csrc/idct_dequant.cu`` (``fptc_idct_dequant``, on the
template of ``csrc/dequant_idct.cuh``), which replaces
``repro/kernels/idct_dequant.py::idct_dequant``: it dequantizes by that
kernel's 3-zone formulas (mu-law ``expm1``/``log1p`` in zone 0, linear
deadzone in zone 1, zero in zone 2), tabulated once a CTA on the device
for every (band, level), then multiplies by the iDCT basis.  The sources'
headers say what bounds it on the H100 and what its design does about it.

Plain version: :func:`idct_dequant_plain`, the math of the reference's
``kernels/ref.py::idct_dequant_ref``.  :func:`idct_dequant` takes it for
CPU tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import QuantTable, dequantize
from repro_torch.kernels import ops

__all__ = ["idct_dequant", "idct_dequant_plain"]


def idct_dequant_plain(levels, quant: QuantTable, basis) -> torch.Tensor:
    """[W, E] levels -> dequantize -> @ basis -> [W, N] (any device)."""
    return dequantize(levels.to(torch.uint8), quant) @ basis


def idct_dequant(levels, quant: QuantTable, basis) -> torch.Tensor:
    """levels uint8[W, E] (or an integer type holding 0..255), the quant
    table and basis f32[E, N] -> f32[W, N]."""
    if not ops.is_cuda(levels):
        return idct_dequant_plain(levels, quant, basis)
    dev = levels.device
    if levels.dtype.is_floating_point or levels.dtype == torch.bool:
        raise TypeError(f"idct_dequant takes integer levels, got {levels.dtype}")
    w, e = levels.shape
    n = basis.shape[1]
    if quant.num_coeffs != e or basis.shape[0] != e or not 1 <= e <= n <= 128:
        raise ValueError(
            f"quant table ({quant.num_coeffs} bins) / basis "
            f"{tuple(basis.shape)} do not match levels [{w}, {e}]"
        )
    parts = (quant.zone, quant.scale, quant.mu, quant.alpha1, basis)
    if any(t.device != dev for t in parts):
        raise ValueError("idct_dequant inputs must share one CUDA device")
    if quant.zone.dtype != torch.int32 or any(
        t.dtype != torch.float32 for t in parts[1:]
    ):
        raise TypeError("idct_dequant takes an int32 zone and f32 tables")
    levels = levels.to(torch.uint8).contiguous()
    basis = basis.contiguous()
    out = torch.empty(w, n, dtype=torch.float32, device=dev)
    ops.launch(
        "idct_dequant", "fptc_idct_dequant", dev,
        levels.data_ptr(), w, e, n, quant.zone.contiguous().data_ptr(),
        quant.scale.contiguous().data_ptr(), quant.mu.data_ptr(),
        quant.alpha1.data_ptr(), basis.data_ptr(), out.data_ptr(),
    )
    return out
