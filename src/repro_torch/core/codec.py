"""End-to-end FPTC codec (paper Fig. 3): transform → quantize → entropy code.
Port of ``repro/core/codec.py``.

  * **Host path** (`encode` / `decode`) — the paper's embedded sequential
    encoder and the reference decode: numpy bit packing (Algorithm 1) and a
    serial LUT decode, with the transform and quantizer as CPU tensors.
    Host functions stay on the host.
  * **Device path** (`encode_device` / `decode_device`) — a batch of one
    over :class:`repro_torch.serving.batch_encode.BatchEncoder` (exact
    mode, byte-identical to `encode`) / :class:`repro_torch.serving.
    batch_decode.BatchDecoder`: on the card unless the caller asks for the
    CPU.
  * **Transcode** (`transcode`) — a container of one through
    :class:`repro_torch.serving.transcode.Transcoder` in exact mode.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import dct, symlen
from repro_torch.core.calibration import DomainTables
from repro_torch.core.container import Container
from repro_torch.core.quantize import (
    dequantize,
    expand_coded_stream,
    predict_levels,
    quantize,
    unpredict_levels,
)

__all__ = [
    "encode",
    "decode",
    "encode_device",
    "decode_device",
    "transcode",
    "roundtrip_metrics",
    "validate_container_tables",
]


def validate_container_tables(plan_key, tables: DomainTables) -> None:
    """Reject a container/tables pairing whose configs disagree.

    A container carries its encode-time (domain_id, n, e, l_max, coding) in
    the header; decoding it with tables built for a different config either
    dies in a shape error or decodes silently to garbage, so every decode
    path calls this before touching the stream.
    """
    cfg = tables.config
    want = (tables.domain_id, cfg.n, cfg.e, cfg.l_max, cfg.coding)
    if tuple(plan_key) != want:
        raise ValueError(
            f"container plan_key (domain_id, n, e, l_max, coding)="
            f"{tuple(plan_key)} does not match the supplied DomainTables "
            f"{want} — decoding with mismatched tables would produce garbage"
        )


def encode(signal: np.ndarray, tables: DomainTables) -> Container:
    """Single-pass table-driven encode (paper §4.1, Fig. 5), on the host.

    With a v3 coding in the config, the quantized level grid is re-coded
    losslessly before entropy coding: prediction residuals on the low bands
    and zero-plane suppression; the container records both in its header.
    """
    cfg = tables.config
    pred_id, bands, zplanes = cfg.coding
    signal = np.asarray(signal, dtype=np.float32).ravel()
    length = signal.shape[0]
    windows = dct.window_signal(torch.from_numpy(signal.copy()), cfg.n)
    coeffs = dct.forward_dct(windows, cfg.e)
    levels = quantize(coeffs, tables.quant)
    grid = predict_levels(levels, pred_id, bands).numpy()
    zrow = zcol = None
    if zplanes:
        zrow, zcol = symlen.zero_plane_masks(grid)
        coded = grid[~zrow, :][:, ~zcol].ravel()
    else:
        coded = grid.ravel()
    stream = symlen.pack_symlen_np(coded, tables.book)
    return Container(
        words=stream.words,
        symlen=stream.symlen.astype(np.uint8),
        num_symbols=stream.num_symbols,
        num_windows=int(windows.shape[0]),
        signal_length=length,
        n=cfg.n,
        e=cfg.e,
        l_max=cfg.l_max,
        domain_id=tables.domain_id,
        predictor=pred_id,
        predict_bands=bands,
        zero_planes=zplanes,
        zrow=zrow,
        zcol=zcol,
    )


def encode_device(
    signal: np.ndarray, tables: DomainTables, *, device=None
) -> Container:
    """Encode one signal on the device, byte-identical to :func:`encode`:
    a batch of one over the batched encode engine in exact mode (one
    packing chunk per signal).  Runs on the card unless ``device="cpu"``;
    with no card and no device given it raises.  Encode many signals at
    once — and get chunk-parallel packing — with
    :class:`repro_torch.serving.batch_encode.BatchEncoder` directly."""
    from repro_torch.serving.batch_encode import default_encoder

    enc = default_encoder(None, device)
    return enc.encode([signal], tables).to_host()[0]


def decode(container: Container, tables: DomainTables) -> np.ndarray:
    """Reference decode on the host: serial Huffman LUT + (v3) expansion and
    un-prediction + dequant + inverse DCT."""
    validate_container_tables(container.plan_key, tables)
    stream = symlen.PackedStream(
        words=container.words,
        symlen=container.symlen.astype(np.int32),
        num_symbols=container.num_symbols,
    )
    syms = symlen.unpack_symlen_np(stream, tables.book)
    pred_id, bands, _ = container.coding
    nw, e = container.num_windows, container.e
    if container.coding == (0, 0, False):
        levels = torch.from_numpy(syms.reshape(nw, e))
    else:
        idx, seg = symlen.v3_expand_index(
            [(nw, container.zrow, container.zcol)], e
        )
        if syms.size == 0:  # everything suppressed: the grid is all 128
            grid = torch.full((nw, e), 128, dtype=torch.uint8)
        else:
            grid = expand_coded_stream(
                torch.from_numpy(syms), torch.from_numpy(idx)
            ).reshape(nw, e)
        levels = unpredict_levels(grid, torch.from_numpy(seg), pred_id, bands)
    coeffs = dequantize(levels, tables.quant)
    windows = dct.inverse_dct(coeffs, container.n)
    return dct.unwindow_signal(windows, container.signal_length).numpy()


def decode_device(
    container: Container, tables: DomainTables, *, device=None
) -> np.ndarray:
    """Word-parallel decode of one container: a batch of one over the
    batched decode engine.  Runs on the card unless ``device="cpu"``; with
    no card and no device given it raises."""
    from repro_torch.serving.batch_decode import default_decoder

    dec = default_decoder(device)
    return dec.decode([container], tables).to_host()[0]


def transcode(
    container: Container,
    src_tables: DomainTables,
    dst_tables: DomainTables,
    *,
    device=None,
) -> Container:
    """Re-encode one container under a new (domain, config) on the device.

    Container-of-one wrapper over the transcode pipeline
    (:mod:`repro_torch.serving.transcode`) in exact packing mode: decode
    and re-encode compose on the device with no host round trip between
    them, and the output equals ``decode_device`` to the host followed by
    ``encode_device`` under ``dst_tables``.  Runs on the card unless
    ``device="cpu"``; with no card and no device given it raises.
    Transcode many containers at once — and get chunk-parallel packing —
    with :class:`repro_torch.serving.transcode.Transcoder` directly.
    """
    from repro_torch.serving.transcode import default_transcoder

    return default_transcoder(None, device).transcode_to_host(
        [container], src_tables, dst_tables
    )[0]


def roundtrip_metrics(
    signal: np.ndarray, tables: DomainTables
) -> Tuple[float, float]:
    """(CR, PRD) of a host-path round trip — used by RD benchmarks."""
    from repro_torch.core.metrics import prd

    c = encode(signal, tables)
    rec = decode(c, tables)
    return c.compression_ratio, prd(signal, rec)
