"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).
Port of ``repro/models/encdec.py``.

The conv/mel frontend is stubbed as in the reference: the batch carries
precomputed frame embeddings ``frames`` [B, encoder_seq, d].  The encoder
is a bidirectional transformer; the decoder adds causal self-attention
(rope on its q and k, a KV cache for serving) and cross-attention over the
encoder's output, whose k and v the decode cache keeps (``ck``/``cv``).
Projections carry the configuration's biases; the FFN is the reference's
(whisper: GELU, ungated).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import (
    ParamSpec,
    Params,
    apply_rope,
    attention,
    decode_attention,
    rms_norm,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (
    _heads,
    _merge_heads,
    ffn_apply,
    ffn_specs,
    gqa_specs,
)

__all__ = ["cross_attn_specs", "encoder_layer_specs", "decoder_layer_specs",
           "encoder_layer_apply", "decoder_layer_train",
           "decoder_layer_decode", "EncoderLayer", "CrossDecoderLayer"]


def cross_attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    return gqa_specs(cfg)


def _norm(cfg: ArchConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), (None,), dtype=torch.bfloat16,
                     init="ones")


def encoder_layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {"ln1": _norm(cfg), "ln2": _norm(cfg), "attn": gqa_specs(cfg),
            "ffn": ffn_specs(cfg)}


def decoder_layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {"ln1": _norm(cfg), "ln_cross": _norm(cfg), "ln2": _norm(cfg),
            "attn": gqa_specs(cfg), "cross": cross_attn_specs(cfg),
            "ffn": ffn_specs(cfg)}


def _proj_q(cfg: ArchConfig, p, x):
    q = _heads(x, p["wq"])
    return q + p["bq"] if cfg.qkv_bias else q


def _proj_qkv(cfg: ArchConfig, p, xq, xkv, sin=None, cos=None):
    q = _proj_q(cfg, p, xq)
    k, v = _heads(xkv, p["wk"]), _heads(xkv, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if sin is not None:
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    return q, k, v


def _add_norm(x, y, weight):
    """``(x + y, rms_norm(x + y, weight))`` as the reference's compiled
    layer rounds them: XLA fuses the residual add into the norm's
    statistics and keeps the sum in fp32 there (the bf16 round trip
    between them is dropped), while the normalize multiplies read the sum
    rounded to bf16.  Written out, the norm of the rounded sum moves a
    smoke model's logits by about 1.5e-2 relative."""
    s = x + y
    sf = x.float() + y.float()
    inv = torch.rsqrt((sf * sf).mean(-1, keepdim=True) + 1e-6).to(s.dtype)
    return s, s * inv * weight


def encoder_layer_apply(cfg: ArchConfig, p, x):
    """Bidirectional self-attention encoder layer."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p["attn"], h, h)
    out = attention(q, k, v, causal=False, q_chunk=1024)
    x, h = _add_norm(x, _merge_heads(out, p["attn"]["wo"]), p["ln2"])
    return x + ffn_apply(cfg, p["ffn"], h)


def decoder_layer_train(cfg: ArchConfig, p, x, enc_out, sin, cos):
    """Causal self-attn + cross-attn + FFN (training / prefill).  Returns
    (x, (k, v) of the self-attention, (ck, cv) of the cross-attention)."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p["attn"], h, h, sin, cos)
    out = attention(q, k, v, causal=True, q_chunk=1024)
    x, h = _add_norm(x, _merge_heads(out, p["attn"]["wo"]), p["ln_cross"])

    qc, kc, vc = _proj_qkv(cfg, p["cross"], h, enc_out)
    out = attention(qc, kc, vc, causal=False, q_chunk=1024)
    x, h = _add_norm(x, _merge_heads(out, p["cross"]["wo"]), p["ln2"])
    return x + ffn_apply(cfg, p["ffn"], h), (k, v), (kc, vc)


def decoder_layer_decode(cfg: ArchConfig, p, x, cache: Dict[str, Any], sin,
                         cos, pos: torch.Tensor):
    """Single-token decode: self-attn against this layer's ``k``/``v``
    cache ``[B, T, KV, hd]`` (written at slot ``pos`` in place; ``pos`` a
    0-d device tensor) and cross-attn against its precomputed ``ck``/
    ``cv``.  Returns (x, cache)."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p["attn"], h, h, sin, cos)
    kc, vc = cache["k"], cache["v"]
    slot = pos.reshape(1)
    kc.index_copy_(1, slot, k)
    vc.index_copy_(1, slot, v)
    out = decode_attention(q, kc, vc, pos + 1)
    x, h = _add_norm(x, _merge_heads(out, p["attn"]["wo"]), p["ln_cross"])

    qc = _proj_q(cfg, p["cross"], h)
    ck, cv = cache["ck"], cache["cv"]
    out = decode_attention(qc, ck, cv, ck.shape[1])
    x, h = _add_norm(x, _merge_heads(out, p["cross"]["wo"]), p["ln2"])
    return x + ffn_apply(cfg, p["ffn"], h), cache


class EncoderLayer(Params):
    """One encoder layer's weights (``encoder_layer_specs``)."""

    kind = "encoder"

    def __init__(self, cfg: ArchConfig, device):
        super().__init__(encoder_layer_specs(cfg), device)
        self.cfg = cfg

    def forward(self, x):
        return encoder_layer_apply(self.cfg, self, x)


class CrossDecoderLayer(Params):
    """One decoder layer's weights (``decoder_layer_specs``): self- and
    cross-attention, then the FFN."""

    kind = "decoder"

    def __init__(self, cfg: ArchConfig, device):
        super().__init__(decoder_layer_specs(cfg), device)
        self.cfg = cfg

    def forward(self, x, enc_out, sin, cos):
        return decoder_layer_train(self.cfg, self, x, enc_out, sin, cos)

    def decode(self, x, cache, sin, cos, pos):
        return decoder_layer_decode(self.cfg, self, x, cache, sin, cos, pos)
