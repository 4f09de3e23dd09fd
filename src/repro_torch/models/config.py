"""Architecture configuration — drives the composable model library.
Port of ``repro/models/config.py``, field for field; ``param_dtype`` stays
the string ``"bfloat16"``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One LM architecture (assigned-pool entry or reduced smoke config)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention variants
    qkv_bias: bool = False  # qwen1.5
    attn_softcap: Optional[float] = None  # gemma2 (50.0)
    logit_softcap: Optional[float] = None  # gemma2 (30.0)
    window: Optional[int] = None  # sliding-window size for local layers
    local_global_pattern: Optional[Tuple[str, ...]] = None  # e.g. ("local","global")
    rope_theta: float = 10000.0
    post_block_norms: bool = False  # gemma2 post-attn/post-ffn norms
    ffn_activation: str = "silu"  # silu | gelu
    gated_ffn: bool = True  # False: classic 2-matrix MLP (whisper)
    embed_scale: bool = False  # gemma2: embeddings scaled by sqrt(d)

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_num_shared: int = 0
    moe_d_ff: Optional[int] = None  # expert FFN width (deepseek: 2048)
    moe_first_dense: int = 0  # leading dense layers (deepseek: 3)
    moe_every: int = 1  # MoE block every k-th layer

    # MLA (deepseek-v3)
    mla: bool = False
    mla_q_lora_rank: int = 1536
    mla_kv_lora_rank: int = 512
    mla_qk_nope_dim: int = 128
    mla_qk_rope_dim: int = 64
    mla_v_dim: int = 128

    # SSM / RWKV / hybrid
    ssm_state: int = 0  # mamba state size (hymba: 16)
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_size: int = 64
    hybrid_parallel: bool = False  # hymba: parallel attn + ssm heads

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # audio frames after conv stub
    cross_attention: bool = False

    # VLM
    vision_prefix: int = 0  # number of (stubbed) patch embeddings

    # training
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim", self.d_model // self.num_heads
            )
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: H={self.num_heads} not a multiple of "
                f"KV={self.num_kv_heads}"
            )

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """True for sub-quadratic archs (SSM / hybrid w/ sliding window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        n_layers = self.num_layers

        if self.mla:
            qk_dim = self.mla_qk_nope_dim + self.mla_qk_rope_dim
            attn = (
                d * self.mla_q_lora_rank
                + self.mla_q_lora_rank * h * qk_dim
                + d * (self.mla_kv_lora_rank + self.mla_qk_rope_dim)
                + self.mla_kv_lora_rank
                * h
                * (self.mla_qk_nope_dim + self.mla_v_dim)
                + h * self.mla_v_dim * d
            )
        elif self.family == "ssm":  # rwkv6
            # r,k,v,g,w,o projections + channel-mix
            attn = 6 * d * d
        else:
            attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if self.hybrid_parallel:
                d_in = self.ssm_expand * d
                attn += 2 * d * d_in + d_in * d + d_in * (
                    2 * self.ssm_state + 1
                )

        if self.family == "ssm":
            ffn_dense = int(1.5 * 2 * d * ff)  # rwkv channel mix (k,v,r)
        elif self.ffn_activation in ("silu", "gelu"):
            ffn_dense = 3 * d * ff  # gated
        else:
            ffn_dense = 2 * d * ff

        total = 0
        active = 0
        for layer in range(n_layers):
            is_moe = (
                self.moe_num_experts > 0
                and layer >= self.moe_first_dense
                and (layer - self.moe_first_dense) % self.moe_every == 0
            )
            if is_moe:
                eff = self.moe_d_ff or ff
                routed = self.moe_num_experts * 3 * d * eff
                shared = self.moe_num_shared * 3 * d * eff
                router = d * self.moe_num_experts
                total += attn + routed + shared + router
                active += (
                    attn + self.moe_top_k * 3 * d * eff + shared + router
                )
            else:
                total += attn + ffn_dense
                active += attn + ffn_dense
        emb = v * d * (1 if self.tie_embeddings else 2)
        total += emb + d
        active += emb + d
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + ffn_dense)
            total += enc
            active += enc
        if self.cross_attention:
            ca = n_layers * (2 * d * d + 2 * d * (kv * hd))
            total += ca
            active += ca
        return active if active_only else total
