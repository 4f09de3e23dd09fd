"""llama4-scout-17b-16e [moe] — 16 experts top-1 + shared expert
(hf:meta-llama/Llama-4-Scout-17B-16E; unverified)."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    moe_num_experts=16,
    moe_top_k=1,
    moe_num_shared=1,
    moe_d_ff=8192,
    rope_theta=500000.0,
)

SMOKE = ARCH.replace(
    name="llama4-scout-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    moe_num_experts=4, moe_d_ff=128,
)
