"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
(arXiv:2412.19437; hf).

MTP (multi-token prediction) head is not modeled — it is a training
objective add-on orthogonal to the FPTC integration.
The dense d_ff (first 3 layers) is 18432 per the HF config; the assigned
"d_ff=2048" is the routed-expert width (moe_d_ff).
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    mla=True,
    mla_q_lora_rank=1536,
    mla_kv_lora_rank=512,
    mla_qk_nope_dim=128,
    mla_qk_rope_dim=64,
    mla_v_dim=128,
    moe_num_experts=256,
    moe_top_k=8,
    moe_num_shared=1,
    moe_d_ff=2048,
    moe_first_dense=3,
    rope_theta=10000.0,
)

SMOKE = ARCH.replace(
    name="deepseek-v3-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=192, vocab_size=512, head_dim=16,
    mla_q_lora_rank=32, mla_kv_lora_rank=16, mla_qk_nope_dim=16,
    mla_qk_rope_dim=8, mla_v_dim=16,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=64, moe_first_dense=1,
)
