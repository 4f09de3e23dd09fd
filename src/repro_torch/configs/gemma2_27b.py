"""gemma2-27b [dense] — local+global alternating attention, logit softcap
(arXiv:2408.00118; hf)."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    window=4096,
    local_global_pattern=("local", "global"),
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norms=True,
    ffn_activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)

SMOKE = ARCH.replace(
    name="gemma2-27b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, window=32,
)
