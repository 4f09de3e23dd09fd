"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay
(arXiv:2404.05892; hf)."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # d_model / rwkv_head_size
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
)

SMOKE = ARCH.replace(
    name="rwkv6-3b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512, rwkv_head_size=16,
)
