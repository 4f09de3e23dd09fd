"""qwen1.5-4b [dense] — QKV bias (hf:Qwen/Qwen1.5 family)."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = ARCH.replace(
    name="qwen1.5-4b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512, head_dim=16,
)
