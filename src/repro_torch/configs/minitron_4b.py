"""minitron-4b [dense] — pruned nemotron (arXiv:2407.14679; hf)."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    rope_theta=10000.0,
)

SMOKE = ARCH.replace(
    name="minitron-4b-smoke", num_layers=2, d_model=48, num_heads=3,
    num_kv_heads=1, d_ff=96, vocab_size=512, head_dim=16,
)
