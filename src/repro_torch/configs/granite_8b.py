"""granite-8b [dense] — llama-arch code model (arXiv:2405.04324; hf)."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10000.0,
)

SMOKE = ARCH.replace(
    name="granite-8b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
)
