"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer
(arXiv:2411.13676; hf).  Attention uses a sliding window (the few global
layers of the released model are approximated as windowed);
the SSM half is a Mamba-style selective SSM with state 16."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    window=1024,
    hybrid_parallel=True,
    ssm_state=16,
    ssm_expand=2,
    rope_theta=10000.0,
)

SMOKE = ARCH.replace(
    name="hymba-1.5b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, window=32,
    ssm_state=4,
)
