"""internvl2-26b [vlm] — InternViT (STUB) + InternLM2-20B backbone
(arXiv:2404.16821; hf).  input_specs() provides precomputed patch
embeddings; only the LM backbone is built/lowered."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    vision_prefix=64,
    rope_theta=1000000.0,
)

SMOKE = ARCH.replace(
    name="internvl2-26b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, vision_prefix=4,
)
