"""whisper-tiny [audio] — enc-dec backbone; conv/mel frontend is a STUB
(arXiv:2212.04356; unverified).  input_specs() provides precomputed frame
embeddings [B, 1500, 384]."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=4,
    encoder_seq=1500,
    cross_attention=True,
    ffn_activation="gelu",
    gated_ffn=False,
    qkv_bias=True,
)

SMOKE = ARCH.replace(
    name="whisper-tiny-smoke", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=512, head_dim=16,
    encoder_layers=2, encoder_seq=64,
)
