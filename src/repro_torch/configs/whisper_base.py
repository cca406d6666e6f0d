"""whisper-base — enc-dec audio backbone [arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
Conv/mel frontend is a stub: the batch supplies (B, 1500, 512) frame
embeddings (30 s of audio after the 2x conv downsampling).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    use_rope=False,          # sinusoidal positions (DESIGN.md deviation note)
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
