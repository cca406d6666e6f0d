"""paligemma-3b — VLM: SigLIP vision encoder (STUB) + Gemma decoder
[arXiv:2407.07726].

Language backbone: 18L, d_model=2048, 8H (MQA kv=1, head_dim=256),
d_ff=16384, vocab=257216, gated-GELU, tied embeddings. The vision tower +
projector are stubbed: the batch supplies 256 patch embeddings
(B, 256, 2048) as a bidirectional prefix (prefix-LM mask).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    num_image_tokens=256,
    act="geglu",
    tie_embeddings=True,
    source="arXiv:2407.07726",
)
