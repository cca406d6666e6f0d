"""granite-moe-3b-a800m — fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L, d_model=1536, 24H (GQA kv=8, head_dim=64), MoE 40 experts top-8,
expert d_ff=512, vocab=49155, tied embeddings.
(The assignment line says 40e; the bracketed model-card note says 32 —
we follow the structured spec: 40 experts.)
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    act="silu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
