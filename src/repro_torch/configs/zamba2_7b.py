"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 Mamba2 layers, d_model=3584, ssm_state=64; a SHARED full
attention+MLP block (32H, d_ff=14336) applied every 6th layer (its
weights reused at each application, per-application KV cache).
Simplification noted in DESIGN.md: Zamba2's LoRA-specialized shared-block
projections and dual alternating blocks are collapsed into one shared
block.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_variant="mamba2",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    attn_every=6,
    act="silu",
    source="arXiv:2411.15242",
)
