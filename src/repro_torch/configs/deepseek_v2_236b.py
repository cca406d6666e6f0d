"""deepseek-v2-236b — MoE with Multi-head Latent Attention
[arXiv:2405.04434].

60L, d_model=5120, 128H, MLA kv_lora=512 (+64 rope), q_lora=1536,
nope/rope 128/64, v 128; MoE: 2 shared + 160 routed experts, top-6,
expert d_ff=1536, vocab=102400. As in the reference, the real model's
first dense layer is made MoE like the rest (one uniform layer stack).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=0,
    vocab_size=102400,
    # MLA
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    # MoE
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    act="silu",
    source="arXiv:2405.04434",
)
