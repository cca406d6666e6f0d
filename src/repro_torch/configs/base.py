"""Model configuration: the port's copy of ``repro/configs/base.py``'s
frozen :class:`ModelConfig` dataclass (fields only; the derived
properties, ``reduced()`` and ``param_count`` come with the LM family).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | cnn
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0

    # --- attention flavor ---
    qkv_bias: bool = False
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 1

    # --- MLA ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM ---
    ssm_variant: str = ""
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_dt_rank: int = 0

    # --- hybrid / enc-dec / VLM ---
    attn_every: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_image_tokens: int = 0

    # --- misc ---
    attn_q_chunk: int = 0
    flash_vjp: bool = False
    loss_chunk: int = 0
    serve_pure_tp: bool = False
    act: str = "silu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    remat_block: int = 0
    scan_layers: bool = True
    source: str = ""               # citation
