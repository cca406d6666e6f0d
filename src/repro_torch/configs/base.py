"""Model configuration: the port's copy of ``repro/configs/base.py``'s
frozen :class:`ModelConfig` dataclass, with its derived properties,
``reduced()`` (the CPU-scale variant) and the analytic ``param_count``.
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

    # ------------------------------------------------------------- derived
    @property
    def attn_dims(self) -> tuple[int, int, int]:
        hd = self.head_dim or (self.d_model // max(self.num_heads, 1))
        return self.num_heads, (self.num_kv_heads or self.num_heads), hd

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def reduced(self, *, max_layers: int = 2, max_d_model: int = 256,
                max_experts: int = 4, max_vocab: int = 512) -> "ModelConfig":
        """CPU-smoke-test variant of the same family (<= 2 layers,
        d_model <= 512, <= 4 experts, f32), field for field as the
        reference's."""
        shrink = max(1, self.d_model // max_d_model)
        d_model = max(self.d_model // shrink, 64)
        heads = max(min(self.num_heads, 4), 1) if self.num_heads else 0
        kv = max(min(self.num_kv_heads, heads), 1) if self.num_kv_heads \
            else heads
        if heads and kv and heads % kv:
            kv = 1
        hd = d_model // heads if heads else 0
        changes = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, max_layers),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d_model) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, max_vocab),
            dtype="float32",
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
        )
        if self.num_experts:
            changes.update(
                num_experts=min(self.num_experts, max_experts),
                experts_per_token=min(self.experts_per_token,
                                      min(self.num_experts, max_experts)),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=min(self.moe_d_ff, 2 * d_model))
        if self.use_mla:
            changes.update(kv_lora_rank=min(self.kv_lora_rank, 64),
                           q_lora_rank=0,
                           qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
                           head_dim=0)
        if self.ssm_variant:
            changes.update(ssm_state=min(self.ssm_state, 16),
                           ssm_head_dim=min(self.ssm_head_dim, 32))
        if self.encoder_layers:
            changes.update(encoder_layers=min(self.encoder_layers,
                                              max_layers),
                           encoder_seq=min(self.encoder_seq, 64))
        if self.num_image_tokens:
            changes.update(num_image_tokens=min(self.num_image_tokens, 16))
        if self.attn_every:
            changes.update(attn_every=min(self.attn_every, 2))
        return dataclasses.replace(self, **changes)


def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts, analytic."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, Hkv, hd = cfg.attn_dims

    def attn_params() -> int:
        if cfg.use_mla:
            q_dim = H * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            p = d * q_dim if not cfg.q_lora_rank else (
                d * cfg.q_lora_rank + cfg.q_lora_rank * q_dim)
            p += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)     # down + k_rope
            p += cfg.kv_lora_rank * H * (cfg.qk_nope_dim + cfg.v_head_dim)
            p += H * cfg.v_head_dim * d                        # out proj
            return p
        p = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if cfg.qkv_bias:
            p += (H + 2 * Hkv) * hd
        return p

    def mlp_params(ff: int) -> int:
        gated = cfg.act in ("silu", "swiglu", "geglu")
        return d * ff * (3 if gated else 2)

    def ssm_params() -> int:
        din = cfg.ssm_d_inner
        N = cfg.ssm_state
        if cfg.ssm_variant == "mamba1":
            return (d * 2 * din + cfg.ssm_conv * din
                    + din * (cfg.dt_rank + 2 * N) + cfg.dt_rank * din
                    + din * N + din + din * d)
        heads = din // cfg.ssm_head_dim
        dxbc = din + 2 * cfg.ssm_groups * N
        return (d * (2 * din + 2 * cfg.ssm_groups * N + heads)
                + cfg.ssm_conv * dxbc + heads + heads + din * d)

    embed = V * d * (1 if cfg.tie_embeddings else 2)
    total = active = embed
    if cfg.family in ("dense", "vlm"):
        per = attn_params() + mlp_params(cfg.d_ff)
        total += L * per
        active += L * per
    elif cfg.family == "moe":
        attn = attn_params()
        expert = mlp_params(cfg.moe_d_ff)
        shared = cfg.num_shared_experts * expert
        router = d * cfg.num_experts
        total += L * (attn + router + shared + cfg.num_experts * expert)
        active += L * (attn + router + shared + cfg.experts_per_token * expert)
    elif cfg.family == "ssm":
        total += L * ssm_params()
        active += L * ssm_params()
    elif cfg.family == "hybrid":
        shared_attn = attn_params() + mlp_params(cfg.d_ff)
        total += L * ssm_params() + shared_attn
        active += L * ssm_params() + shared_attn
    elif cfg.family == "encdec":
        enc = cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        dec = L * (2 * attn_params() + mlp_params(cfg.d_ff))
        total += enc + dec
        active += enc + dec
    return total, active
