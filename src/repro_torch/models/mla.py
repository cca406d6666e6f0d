"""MLA — Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434):
port of ``repro/models/mla.py``.

The KV state is compressed to a rank-``kv_lora_rank`` latent c_kv plus
one shared RoPE key per token, so the decode cache holds
``kv_lora_rank + qk_rope_dim`` values a token and layer (576 for
deepseek-v2-236b) instead of the expanded K and V of every head.

Training and prefill (:func:`mla_block`) use the expanded form: the
per-head keys and values are taken up from the latent and attention
runs through :func:`repro_torch.models.attention.attention_core` at
D = nope + rope and Dv = v_head_dim. Decode (:func:`mla_decode`) uses
the absorbed form: W_uk is folded into the query, the scores are taken
against the latent and rope caches, and W_uv is applied after the
probability-weighted sum of latents; as in the reference, every product
there is in f32. The reference computes that decode in jnp, not Pallas,
so it launches no kernel here either.

Leaf names and layouts are the reference's: ``q_down``, ``q_norm``,
``q_up`` (or ``wq`` when ``q_lora_rank`` is 0), ``kv_down``,
``kv_norm``, ``k_up``, ``v_up``, ``wo``, dense weights ``(in, out)``
and f32 norm scales. The cache rows are written in place
(:func:`repro_torch.models.attention._insert_at`). The reference's
chunked-prefill ``mla_chunk`` waits for chunked prefill, its only
caller.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import _insert_at, attention_core

NEG_INF = -1.0e30


def init_mla(gen: torch.Generator, cfg, d: int, dtype: torch.dtype,
             device) -> dict:
    """The reference's leaves at its distributions, drawn from ``gen``
    in a fixed order."""
    H = cfg.num_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    vd, r = cfg.v_head_dim, cfg.kv_lora_rank
    q_dim = H * (nope + rope)
    p = {}
    if cfg.q_lora_rank:
        p["q_down"] = L.dense_init(gen, d, cfg.q_lora_rank, dtype, device)
        p["q_norm"] = torch.ones(cfg.q_lora_rank, device=device)
        p["q_up"] = L.dense_init(gen, cfg.q_lora_rank, q_dim, dtype, device)
    else:
        p["wq"] = L.dense_init(gen, d, q_dim, dtype, device)
    p["kv_down"] = L.dense_init(gen, d, r + rope, dtype, device)
    p["kv_norm"] = torch.ones(r, device=device)
    p["k_up"] = L.dense_init(gen, r, H * nope, dtype, device)
    p["v_up"] = L.dense_init(gen, r, H * vd, dtype, device)
    p["wo"] = L.dense_init(gen, H * vd, d, dtype, device)
    return p


def _queries(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope), roped."""
    B, S, _ = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = L.rmsnorm(x @ p["q_down"], p["q_norm"], cfg.norm_eps)
        q = cq @ p["q_up"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, cfg.num_heads, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """c_kv (B,S,r), normed; k_rope (B,S,1,rope), the roped shared key."""
    r = cfg.kv_lora_rank
    kv = x @ p["kv_down"]
    c_kv = L.rmsnorm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., r:][:, :, None, :], positions,
                          cfg.rope_theta)
    return c_kv, k_rope


def mla_block(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor
              ) -> torch.Tensor:
    """Training and prefill, the expanded form: x (B,S,d) -> (B,S,d).
    k_nope and v come up from the latent, the shared rope key goes to
    every head, and the attention scales by (nope + rope) ** -0.5, as the
    reference.

    The reference's block passes neither the window nor the softcap to
    its attention, so it trains an MLA config that sets one as if it did
    not; the port refuses such a config rather than silently ignore a
    field of it."""
    if cfg.sliding_window or cfg.attn_logit_softcap:
        raise NotImplementedError(
            f"MLA with sliding_window={cfg.sliding_window} or "
            f"attn_logit_softcap={cfg.attn_logit_softcap}: the reference's "
            "mla_block ignores both, so the port refuses them rather than "
            "train without them")
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_rope = _latents(cfg, p, x, positions)
    k_nope = (c_kv @ p["k_up"]).reshape(B, S, H, nope)
    v = (c_kv @ p["v_up"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
    out = attention_core(q, k, v, q_positions=positions,
                         scale=(nope + rope) ** -0.5,
                         q_chunk=cfg.attn_q_chunk, flash_vjp=cfg.flash_vjp)
    return out.reshape(B, S, H * vd) @ p["wo"]


def mla_decode(cfg, p: dict, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, pos: torch.Tensor):
    """One-token absorbed decode: x (B,1,d); a layer's caches, cache_ckv
    (B,S,r) and cache_krope (B,S,rope); pos (B,) int32. Writes the new
    latent and rope key at row min(pos, S-1) in place and returns
    (out (B,1,d), cache_ckv, cache_krope).

    The reference clamps a write past capacity to row S-1 and attends
    the rows j < pos + 1: every row once pos reaches S-1; so does this.
    """
    B = x.shape[0]
    H = cfg.num_heads
    nope, rope, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    S = cache_ckv.shape[1]
    q_nope, q_rope = _queries(cfg, p, x, pos[:, None])      # (B,1,H,*)
    c_kv, k_rope = _latents(cfg, p, x, pos[:, None])        # (B,1,r), ...
    _insert_at(cache_ckv, c_kv, pos)
    _insert_at(cache_krope, k_rope[:, :, 0], pos)
    ckv = cache_ckv.float()
    # absorb W_uk into q: (B,1,H,nope) . (r,H,nope) -> (B,H,r)
    q_lat = torch.einsum("bohn,rhn->bhr", q_nope.float(),
                         p["k_up"].reshape(r, H, nope).float())
    scores = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    scores = scores + torch.einsum("bohe,bse->bhs", q_rope.float(),
                                   cache_krope.float())
    scores = scores * (nope + rope) ** -0.5
    valid = torch.arange(S, device=x.device) < (pos + 1)[:, None, None]
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    out_lat = torch.einsum("bhs,bsr->bhr", probs, ckv)       # (B,H,r)
    out = torch.einsum("bhr,rhv->bhv", out_lat,
                       p["v_up"].reshape(r, H, vd).float())
    out = out.reshape(B, 1, H * vd).to(x.dtype) @ p["wo"]
    return out, cache_ckv, cache_krope
