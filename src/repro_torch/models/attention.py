"""GQA/MHA/MQA attention of the dense and MoE families: projections, the
blockwise online-softmax core for training and prefill, and one-token
decode over a persistent KV cache. Port of ``repro/models/attention.py``.

Layouts as the reference's: q (B, S, H, D), k/v (B, S, Hkv, D), a
layer's decode cache (B, S_buf, Hkv, D). The port updates the cache IN
PLACE (the reference returns a new array): :func:`_insert_at` is an
index write of one row per sequence, so a decode step never copies the
cache.

The projections carry qwen2's f32 QKV biases (``qkv_bias``) and qwen3's
rmsnorm of q and k over the head dim before the rotation (``qk_norm``),
so training, prefill and decode all get them. Training
(:func:`attention_block`, and MLA's expanded block) and prefill run
:func:`attention_core`, the reference's algorithm (it is jnp there, not
Pallas): f32 scores, scaled and soft-capped, then masked, an online
softmax over KV chunks; autograd differentiates it as written. Its mask
is :func:`repro_torch.models.flash_attn.block_mask`, the port's one mask
model: causal or bidirectional (``causal=False``, the encoder and
cross-attention of the encdec family), with a bidirectional prefix
(``prefix_len``, the vlm family's image tokens) and an optional sliding
window. As in the reference,
``attn_q_chunk`` loops it over query blocks and ``flash_vjp`` hands each
block to :func:`repro_torch.models.flash_attn.flash_attention`, whose
backward pass recomputes the scores instead of saving them. Decode runs
the hand-written ``flash_decode`` kernel through
:func:`repro_torch.kernels.ops.flash_decode` (its plain version on CPU
tensors); the reference's other decode path, its jnp core, computes the
same function and is not ported.

Training takes ``sliding_window`` and ``attn_logit_softcap``; decode,
prefill and serving refuse both (:func:`check_decode_supported`). The
mask model's ``kv_len`` option waits for chunked prefill, which uses it.
Decode drops ``prefix_len``, as the reference does: a decoded token sits
after any prefix, so its mask is the causal one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.flash_attn import block_mask, flash_attention

NEG_INF = -1.0e30


def check_decode_supported(cfg) -> None:
    """Raise on what decode, prefill and serving do not cover yet (they
    take MLA; training takes all three)."""
    if cfg.sliding_window:
        raise NotImplementedError(
            f"sliding_window={cfg.sliding_window} is not yet ported to "
            "repro_torch's decode and serving (a window decodes from a "
            "ring cache, which comes with chunked prefill); training "
            "takes it")
    if cfg.attn_logit_softcap:
        # the reference applies the cap on its jnp path but drops it on
        # its flash-decode path; the port refuses rather than pick one
        raise NotImplementedError(
            f"attn_logit_softcap={cfg.attn_logit_softcap} is not yet "
            "ported to repro_torch's decode (the reference's flash-decode "
            "path ignores it while its jnp path applies it); training "
            "takes it")


def init_attention(gen: torch.Generator, cfg, d: int, dtype: torch.dtype,
                   device) -> dict:
    H, Hkv, hd = cfg.attn_dims
    p = {"wq": L.dense_init(gen, d, H * hd, dtype, device),
         "wk": L.dense_init(gen, d, Hkv * hd, dtype, device),
         "wv": L.dense_init(gen, d, Hkv * hd, dtype, device),
         "wo": L.dense_init(gen, H * hd, d, dtype, device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd, device=device)
        p["bk"] = torch.zeros(Hkv * hd, device=device)
        p["bv"] = torch.zeros(Hkv * hd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=device)
        p["k_norm"] = torch.ones(hd, device=device)
    return p


def qkv_project(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                rope: bool = True):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd): the f32 biases
    added in the activation dtype, q and k normed over the head dim, then
    rotated."""
    H, Hkv, hd = cfg.attn_dims
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope and cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, causal: bool = True,
                   window: int = 0, prefix_len: int | None = None,
                   kv_chunk: int = 1024, scale: float | None = None,
                   softcap: float = 0.0, q_chunk: int = 0,
                   flash_vjp: bool = False) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk`` keys.

    q: (B, Sq, H, D); k: (B, Sk, Hkv, D); v: (B, Sk, Hkv, Dv), Dv may
    differ from D (MLA). q_positions: (Sq,) or (B, Sq); keys sit at
    positions 0..Sk-1 and a query at qp attends the keys kp <= qp
    (``causal``; every key without it), the keys kp < prefix_len too
    when qp < ``prefix_len`` (a bidirectional prefix), and with a
    ``window`` > 0 only those with kp > qp - window. The scores
    are scaled by ``scale`` (default D ** -0.5), then capped to
    ``softcap * tanh(s / softcap)`` when ``softcap`` > 0, then masked, as
    the reference. Returns (B, Sq, H, Dv) in q.dtype; scores, softmax
    and accumulation in f32. The last chunk may be short (the reference
    pads it and masks the pad: the same function).

    ``q_chunk`` > 0 also loops over query blocks of that many rows when
    it divides Sq (and is smaller), which bounds the live (q_chunk,
    kv_chunk) score tile; ``flash_vjp`` computes each block with
    :func:`~repro_torch.models.flash_attn.flash_attention`, which saves
    no score tensor for the backward pass. Both as the reference.
    Neither path skips a KV chunk that lies wholly outside the window;
    the reference's scan does not either.
    """
    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        if q_positions.ndim == 1:
            q_positions = q_positions[None].expand(B, Sq)
        return torch.cat([
            attention_core(q[:, i:i + q_chunk], k, v,
                           q_positions=q_positions[:, i:i + q_chunk],
                           causal=causal, window=window,
                           prefix_len=prefix_len, kv_chunk=kv_chunk,
                           scale=scale, softcap=softcap, flash_vjp=flash_vjp)
            for i in range(0, Sq, q_chunk)], dim=1)
    # the mask model's (causal, window, prefix_len, scale, softcap, kv_len)
    cfgt = (causal, window, prefix_len, scale, softcap, None)
    if flash_vjp:
        return flash_attention(q, k, v, q_positions, cfgt, kv_chunk)
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    kc = min(kv_chunk, Sk)
    if q_positions.ndim == 1:
        q_positions = q_positions[None].expand(B, Sq)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), device=q.device)
    for c0 in range(0, Sk, kc):
        kb = k[:, c0:c0 + kc].float()
        vb = v[:, c0:c0 + kc].float()
        kp = torch.arange(c0, c0 + kb.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = block_mask(q_positions, kp, cfgt)            # (B,Sq,kc)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]) * (s > NEG_INF / 2)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]    # (B,Hkv,G,Sq,Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def attention_block(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, causal: bool = True, prefix_len: int | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Self-attention sub-block for training and prefill, projections
    included, with the config's logit softcap and its sliding window
    (``window`` overrides it): x (B, S, d) -> (B, S, d). ``causal=False``
    is the encoder's; ``prefix_len`` makes the first positions a
    bidirectional prefix."""
    B, S, _ = x.shape
    H, _, hd = cfg.attn_dims
    q, k, v = qkv_project(cfg, p, x, positions)
    out = attention_core(q, k, v, q_positions=positions, causal=causal,
                         window=cfg.sliding_window if window is None
                         else window, prefix_len=prefix_len,
                         softcap=cfg.attn_logit_softcap,
                         q_chunk=cfg.attn_q_chunk, flash_vjp=cfg.flash_vjp)
    return out.reshape(B, S, H * hd) @ p["wo"]


def decode_attention(cfg, p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor):
    """One-token decode: x (B,1,d), a layer's cache (B,S_buf,Hkv,hd),
    pos (B,) int32 absolute position. Writes the new K/V row into the
    cache in place and attends it through ``flash_decode`` (ONE kernel
    launch on CUDA tensors, the plain version on CPU tensors); returns
    (out (B,1,d), cache_k, cache_v).

    A free or retired slot keeps decoding, so its ``pos`` passes the
    capacity. The reference's ``dynamic_update_slice`` clamps that
    write to row S_buf - 1 and its masks then take every row; the port
    writes at min(pos, S_buf - 1) and attends min(pos + 1, S_buf) rows —
    the same function, and no write out of bounds on the card.
    """
    check_decode_supported(cfg)
    B = x.shape[0]
    H, Hkv, hd = cfg.attn_dims
    S_buf = cache_k.shape[1]
    q, k_new, v_new = qkv_project(cfg, p, x, pos[:, None])
    _insert_at(cache_k, k_new, pos)
    _insert_at(cache_v, v_new, pos)
    kv_len = torch.clamp(pos + 1, max=S_buf).to(torch.int32)
    out = kops.flash_decode(q[:, 0], cache_k, cache_v, kv_len,
                            scale=hd ** -0.5)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, cache_k, cache_v


def _insert_at(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
               ) -> torch.Tensor:
    """cache (B,S,...), new (B,1,...), pos (B,): write row
    min(pos[b], S-1) of each sequence, in place; returns ``cache``."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, torch.clamp(pos, max=S - 1).long()] = new[:, 0].to(
        cache.dtype)
    return cache
