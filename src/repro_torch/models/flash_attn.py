"""Memory-lean attention with a custom backward (FlashAttention-2's
backward, over torch ops): port of ``repro/models/flash_attn.py``.

Autograd through :func:`repro_torch.models.attention.attention_core`
saves every KV chunk's f32 score and probability tensors for the
backward pass — O(Sq * Sk) bytes per layer, the largest term of a
long-sequence training step. :func:`flash_attention` is a
``torch.autograd.Function`` that saves only ``(q, k, v, out, m, l)`` —
O(Sq * D) — and RECOMPUTES each (Sq, kc) score tile in its backward
pass.

Semantics are the reference's: the whole mask model in ``cfgt = (causal,
window, prefix_len, scale, softcap, kv_len)`` (causal or encoder,
sliding window, prefix-LM, a static count of valid keys, the logit
softcap), GQA, and a value head dim ``Dv`` that may differ from ``D``.
The keys are padded to a whole number of ``kv_chunk`` chunks and the pad
is masked.

Precision, as the reference's einsums give it: the score products (``s``
in the forward pass, ``s`` and ``dp`` in the backward pass) take their
operands in the model dtype and accumulate and return f32
(:func:`_mm_f32`); every product with an f32 operand (``p·v``, ``dv``,
``dk``, ``dq``) runs in f32, as JAX promotes bf16 with f32 to f32.

The large products are cuBLAS batched matmuls over an internal
``(B * Hkv, G * Sq, D)`` layout of the queries and ``(B * Hkv, Sk, D)``
of the keys and values; the rest is elementwise torch ops. No hand
kernel: the reference has none here either (it is jnp with a custom
VJP, not Pallas).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with f32 accumulation and an f32 result, the
    operands in their own dtype (the reference's
    ``preferred_element_type=f32``). On CUDA, bf16 operands go to cuBLAS
    as they are (``out_dtype``; with an f32 output every reduction is in
    f32, whatever ``allow_bf16_reduced_precision_reduction`` says, since
    that flag only governs reduced-precision outputs). The CPU has no
    such kernel: there the operands are upcast first. A product of two
    bf16 values is exact in f32, so both compute the same function up to
    summation order."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def block_mask(qp: torch.Tensor, kp: torch.Tensor, cfgt) -> torch.Tensor:
    """(B, Sq, kc) bool: qp (B, Sq) query positions, kp (kc,) keys' or
    (B, kc) per row (the keys of a ring cache, whose positions depend on
    each row's progress). ``kv_len`` in ``cfgt`` is a count of valid keys
    (keys at positions >= it are masked): an int, or a (B,) tensor per
    row."""
    causal, window, prefix_len, _, _, kv_len = cfgt
    qp = qp[..., :, None]
    kp_b = kp[:, None, :] if kp.ndim > 1 else kp[None, :]
    if causal:
        ok = kp_b <= qp
        if prefix_len is not None:
            ok = ok | ((qp < prefix_len) & (kp_b < prefix_len))
    else:
        ok = torch.ones(torch.broadcast_shapes(qp.shape, kp_b.shape),
                        dtype=torch.bool, device=qp.device)
    if window:
        ok = ok & (kp_b > qp - window)
    if kv_len is not None:
        if torch.is_tensor(kv_len) and kv_len.ndim:
            kv_len = kv_len[:, None, None]
        ok = ok & (kp_b < kv_len)
    return ok


def _scores(qh, kb, qpos, kp, cfgt, dims):
    """(B, Hkv, G, Sq, kc) masked scaled f32 scores, and the tanh of the
    capped ones (None without a softcap). qh (B*Hkv, G*Sq, D) and kb
    (B*Hkv, kc, D) stay in the model dtype: f32 comes from the product's
    accumulator."""
    _, _, _, scale, softcap, _ = cfgt
    s = _mm_f32(qh, kb.transpose(1, 2)) * scale
    s = s.view(*dims, kb.shape[1])
    cap_t = None
    if softcap:
        cap_t = torch.tanh(s / softcap)
        s = softcap * cap_t
    ok = block_mask(qpos, kp, cfgt)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    return s, cap_t


def _heads(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, S, Hkv * G, D) -> (B * Hkv, G * S, D): each kv head's group of
    query heads, head-major."""
    B, S, H, D = x.shape
    G = H // Hkv
    return x.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
        B * Hkv, G * S, D)


def _prepare(q, k, v, q_positions, cfgt, kv_chunk):
    """Shared set-up of both passes: the chunk size, the keys and values
    padded to whole chunks in the (B*Hkv, Skp, .) layout, the pad counted
    out by ``kv_len``, and the queries' positions as (B, Sq)."""
    B, Sq, _, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kc = min(kv_chunk, Sk)
    pad = (-Sk) % kc
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if cfgt[5] is None:
            cfgt = cfgt[:5] + (Sk,)
    if q_positions.ndim == 1:
        q_positions = q_positions[None].expand(B, Sq)
    return kc, cfgt, _heads(k, Hkv), _heads(v, Hkv), q_positions


def _flash_forward(q, k, v, q_positions, cfgt, kv_chunk):
    """The online softmax over KV chunks: (out (B, Sq, H, Dv) in q.dtype,
    m, l (B, Hkv, G, Sq) f32)."""
    B, Sq, H, _ = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    G = H // Hkv
    kc, cfgt, kh, vh, qpos = _prepare(q, k, v, q_positions, cfgt, kv_chunk)
    qh = _heads(q, Hkv)
    dims = (B, Hkv, G, Sq)
    m = torch.full(dims, NEG_INF, device=q.device)
    l = torch.zeros(dims, device=q.device)
    acc = torch.zeros(dims + (Dv,), device=q.device)
    for c0 in range(0, kh.shape[1], kc):
        kb, vb = kh[:, c0:c0 + kc], vh[:, c0:c0 + kc]
        kp = torch.arange(c0, c0 + kc, device=q.device)
        s, _ = _scores(qh, kb, qpos, kp, cfgt, dims)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]) * (s > NEG_INF / 2)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.bmm(p.view(B * Hkv, G * Sq, kc), vb.float())
        acc = acc * alpha[..., None] + pv.view(dims + (Dv,))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)
    return out, m, l


def _flash_backward(do, q, k, v, q_positions, out, m, l, cfgt, kv_chunk):
    """Recompute each chunk's scores and probabilities and accumulate
    (dq, dk, dv), as the reference's ``_flash_bwd``."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale, softcap = cfgt[3], cfgt[4]
    kc, cfgt, kh, vh, qpos = _prepare(q, k, v, q_positions, cfgt, kv_chunk)
    qh = _heads(q, Hkv)                    # model dtype (see _scores)
    doh = _heads(do, Hkv)
    dims = (B, Hkv, G, Sq)
    delta = (doh.float() * _heads(out, Hkv).float()).sum(dim=-1).view(dims)
    l_safe = torch.clamp(l, min=1e-30)
    q32, do32 = qh.float(), doh.float()
    dq = torch.zeros(B * Hkv, G * Sq, D, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, kh.shape[1], kc):
        kb, vb = kh[:, c0:c0 + kc], vh[:, c0:c0 + kc]
        kp = torch.arange(c0, c0 + kc, device=q.device)
        s, cap_t = _scores(qh, kb, qpos, kp, cfgt, dims)
        p = torch.exp(s - m[..., None]) * (s > NEG_INF / 2) \
            / l_safe[..., None]
        dp = _mm_f32(doh, vb.transpose(1, 2)).view(s.shape)
        ds = p * (dp - delta[..., None])            # d wrt capped s
        if softcap:
            ds = ds * (1.0 - torch.square(cap_t))   # through tanh
        p2 = p.view(B * Hkv, G * Sq, kc)
        ds2 = ds.view(B * Hkv, G * Sq, kc)
        dvs.append(torch.bmm(p2.transpose(1, 2), do32))
        dks.append(torch.bmm(ds2.transpose(1, 2), q32) * scale)
        dq = dq + torch.bmm(ds2, kb.float()) * scale
    dk = torch.cat(dks, dim=1)[:, :Sk].reshape(B, Hkv, Sk, D)
    dv = torch.cat(dvs, dim=1)[:, :Sk].reshape(B, Hkv, Sk, Dv)
    dq = dq.view(B, Hkv, G, Sq, D).permute(0, 3, 1, 2, 4).reshape(B, Sq,
                                                                  H, D)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, cfgt, kv_chunk):
        out, m, l = _flash_forward(q, k, v, q_positions, cfgt, kv_chunk)
        ctx.save_for_backward(q, k, v, q_positions, out, m, l)
        ctx.cfgt, ctx.kv_chunk = cfgt, kv_chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_positions, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_backward(do, q, k, v, q_positions, out, m, l,
                                     ctx.cfgt, ctx.kv_chunk)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, cfgt: tuple, kv_chunk: int
                    ) -> torch.Tensor:
    """Attention whose backward pass recomputes the scores.

    q (B, Sq, H, D); k (B, Sk, Hkv, D); v (B, Sk, Hkv, Dv); q_positions
    (Sq,) or (B, Sq) int; keys at positions 0..Sk-1. ``cfgt = (causal,
    window, prefix_len, scale, softcap, kv_len)``: ``window`` 0 and
    ``prefix_len``/``kv_len`` None turn those masks off, ``softcap`` 0
    the cap. Returns (B, Sq, H, Dv) in q.dtype; softmax and accumulation
    in f32.
    """
    return _FlashAttention.apply(q, k, v, q_positions, tuple(cfgt),
                                 kv_chunk)
