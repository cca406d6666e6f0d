"""GQA/MHA/MQA attention of the dense and MoE families: projections, the
blockwise online-softmax core for training and prefill, and one-token
decode over a persistent KV cache. Port of ``repro/models/attention.py``.

Layouts as the reference's: q (B, S, H, D), k/v (B, S, Hkv, D), a
layer's decode cache (B, S_buf, Hkv, D). The port updates the cache IN
PLACE (the reference returns a new array): :func:`_insert_at` is an
index write of one row per sequence, so a decode step never copies the
cache, and a chunk of a resumed prefill (:func:`chunk_attention`)
writes only its valid positions (:func:`_insert_span`,
:func:`_ring_update`).

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

On a serving mesh (:func:`decode_attention`'s ``tp`` and ``stripe``) a
rank holds a stripe of the cache's sequence for every head: it projects
its heads (column-parallel, as training's block), gathers the new
token's q and k/v over the heads, writes the new row only where its
stripe holds it, runs ``flash_decode`` on its stripe with the
log-sum-exp and merges the ranks' partial softmaxes
(:func:`repro_torch.distributed.collectives.merge_stripes`), then takes
its heads into the row-parallel ``wo``. Prefill
(:func:`prefill_attention`) computes its heads and gathers the prompt's
K/V over the heads for the cache.

A sliding window decodes from a RING cache of ``window`` rows, as the
reference's: the key of absolute position p (roped at p) sits in row
p % window, and decode attends every written row (``kv_len = min(pos +
1, S_buf)``). The logit softcap applies at decode as in training and in
the reference's jnp decode: each scaled score s becomes cap * tanh(s /
cap) before the softmax, inside the ``flash_decode`` kernel. (The
reference's kernel path drops the cap; that difference is its own.)
Decode drops ``prefix_len``, as the reference does: a decoded token sits
after any prefix, so its mask is the causal one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.flash_attn import block_mask, flash_attention

NEG_INF = -1.0e30


def check_decode_supported(cfg) -> None:
    """Raise on what decode, prefill and serving refuse: MLA with a
    sliding window or the logit softcap. The reference's ``mla_block``
    and ``mla_decode`` ignore both, so the port refuses such a config
    rather than serve it as if neither were set (training refuses it
    too)."""
    if cfg.use_mla and (cfg.sliding_window or cfg.attn_logit_softcap):
        raise NotImplementedError(
            f"MLA with sliding_window={cfg.sliding_window} or "
            f"attn_logit_softcap={cfg.attn_logit_softcap} is not yet "
            "ported to repro_torch: the reference's MLA ignores both (its "
            "latent cache keeps no window's ring cache), so the port "
            "refuses them rather than serve without them")


def ring_windowed(cfg, S_buf: int) -> bool:
    """Whether a cache of ``S_buf`` rows is a sliding window's ring (the
    key of position p in row p % S_buf), as the reference decides it."""
    return bool(cfg.sliding_window) and cfg.sliding_window <= S_buf


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
                rope: bool = True, tp=None):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd): the f32 biases
    added in the activation dtype, q and k normed over the head dim, then
    rotated.

    ``tp``: a tensor-parallel mesh whose ``model`` axis splits ``wq``'s
    columns (inside the ranks' split computation: ``x`` has passed
    :func:`~repro_torch.distributed.collectives.copy_to_model`). q then
    holds this rank's block of heads, and k/v the KV heads they read; see
    :func:`_split_weights`."""
    w = _split_weights(cfg, p, tp) if tp is not None else p
    q, k, v = _project(cfg, w, x, positions, rope)
    if tp is not None:
        k, v = (_kv_for_heads(t, w["kv_heads"]) for t in (k, v))
    return q, k, v


def _project(cfg, w: dict, x: torch.Tensor, positions: torch.Tensor,
             rope: bool = True):
    """q, k, v of the heads ``w``'s projections hold, biased, normed
    over the head dim and rotated (per head: which heads they are does
    not change a head's values)."""
    hd = cfg.attn_dims[2]
    B, S, _ = x.shape
    q = x @ w["wq"]
    k = x @ w["wk"]
    v = x @ w["wv"]
    if cfg.qkv_bias:
        q = q + w["bq"].to(q.dtype)
        k = k + w["bk"].to(k.dtype)
        v = v + w["bv"].to(v.dtype)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, w["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, w["k_norm"], cfg.norm_eps)
    if rope and cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _split_heads(cfg, p: dict, tp) -> tuple[bool, bool]:
    """Whether this rank's q holds its block of the heads (the head count
    divides over the ranks; else every head, computed whole), and
    whether its k/v hold its block of the KV heads (else every KV
    head): as :func:`_split_weights` splits them."""
    H, Hkv, hd = cfg.attn_dims
    m = tp.shape["model"]
    aligned = H % m == 0
    return aligned, (p["wk"].shape[-1] != Hkv * hd and aligned
                     and Hkv % m == 0)


def _gather_heads(parts: list, tp) -> list:
    """Each of ``parts`` ((B, S, n_i, hd): this rank's block of its
    heads) with every rank's heads, in rank order: ONE all-gather over
    ``model`` of the parts side by side."""
    B, S, _, hd = parts[0].shape
    sizes = [t.shape[2] for t in parts]
    both = C.all_gather_dim(torch.cat(parts, dim=2).contiguous(), tp, 2)
    both = both.reshape(B, S, tp.shape["model"], sum(sizes), hd)
    return [t.reshape(B, S, -1, hd).contiguous()
            for t in both.split(sizes, dim=3)]


def _project_all_heads(cfg, p: dict, x: torch.Tensor,
                       positions: torch.Tensor, tp, *, all_q: bool = False):
    """Under a tensor-parallel ``tp``: this rank's projections (q, and
    k/v for its query heads, as training's block computes them) and the
    new k/v of EVERY KV head (a cache holds every head), gathered over
    ``model`` where the ranks split them; with ``all_q`` q of every head
    too (decode: the rank attends its stripe for every head), in the
    same one all-gather. Returns (q, k_heads, v_heads, k_all, v_all)."""
    w = _split_weights(cfg, p, tp)
    q, k, v = _project(cfg, w, x, positions)
    aligned, kv_local = _split_heads(cfg, p, tp)
    k_all, v_all = k, v
    if all_q and aligned:
        if kv_local:
            q, k_all, v_all = _gather_heads([q, k, v], tp)
        else:
            q, = _gather_heads([q], tp)
        return q, None, None, k_all, v_all
    if kv_local:
        k_all, v_all = _gather_heads([k, v], tp)
    if all_q:
        return q, None, None, k_all, v_all
    k, v = (_kv_for_heads(t, w["kv_heads"]) for t in (k, v))
    return q, k, v, k_all, v_all


def _split_weights(cfg, p: dict, tp) -> dict:
    """The projections one rank of ``tp``'s ``model`` axis computes with.

    ``wq``/``bq`` are column-split (the caller checked): where the head
    count divides over the ranks they are this rank's heads, as stored;
    where it does not, they are all-gathered (``gather_from_model``: the
    rank keeps its block of the summed gradient) and every head is
    computed on every rank. ``wk``/``wv``/``bk``/``bv`` stay this rank's
    where both head counts divide; else they are gathered (split) or
    passed through ``copy_to_model`` (replicated: their gradient is the
    ranks' sum), and ``kv_heads`` names the KV heads that the rank's
    query heads read. The replicated QK-norm scales pass through
    ``copy_to_model`` too."""
    H, Hkv, hd = cfg.attn_dims
    m, r = tp.shape["model"], tp.coords["model"]
    aligned = H % m == 0
    w = dict(p)
    if aligned:
        h0, nq = r * (H // m), H // m
    else:
        h0, nq = 0, H
        for name in ("wq", "bq"):
            if name in p:
                w[name] = C.gather_from_model(p[name], tp, -1)
    kv_split = p["wk"].shape[-1] != Hkv * hd
    kv_local = kv_split and aligned and Hkv % m == 0
    for name in ("wk", "wv", "bk", "bv"):
        if name in p and not kv_local:
            w[name] = C.gather_from_model(p[name], tp, -1) if kv_split \
                else C.copy_to_model(p[name], tp)
    for name in ("q_norm", "k_norm"):
        if name in p:
            w[name] = C.copy_to_model(p[name], tp)
    # the KV head each query head reads, counted from the first KV head
    # this rank's k/v hold
    G = H // Hkv
    base = r * (Hkv // m) if kv_local else 0
    w["kv_heads"] = [(h0 + j) // G - base for j in range(nq)]
    return w


def _kv_for_heads(t: torch.Tensor, heads: list) -> torch.Tensor:
    """k or v (B, S, n, hd) cut to the KV heads ``heads`` reads, in the
    grouping ``attention_core`` takes (query head j reads KV head
    j // (nq / nkv)): a range of heads where every one serves the same
    number of query heads, else one KV head per query head."""
    uniq = sorted(set(heads))
    per = len(heads) // len(uniq)
    if all(heads[j] == uniq[0] + j // per for j in range(len(heads))):
        if uniq[0] == 0 and len(uniq) == t.shape[2]:
            return t
        return t[:, :, uniq[0]:uniq[-1] + 1]
    return t[:, :, heads]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, causal: bool = True,
                   window: int = 0, prefix_len: int | None = None,
                   kv_len=None, kv_positions: torch.Tensor | None = None,
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

    ``kv_len`` (an int, or a (B,) tensor per row) masks the keys at
    positions >= it; ``kv_positions`` (B, Sk) gives each row's keys
    their own absolute positions (a ring cache ahead of a chunk's keys,
    the chunked prefill's windowed path). Both are the reference's; with
    either as a tensor ``flash_vjp`` is not taken, as in the reference.

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
                           prefix_len=prefix_len, kv_len=kv_len,
                           kv_positions=kv_positions, kv_chunk=kv_chunk,
                           scale=scale, softcap=softcap, flash_vjp=flash_vjp)
            for i in range(0, Sq, q_chunk)], dim=1)
    # the mask model's (causal, window, prefix_len, scale, softcap, kv_len)
    cfgt = (causal, window, prefix_len, scale, softcap, kv_len)
    if flash_vjp and not torch.is_tensor(kv_len) and kv_positions is None:
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
        kp = (torch.arange(c0, c0 + kb.shape[1], device=q.device)
              if kv_positions is None else kv_positions[:, c0:c0 + kc])
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
                    window: int | None = None, tp=None) -> torch.Tensor:
    """Self-attention sub-block for training and prefill, projections
    included, with the config's logit softcap and its sliding window
    (``window`` overrides it): x (B, S, d) -> (B, S, d). ``causal=False``
    is the encoder's; ``prefix_len`` makes the first positions a
    bidirectional prefix.

    ``tp``: a tensor-parallel mesh (Megatron's split). Where it splits
    ``wo``'s rows (and so ``wq``'s columns: one count, H * hd) the block
    runs between ``copy_to_model`` and ``reduce_from_model``: this
    rank's heads (:func:`qkv_project`), its rows of ``wo``, the ranks'
    partial outputs summed. Heads computed whole (H not divisible by the
    ranks) meet ``wo`` as this rank's block of their output. Where
    nothing is split the block is the plain one on every rank."""
    B, S, _ = x.shape
    H, _, hd = cfg.attn_dims
    if tp is not None and p["wo"].shape[0] == H * hd:
        tp = None
    if tp is not None:
        x = C.copy_to_model(x, tp)
    q, k, v = qkv_project(cfg, p, x, positions, tp=tp)
    out = attention_core(q, k, v, q_positions=positions, causal=causal,
                         window=cfg.sliding_window if window is None
                         else window, prefix_len=prefix_len,
                         softcap=cfg.attn_logit_softcap,
                         q_chunk=cfg.attn_q_chunk, flash_vjp=cfg.flash_vjp)
    out = out.reshape(B, S, -1)
    if tp is None:
        return out @ p["wo"]
    if out.shape[-1] == H * hd:                 # every head, whole
        out = C.split_dim(out, tp, -1)
    return C.reduce_from_model(out @ p["wo"], tp)


def prefill_attention(cfg, p: dict, h: torch.Tensor,
                      positions: torch.Tensor, prefix_len: int | None = None,
                      tp=None):
    """A GQA attention sub-block over a whole prompt, with the config's
    window and softcap: (out (B, S, d), k, v (B, S, Hkv, hd) of every KV
    head, for the cache). Under a tensor-parallel ``tp`` that splits
    ``wo``'s rows the rank computes its heads (column-parallel, as
    training's block) and its rows of ``wo``, the ranks' outputs summed,
    and gathers the prompt's K/V over the heads. The reference's hybrid
    prefill leaves the softcap out of its shared block (its training,
    decode and chunked prefill apply it); the port applies it here
    too."""
    B, S, _ = h.shape
    H, _, hd = cfg.attn_dims
    if tp is not None and p["wo"].shape[0] == H * hd:
        tp = None
    if tp is None:
        q, k, v = qkv_project(cfg, p, h, positions)
        k_all, v_all = k, v
    else:
        q, k, v, k_all, v_all = _project_all_heads(cfg, p, h, positions,
                                                   tp)
    out = attention_core(q, k, v, q_positions=positions,
                         window=cfg.sliding_window, prefix_len=prefix_len,
                         softcap=cfg.attn_logit_softcap,
                         q_chunk=cfg.attn_q_chunk, flash_vjp=cfg.flash_vjp)
    out = out.reshape(B, S, -1)
    if tp is None:
        return out @ p["wo"], k_all, v_all
    if out.shape[-1] == H * hd:                 # every head, whole
        out = C.split_dim(out, tp, -1)
    return C.reduce_from_model(out @ p["wo"], tp), k_all, v_all


def decode_attention(cfg, p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     live: torch.Tensor | None = None, *, tp=None,
                     stripe=None):
    """One-token decode: x (B,1,d), a layer's cache (B,S_buf,Hkv,hd),
    pos (B,) int32 absolute position. Writes the new K/V row into the
    cache in place and attends it through ``flash_decode`` (ONE kernel
    launch on CUDA tensors, the plain version on CPU tensors), with the
    config's logit softcap; returns (out (B,1,d), cache_k, cache_v).

    A windowed ring (:func:`ring_windowed`) takes the row at pos % S_buf
    and attends min(pos + 1, S_buf) rows. A linear cache: a free or
    retired slot keeps decoding, so its ``pos`` passes the capacity. The
    reference's ``dynamic_update_slice`` clamps that write to row S_buf
    - 1 and its masks then take every row; the port writes at min(pos,
    S_buf - 1) and attends min(pos + 1, S_buf) rows — the same function,
    and no write out of bounds on the card.

    ``live`` (B,) bool drops the K/V writes of the rows it masks off
    (their output is computed and meant to be discarded): the masked
    live decode of chunked admission.

    On a serving mesh: ``tp``, a tensor-parallel mesh whose ``model``
    axis splits the projections, and ``stripe``
    (:class:`~repro_torch.distributed.sharding.Stripe`), this rank's
    stripe of the sequence (``cache_k`` holds its ``stripe.rows`` rows
    of the whole ``stripe.count * stripe.rows``, for every head). The
    rank projects its heads, gathers the new token's q over the heads
    and its k/v over the KV heads; the new row is written only by the
    rank whose stripe holds it (row ``min(pos, S - 1)`` or a ring's
    ``pos % S``; the others drop the write); ``flash_decode`` runs on
    the stripe with its own valid length ``clamp(min(pos + 1, S) -
    index * rows, 0, rows)`` and the log-sum-exp, the ranks' partials
    are merged in f32 and rounded once, and the rank takes its heads
    into the row-parallel ``wo``, the ranks' outputs summed.
    """
    check_decode_supported(cfg)
    B = x.shape[0]
    H, Hkv, hd = cfg.attn_dims
    if tp is not None and p["wo"].shape[0] == H * hd:
        tp = None
    S_loc = cache_k.shape[1]
    S_buf = S_loc * (stripe.count if stripe is not None else 1)
    if tp is None:
        q, k_new, v_new = qkv_project(cfg, p, x, pos[:, None])
    else:
        q, _, _, k_new, v_new = _project_all_heads(cfg, p, x, pos[:, None],
                                                   tp, all_q=True)
    row = pos % S_buf if ring_windowed(cfg, S_buf) else pos
    softcap = float(cfg.attn_logit_softcap or 0.0)
    local, write, n = stripe_rows(row, pos, S_loc, stripe, live)
    _insert_at(cache_k, k_new, local, write)
    _insert_at(cache_v, v_new, local, write)
    if stripe is None:
        out = kops.flash_decode(q[:, 0], cache_k, cache_v,
                                n.to(torch.int32), scale=hd ** -0.5,
                                softcap=softcap)
    else:
        part, lse = kops.flash_decode(q[:, 0], cache_k, cache_v,
                                      n.to(torch.int32), scale=hd ** -0.5,
                                      softcap=softcap, lse=True)
        out = C.merge_stripes(part, lse, stripe.mesh,
                              stripe.axis).to(x.dtype)
    out = out.reshape(B, 1, H * hd)
    if tp is None:
        return out @ p["wo"], cache_k, cache_v
    out = C.split_dim(out, tp, -1)
    return C.reduce_from_model(out @ p["wo"], tp), cache_k, cache_v


def stripe_rows(row: torch.Tensor, pos: torch.Tensor, rows: int,
                stripe=None, live: torch.Tensor | None = None):
    """Where one decode token's new cache row goes in this rank's
    ``rows`` rows of a cache, and what they attend: (the new row's local
    index, the write mask for :func:`_insert_at`, each sequence's valid
    length), all (B,). ``row`` is the new row's index in the whole cache
    (``pos``, or a ring's ``pos % S``), clamped to its last row; ``stripe``
    (:class:`~repro_torch.distributed.sharding.Stripe`, None: the rank
    holds the whole cache) puts the rank's rows at ``lo = index * rows``
    of ``S = count * rows``: only the rank whose stripe holds the new row
    writes it, and each attends ``clamp(min(pos + 1, S) - lo, 0, rows)``
    of its rows. ``live`` masks the writes of a whole cache; the masked
    live decode on a stripe is not ported and raises."""
    if stripe is None:
        return torch.clamp(row, max=rows - 1), live, \
            torch.clamp(pos + 1, max=rows)
    if live is not None:
        raise NotImplementedError(
            "the masked live decode (chunked prefill) on a serving mesh is "
            "ROADMAP.md queue 1 item 4c-ii, not yet ported to repro_torch")
    S, lo = stripe.count * rows, stripe.index * rows
    local = torch.clamp(row, max=S - 1) - lo
    mine = (local >= 0) & (local < rows)
    return torch.clamp(local, 0, rows - 1), mine, \
        torch.clamp(torch.clamp(pos + 1, max=S) - lo, 0, rows)


def _insert_at(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
               live: torch.Tensor | None = None) -> torch.Tensor:
    """cache (B,S,...), new (B,1,...), pos (B,): write row
    min(pos[b], S-1) of each sequence, in place; returns ``cache``. Where
    ``live`` (B,) bool is False the row keeps its value (it is read and
    written back: the write's shape does not depend on the mask)."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = torch.clamp(pos, max=S - 1).long()
    val = new[:, 0].to(cache.dtype)
    if live is not None:
        keep = live.reshape((-1,) + (1,) * (val.ndim - 1))
        val = torch.where(keep, val, cache[rows, idx])
    cache[rows, idx] = val
    return cache


# ----------------------------------------------------------- chunk resume

def span_index(start, lengths, S_buf: int, ring: bool, device
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where a chunk's valid positions go: (b, i, row) long tensors on
    ``device`` for chunk position i of row b (absolute position
    start[b] + i, i < lengths[b]) stored at cache row ``row``. A linear
    cache keeps position p at row p and drops positions past its
    capacity, as the reference's ``mode="drop"`` scatter; a ring keeps
    the newest ``S_buf`` positions of the chunk at p % S_buf, as the
    reference's :func:`_ring_update`. Pad positions (i >= lengths[b])
    are never written. ``start`` and ``lengths`` are host values (a CPU
    tensor or an array): the index is built on the host."""
    start = np.asarray(torch.as_tensor(start).cpu(), np.int64).reshape(-1)
    lengths = np.asarray(torch.as_tensor(lengths).cpu(),
                         np.int64).reshape(-1)
    lo = np.zeros_like(lengths)
    if ring:
        lo = np.maximum(0, lengths - S_buf)
    counts = lengths - lo
    b = np.repeat(np.arange(len(lengths)), counts)
    i = np.concatenate([np.arange(a, z) for a, z in zip(lo, lengths)]
                       or [np.zeros(0, np.int64)]).astype(np.int64)
    p = start[b] + i
    if ring:
        row = p % S_buf
    else:
        keep = p < S_buf
        b, i, row = b[keep], i[keep], p[keep]
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (b, i, row))


def _write_span(cache: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
                index) -> torch.Tensor:
    """cache[rows[b], row] = new[b, i] for :func:`span_index`'s (b, i,
    row), in place."""
    b, i, row = index
    cache[rows[b], row] = new[b, i].to(cache.dtype)
    return cache


def _insert_span(cache: torch.Tensor, new: torch.Tensor, start, lengths,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``new`` (n, C, ...) at positions [start[b], start[b] +
    lengths[b]) of a linear cache's rows ``rows`` (default 0..n-1), in
    place. Positions past the capacity are dropped, not clamped (as the
    reference's): clamping would shift the write window backward over
    real entries. The reference also writes the pad positions past
    ``lengths``; nothing reads them (every read is masked at start +
    lengths, and decode writes a row before it reads it), so the port
    leaves them."""
    rows = _rows(cache, new, rows)
    return _write_span(cache, new, rows, span_index(
        start, lengths, cache.shape[1], False, cache.device))


def _ring_update(ring: torch.Tensor, chunk: torch.Tensor, start, lengths,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter a prefill chunk into a windowed ring, per row, in place:
    ring (B, cap, ...); chunk (n, C, ...) holds absolute positions
    start[b] + i, of which only i < lengths[b] are valid. Ring slot j of
    row ``rows[b]`` takes the NEWEST valid position p with p % cap == j
    and keeps its old value otherwise — pad positions never clobber
    resident entries (as the reference's)."""
    rows = _rows(ring, chunk, rows)
    return _write_span(ring, chunk, rows, span_index(
        start, lengths, ring.shape[1], True, ring.device))


def _rows(cache: torch.Tensor, new: torch.Tensor, rows) -> torch.Tensor:
    if rows is None:
        return torch.arange(new.shape[0], device=cache.device)
    return rows.to(device=cache.device, dtype=torch.long)


def ring_positions(start: torch.Tensor, qpos: torch.Tensor, S_buf: int
                   ) -> torch.Tensor:
    """(n, S_buf) absolute position of each ring slot's occupant before a
    chunk resumed at ``start``: slot j holds the newest p < start with p
    % S_buf == j; a slot not yet written gets the position after the
    chunk's last query, so the causal mask removes it."""
    j = torch.arange(S_buf, device=qpos.device)[None, :]
    start = start.to(qpos.device, torch.int64)[:, None]
    occ = j + S_buf * torch.div(start - 1 - j, S_buf, rounding_mode="floor")
    return torch.where(occ < 0, qpos[:, -1:].to(torch.int64) + 1, occ)


def chunk_attention(cfg, p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, qpos: torch.Tensor, start,
                    lengths, rows: torch.Tensor | None = None, *,
                    kv_chunk: int = 512, index: dict | None = None):
    """Resume-prefill attention for a C-token chunk against a live slot
    cache, in place. x (n, C, d); the layer's resident cache (B, S_buf,
    Hkv, hd); ``rows`` (n,) the chunk rows' slots (default 0..n-1); qpos
    (n, C) absolute positions start[b] + i (on the device); ``start``
    and ``lengths`` (n,) host values, the valid tokens per row (0: the
    row is left as it is). Returns (out (n, C, d), cache_k, cache_v).

    Linear caches: the chunk's K/V is written first, then the queries
    attend the rows' cache under the causal mask and ``kv_len = start +
    lengths`` — only the first max(start + lengths) rows are read, and
    stale entries of a retired occupant are never read. Windowed rings:
    the queries attend [the resident ring || the chunk's K/V] BEFORE the
    ring is rewritten (writing first would lose ring positions that the
    chunk's early queries still need), each ring slot at its occupant's
    absolute position (:func:`ring_positions`). As the reference's; the
    port reads only the chunk rows' slots (``cache[rows]``) and writes
    only their valid positions. ``index`` memoizes :func:`span_index`
    across the layers of one chunk call."""
    n, C, _ = x.shape
    H, Hkv, hd = cfg.attn_dims
    S_buf = cache_k.shape[1]
    ring = ring_windowed(cfg, S_buf)
    rows = _rows(cache_k, x, rows)
    key = (S_buf, ring)
    if index is None:
        index = {}
    if key not in index:
        index[key] = span_index(start, lengths, S_buf, ring, x.device)
    start_d = torch.as_tensor(start).to(x.device, torch.int32)
    kv_len = start_d + torch.as_tensor(lengths).to(x.device, torch.int32)
    q, k_new, v_new = qkv_project(cfg, p, x, qpos)
    cap = float(cfg.attn_logit_softcap or 0.0)
    if ring:
        occ = ring_positions(start_d, qpos, S_buf)
        kv_k = torch.cat([cache_k[rows], k_new.to(cache_k.dtype)], 1)
        kv_v = torch.cat([cache_v[rows], v_new.to(cache_v.dtype)], 1)
        kvp = torch.cat([occ, qpos.to(torch.int64)], dim=1)
        out = attention_core(q, kv_k, kv_v, q_positions=qpos,
                             kv_positions=kvp, causal=True,
                             window=cfg.sliding_window, kv_len=kv_len,
                             kv_chunk=S_buf + C, softcap=cap)
        _write_span(cache_k, k_new, rows, index[key])
        _write_span(cache_v, v_new, rows, index[key])
    else:
        _write_span(cache_k, k_new, rows, index[key])
        _write_span(cache_v, v_new, rows, index[key])
        kmax = int((np.asarray(torch.as_tensor(start).cpu())
                    + np.asarray(torch.as_tensor(lengths).cpu())).max())
        kmax = max(1, min(kmax, S_buf))
        out = attention_core(q, cache_k[rows, :kmax], cache_v[rows, :kmax],
                             q_positions=qpos, causal=True, kv_len=kv_len,
                             kv_chunk=kv_chunk, softcap=cap)
    out = out.reshape(n, C, H * hd) @ p["wo"]
    return out, cache_k, cache_v
