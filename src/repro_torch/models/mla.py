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
so it launches no kernel here either. A chunk of a resumed prefill
(:func:`mla_chunk`) runs the same absorbed form over the latent cache.

Leaf names and layouts are the reference's: ``q_down``, ``q_norm``,
``q_up`` (or ``wq`` when ``q_lora_rank`` is 0), ``kv_down``,
``kv_norm``, ``k_up``, ``v_up``, ``wo``, dense weights ``(in, out)``
and f32 norm scales. The cache rows are written in place
(:func:`repro_torch.models.attention._insert_at`,
:func:`~repro_torch.models.attention._write_span`). MLA refuses a
sliding window and the logit softcap everywhere: the reference's MLA
ignores both.

On a ``model`` axis above 1 (``tp``) the head leaves are this rank's
blocks, as the reference's ``_ATTN`` rules cut them: ``q_up`` / ``wq``,
``k_up`` and ``v_up`` by columns, ``wo`` by rows; ``q_down``,
``kv_down`` and the norms whole. Training and prefill run Megatron's
split by heads (:func:`mla_block`): the replicated down projections run
before the split, their outputs (the normed query latent, c_kv and the
rope key) enter it through ONE ``copy_to_model``, the rank attends its
heads and takes its rows of ``wo``, and the ranks' outputs are summed.
Decode (:func:`mla_decode`) does the same over a latent cache cut into
sequence stripes: the rank absorbs ``k_up`` into its heads' queries,
gathers every head's (q_lat, q_rope) over ``model``, attends its stripe
for every head with each row's log-sum-exp (:func:`latent_attention`:
an empty stripe gives lse -inf and contributes 0), and the ranks'
partials are merged before the rank applies its ``v_up`` columns and
``wo`` rows.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.attention import (_insert_at, _rows, _write_span,
                                          attention_core, span_index,
                                          stripe_rows)

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


def _q_input(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """What the query heads are projected from: rmsnorm(x @ q_down) with
    a query rank, else x."""
    if cfg.q_lora_rank:
        return L.rmsnorm(x @ p["q_down"], p["q_norm"], cfg.norm_eps)
    return x


def _q_heads(cfg, p: dict, h: torch.Tensor, positions: torch.Tensor):
    """:func:`_q_input`'s h (B,S,*) -> q_nope (B,S,n,nope), q_rope
    (B,S,n,rope), roped, for the n heads ``p``'s ``q_up``/``wq`` holds."""
    B, S, _ = h.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = h @ (p["q_up"] if cfg.q_lora_rank else p["wq"])
    q = q.reshape(B, S, -1, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _queries(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,d) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope), roped."""
    return _q_heads(cfg, p, _q_input(cfg, p, x), positions)


def _latents(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """c_kv (B,S,r), normed; k_rope (B,S,1,rope), the roped shared key."""
    r = cfg.kv_lora_rank
    kv = x @ p["kv_down"]
    c_kv = L.rmsnorm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., r:][:, :, None, :], positions,
                          cfg.rope_theta)
    return c_kv, k_rope


# the leaves split by heads over ``model``: the dim each is cut along and
# its width a head
def _head_dims(cfg) -> dict:
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {"q_up": (1, nope + rope), "wq": (1, nope + rope),
            "k_up": (1, nope), "v_up": (1, vd), "wo": (0, vd)}


def _split_leaves(cfg, p: dict) -> set:
    """The head leaves of a layer's ``p`` stored as a rank's block (the
    reference's ``_divisible`` keeps a split only where ``model`` divides
    the dim; the others are whole)."""
    return {k for k, (dim, per) in _head_dims(cfg).items()
            if k in p and p[k].shape[dim] != cfg.num_heads * per}


def _split_weights(cfg, p: dict, tp, split: set) -> tuple[dict, bool]:
    """The head leaves one rank of ``tp`` computes with, and whether they
    are its own block of whole heads (the head count divides over the
    ranks: every head leaf is split, as stored). Else every head is
    computed on every rank: the split leaves all-gathered
    (``gather_from_model``: the rank keeps its block of the summed
    gradient) and the whole ones passed through ``copy_to_model`` (their
    gradient is the ranks' sum), ``wo`` left for :func:`_wo_share`."""
    if cfg.num_heads % tp.shape["model"] == 0:
        return p, True
    w = dict(p)
    for name, (dim, _) in _head_dims(cfg).items():
        if name in p and name != "wo":
            w[name] = C.gather_from_model(p[name], tp, dim) if name in split \
                else C.copy_to_model(p[name], tp)
    return w, False


def _wo_share(out: torch.Tensor, p: dict, tp, own: bool, split: set
              ) -> torch.Tensor:
    """This rank's share of the block's output (the ranks' shares sum to
    ``out @ wo``): its heads' output against its rows of ``wo`` where
    ``own``; where every head was computed, its block of ``out``'s
    columns against its rows of ``wo``, or, where ``wo`` is whole (its
    rows do not divide over the ranks), its ``tensor_split`` chunk of
    both, ``wo`` through ``copy_to_model``."""
    if own:
        return out @ p["wo"]
    if "wo" in split:
        return C.split_dim(out, tp, -1) @ p["wo"]
    m, r = tp.shape["model"], tp.coords["model"]
    n = out.shape[-1]
    lo = r * (n // m) + min(r, n % m)
    rows = n // m + (r < n % m)
    return out.narrow(-1, lo, rows) @ C.copy_to_model(
        p["wo"], tp).narrow(0, lo, rows)


def mla_block(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
              tp=None) -> torch.Tensor:
    """Training and prefill, the expanded form: x (B,S,d) -> (B,S,d).
    k_nope and v come up from the latent, the shared rope key goes to
    every head, and the attention scales by (nope + rope) ** -0.5, as the
    reference.

    ``tp``: a tensor-parallel mesh. Where its ``model`` axis splits a
    head leaf the block is Megatron's: the replicated down projections
    and their norms run on the whole ``x``, and their outputs (the query
    latent with a query rank, c_kv and the rope key) enter the split
    computation through ONE ``copy_to_model`` (without a query rank ``x``
    enters through a second, for ``wq``), so the down projections'
    gradients come out whole and bit-identical on every rank; the rank
    attends its heads, takes its rows of ``wo``, and the ranks' outputs
    are summed (``reduce_from_model``). Heads that do not divide over the
    ranks are all computed on every rank (:func:`_split_weights`).

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
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    split = _split_leaves(cfg, p) if tp is not None else set()
    h = _q_input(cfg, p, x)
    c_kv, k_rope = _latents(cfg, p, x, positions)
    w, own = p, True
    if split:
        r = cfg.kv_lora_rank
        parts = [c_kv, k_rope[:, :, 0]] + ([h] if cfg.q_lora_rank else [])
        shared = C.copy_to_model(torch.cat(parts, dim=-1), tp)
        c_kv, k_rope = shared[..., :r], shared[..., r:r + rope][:, :, None]
        h = shared[..., r + rope:] if cfg.q_lora_rank \
            else C.copy_to_model(x, tp)
        w, own = _split_weights(cfg, p, tp, split)
    q_nope, q_rope = _q_heads(cfg, w, h, positions)
    n = q_nope.shape[2]
    k_nope = (c_kv @ w["k_up"]).reshape(B, S, n, nope)
    v = (c_kv @ w["v_up"]).reshape(B, S, n, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, n, rope)], dim=-1)
    out = attention_core(q, k, v, q_positions=positions,
                         scale=(nope + rope) ** -0.5,
                         q_chunk=cfg.attn_q_chunk, flash_vjp=cfg.flash_vjp)
    out = out.reshape(B, S, n * vd)
    if not split:
        return out @ p["wo"]
    return C.reduce_from_model(_wo_share(out, p, tp, own, split), tp)


def latent_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv: torch.Tensor, krope: torch.Tensor,
                     lengths: torch.Tensor, scale: float):
    """The absorbed decode's attention over one stripe of a latent cache
    with each row's log-sum-exp, every product in f32: q_lat (B,H,r),
    q_rope (B,H,rope), the stripe's ckv (B,S,r) and krope (B,S,rope),
    ``lengths`` (B,) its valid rows. Returns (out_lat (B,H,r), lse (B,H)),
    as ``flash_decode(..., lse=True)`` defines them: lse = -inf and
    out_lat = 0 where the stripe holds no key of the row, so a merge
    (``merge_stripes``) weighs it 0. (A masked softmax would give such a
    row the mean of its stripe's latents instead.)"""
    ckv = ckv.float()
    scores = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    scores = (scores + torch.einsum("bhe,bse->bhs", q_rope,
                                    krope.float())) * scale
    valid = torch.arange(ckv.shape[1], device=ckv.device) \
        < lengths[:, None, None]
    scores = torch.where(valid, scores, -torch.inf)
    top = scores.amax(dim=-1)
    top = torch.where(torch.isfinite(top), top, 0.0)
    e = torch.exp(scores - top[..., None])                   # 0 off length
    total = e.sum(dim=-1)
    out = torch.einsum("bhs,bsr->bhr", e, ckv) \
        / total.clamp(min=1e-30)[..., None]
    lse = torch.where(total > 0, top + torch.log(total), -torch.inf)
    return out, lse


def mla_decode(cfg, p: dict, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, pos: torch.Tensor,
               live: torch.Tensor | None = None, *, tp=None, stripe=None):
    """One-token absorbed decode: x (B,1,d); a layer's caches, cache_ckv
    (B,S,r) and cache_krope (B,S,rope); pos (B,) int32. Writes the new
    latent and rope key at row min(pos, S-1) in place (not in the rows
    ``live`` masks off) and returns (out (B,1,d), cache_ckv,
    cache_krope).

    The reference clamps a write past capacity to row S-1 and attends
    the rows j < pos + 1: every row once pos reaches S-1; so does this.

    On a serving mesh: ``tp``, a tensor-parallel mesh whose ``model``
    axis splits the head leaves, and ``stripe``
    (:class:`~repro_torch.distributed.sharding.Stripe`), this rank's
    stripe of the sequence (the caches hold its ``stripe.rows`` rows of
    ``stripe.count * stripe.rows``). Every rank computes the new token's
    latents whole (``kv_down`` is replicated) and only the rank whose
    stripe holds row min(pos, S-1) writes it. The rank absorbs ``k_up``
    into its heads' queries and all-gathers (q_lat, q_rope) over
    ``model``, attends its stripe for every head with its own valid
    length ``clamp(min(pos + 1, S) - lo, 0, rows)``
    (:func:`latent_attention`), the ranks' partials are merged in f32
    (``merge_stripes`` over ``stripe.axis``), and the rank applies its
    ``v_up`` columns and ``wo`` rows to its heads of the merged latent,
    the ranks' outputs summed. Without a stripe each rank attends the
    whole cache with its own heads. Heads that do not divide over the
    ranks are all computed on every rank, as :func:`mla_block` computes
    them (:func:`_split_weights`, :func:`_wo_share`). The whole cache is
    the one-stripe case: the same :func:`latent_attention`, no merge
    (``attention.stripe_rows`` sets the write and the lengths of both).
    """
    B = x.shape[0]
    nope, rope, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    split = _split_leaves(cfg, p) if tp is not None else set()
    w, own = _split_weights(cfg, p, tp, split) if split else (p, False)
    q_nope, q_rope = _queries(cfg, w, x, pos[:, None])      # (B,1,n,*)
    c_kv, k_rope = _latents(cfg, p, x, pos[:, None])        # (B,1,r), ...
    n = q_nope.shape[2]
    # absorb W_uk into q: (B,1,n,nope) . (r,n,nope) -> (B,n,r)
    q_lat = torch.einsum("bohn,rhn->bhr", q_nope.float(),
                         w["k_up"].reshape(r, n, nope).float())
    q_rope = q_rope[:, 0].float()
    local, write, valid = stripe_rows(pos, pos, cache_ckv.shape[1], stripe,
                                      live)
    _insert_at(cache_ckv, c_kv, local, write)
    _insert_at(cache_krope, k_rope[:, :, 0], local, write)
    if stripe is not None and own:           # every head's query
        both = C.all_gather_dim(torch.cat([q_lat, q_rope], dim=-1), tp, 1)
        q_lat, q_rope = both[..., :r], both[..., r:]
    out_lat, lse = latent_attention(q_lat, q_rope, cache_ckv, cache_krope,
                                    valid, (nope + rope) ** -0.5)
    if stripe is not None:
        out_lat = C.merge_stripes(out_lat, lse, stripe.mesh, stripe.axis)
        if own:                              # this rank's heads
            out_lat = out_lat.narrow(1, tp.coords["model"] * n, n)
    out = torch.einsum("bhr,rhv->bhv", out_lat,
                       w["v_up"].reshape(r, n, vd).float())
    out = out.reshape(B, 1, n * vd).to(x.dtype)
    if not split:
        return out @ p["wo"], cache_ckv, cache_krope
    return C.reduce_from_model(_wo_share(out, p, tp, own, split), tp), \
        cache_ckv, cache_krope


def mla_chunk(cfg, p: dict, x: torch.Tensor, cache_ckv: torch.Tensor,
              cache_krope: torch.Tensor, qpos: torch.Tensor, start,
              lengths, rows: torch.Tensor | None = None, *,
              index: dict | None = None):
    """Absorbed resume-prefill for a C-token chunk, in place: x (n,C,d);
    the layer's latent caches (B,S,r) and (B,S,rope); ``rows`` (n,) the
    chunk rows' slots (default 0..n-1); qpos (n,C) absolute positions
    start[b] + i; ``start`` and ``lengths`` (n,) host values. The
    chunk's valid latents are written at [start, start + lengths) (past
    the capacity dropped), then the chunk attends the rows' latent cache
    under a causal + kv_len mask, so positions past start + lengths (a
    prior occupant's leftovers) never contribute. Every product in f32,
    as the reference's. Reads only the first max(start + lengths) rows of
    the chunk rows' slots. Returns (out (n,C,d), cache_ckv,
    cache_krope)."""
    n, C, _ = x.shape
    H = cfg.num_heads
    nope, rope, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    S = cache_ckv.shape[1]
    rows = _rows(cache_ckv, x, rows)
    if index is None:
        index = {}
    if (S, False) not in index:
        index[(S, False)] = span_index(start, lengths, S, False, x.device)
    q_nope, q_rope = _queries(cfg, p, x, qpos)              # (n,C,H,*)
    c_kv, k_rope = _latents(cfg, p, x, qpos)                # (n,C,r), ...
    _write_span(cache_ckv, c_kv, rows, index[(S, False)])
    _write_span(cache_krope, k_rope[:, :, 0], rows, index[(S, False)])
    start_h = torch.as_tensor(start).cpu().long()
    end_h = start_h + torch.as_tensor(lengths).cpu().long()
    kmax = max(1, min(int(end_h.max()), S))
    ckv = cache_ckv[rows, :kmax].float()
    krope = cache_krope[rows, :kmax].float()
    q_lat = torch.einsum("bchn,rhn->bchr", q_nope.float(),
                         p["k_up"].reshape(r, H, nope).float())
    scores = torch.einsum("bchr,bsr->bhcs", q_lat, ckv)
    scores = scores + torch.einsum("bche,bse->bhcs", q_rope.float(), krope)
    scores = scores * (nope + rope) ** -0.5
    kp = torch.arange(kmax, device=x.device)[None, None, None, :]
    qp = qpos[:, None, :, None]
    kv_len = end_h.to(x.device)[:, None, None, None]
    scores = torch.where((kp <= qp) & (kp < kv_len), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                   # (n,H,C,kmax)
    out_lat = torch.einsum("bhcs,bsr->bchr", probs, ckv)
    out = torch.einsum("bchr,rhv->bchv", out_lat,
                       p["v_up"].reshape(r, H, vd).float())
    out = out.reshape(n, C, H * vd).to(x.dtype) @ p["wo"]
    return out, cache_ckv, cache_krope
