"""Mixture-of-Experts block: port of ``repro/models/moe.py``. A top-k
token-choice router, capacity-bounded sort-based dispatch, optional
shared experts (DeepSeek-V2 style) and a Switch-style load-balance
auxiliary loss, as plain functions on tensors.

The reference's steps, each with its meaning kept:
  1. top-k route: (N, k) expert ids and gates. ``jax.lax.top_k`` breaks
     ties toward the lower expert index and ``torch.topk`` promises no
     tie order, so the ids come from a stable sort of ``-probs``;
  2. flatten to N*k slots and sort them by (dispatch group, expert id),
     stably (as ``jnp.argsort`` inside each group): inside an expert the
     lower token index comes first, and that order decides which tokens
     capacity drops;
  3. each sorted slot's position within its expert, from a cumulative
     max over the segment starts (``torch.cummax`` for the reference's
     ``associative_scan(jnp.maximum, ...)``);
  4. slot -> ``(E*C)`` buffer index, dropped slots to a trash row; the
     tokens into (G, E, C, d), the rows no slot fills zero (the
     reference gathers its zero trash token N there). The port writes
     each slot's token into its row, so the backward pass gathers where
     a gather's backward would accumulate (~E*C - N*k duplicates of the
     trash token);
  5. batched per-expert products (G, E, C, d) x (E, d, ff) in the
     params' dtype;
  6. combine: each token's kept slot outputs times their gates, in the
     model dtype, added one at a time in ascending expert order. That is
     the order in which the reference's scatter-add (XLA on the CPU)
     adds a token's k contributions, rounding at each add. The port
     gathers each token's k slot outputs rather than scattering them,
     so no add is atomic and the card's result does not vary from run
     to run.

Tokens beyond an expert's capacity C = round(k * N/E * capacity_factor)
are dropped (``dropped_frac``). ``cfg.moe_groups`` G > 1 splits the N
tokens into G independent dispatch groups, which the reference vmaps
over; here the group is the leading part of each slot's sort key.

On a mesh (the reference's GSPMD program, done by hand):

* ``data``: the rows of ``x`` are this rank's block of the global batch
  (rank r of D holds rows [r B/D, (r+1) B/D), so its tokens are
  [r N/D, (r+1) N/D) of the row-major token order), and every routing
  decision is the global batch's. The hidden rows stay where they are:
  each rank counts its slots per (group, expert), the ranks all-gather
  those (G, E) counts over ``data`` (a few ints, no gradient), and a
  slot's position in its expert is its position among the rank's slots
  plus the counts of the lower ranks in the same group and expert.
  Capacity is reckoned from the global group, ``dropped_frac`` is the
  global share, and each rank's aux loss is ``E * sum_e me_e * ce_e``
  with its own tokens' share of ``me`` (scaled so that the mean over the
  ranks, which the pipeline takes, is the reference's) and the global
  counts' ``ce``: the mean of the ranks' values and of their gradients
  is the reference's.
* ``tp`` (a ``model`` axis above 1, tokens whole on every rank of it, so
  every rank routes identically): the expert stacks are this rank's
  blocks as ``distributed.sharding``'s ``_MOE`` (the experts split) or
  ``_MOE_TP`` (each expert's ff split, column-parallel ``wi``/``wg``,
  row-parallel ``wo``) cut them, read from the leaves' shapes (a split
  that ``_divisible`` dropped leaves the leaf whole: computed whole, no
  reduce). Each rank combines the slots its experts (or its ff block)
  produce, and one ``reduce_from_model`` of the (N, d) output sums the
  ranks' partial outputs; a split shared expert's partial output joins
  that sum. The experts' input and the gates enter the split
  computation through ``copy_to_model`` (the sum of the ranks' partial
  gradients in backward), the router and the aux loss stay outside it,
  so the router's gradient is whole and the same on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.mlp import init_mlp, mlp_block


def init_moe(gen: torch.Generator, cfg, d: int, dtype: torch.dtype,
             device) -> dict:
    """The reference's distributions (an f32 router at fan-in scale 0.1,
    normal / sqrt(d_in) expert stacks in ``dtype``), drawn from ``gen``
    in a fixed order: router, wi, wo, wg, shared."""
    E, ff = cfg.num_experts, cfg.moe_d_ff
    p = {"router": L.dense_init(gen, d, E, torch.float32, device, scale=0.1),
         "wi": _stack_init(gen, E, d, ff, dtype, device),
         "wo": _stack_init(gen, E, ff, d, dtype, device)}
    if L.gated(cfg):
        p["wg"] = _stack_init(gen, E, d, ff, dtype, device)
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d,
                               cfg.moe_d_ff * cfg.num_shared_experts, dtype,
                               device)
    return p


def _stack_init(gen: torch.Generator, E: int, d_in: int, d_out: int,
                dtype: torch.dtype, device) -> torch.Tensor:
    return L._normal(gen, (E, d_in, d_out), 1.0 / d_in ** 0.5, dtype, device)


class Route(NamedTuple):
    """The router's decisions for this rank's tokens, and where they lie
    among the dispatch groups of the global batch: ``first`` is the
    global index of the rank's first group, ``group`` (n,) each token's
    group counted from it, ``lengths`` the rank's tokens in each of its
    groups, ``size`` the global tokens a group holds; ``counts`` (G, E)
    int64 this rank's slots per (global group, expert)."""

    probs: torch.Tensor
    expert_ids: torch.Tensor
    gates: torch.Tensor
    group: torch.Tensor
    first: int
    lengths: tuple
    size: int
    counts: torch.Tensor

    @property
    def groups(self) -> int:
        return len(self.lengths)


def route(cfg, router: torch.Tensor, xt: torch.Tensor, *, start: int = 0,
          total: Optional[int] = None) -> Route:
    """Route tokens xt (n, d): tokens [start, start + n) of a global
    batch of ``total`` (default n) tokens, cut into ``cfg.moe_groups``
    dispatch groups. f32 logits, softmax, top-k with ties to the lower
    id (the router leaf is f32, or bf16 under a bf16 compute policy,
    which the f32 product upcasts, as JAX's type promotion does)."""
    n = xt.shape[0]
    total = n if total is None else total
    G = max(1, cfg.moe_groups)
    if total % G:
        raise ValueError(f"{total} tokens do not split into {G} moe_groups")
    E, k = cfg.num_experts, cfg.experts_per_token
    size = total // G
    first, last = start // size, (start + n - 1) // size
    edges = [start] + [g * size for g in range(first + 1, last + 1)] \
        + [start + n]
    lengths = tuple(b - a for a, b in zip(edges, edges[1:]))
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    with torch.no_grad():
        top = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
        # a token's k experts in ascending id: the order of its slots
        # after the stable sort by expert, and of its adds in the combine
        expert_ids, _ = top.sort(dim=-1)                      # (n, k)
        group = torch.div(torch.arange(start, start + n, device=xt.device),
                          size, rounding_mode="floor") - first
        key = (group + first)[:, None] * E + expert_ids
        counts = torch.bincount(key.reshape(-1), minlength=G * E)
    gates = probs.gather(-1, expert_ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return Route(probs, expert_ids, gates, group, first, lengths, size,
                 counts.reshape(G, E))


def capacity(cfg, size: int) -> int:
    """An expert's slots in a dispatch group of ``size`` tokens (Python's
    round, half to even, as the reference's)."""
    return int(max(1, round(cfg.experts_per_token * size / cfg.num_experts
                            * cfg.capacity_factor)))


class Slots(NamedTuple):
    """Every slot of a :class:`Route`, sorted by (group, expert) then
    token: ``order`` the sort (slot index token * k + j), ``key`` its
    local group * E + expert, ``pos`` its position among this rank's
    slots of that group and expert, ``keep`` whether its position in the
    global batch's group is below the capacity."""

    order: torch.Tensor
    key: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


@torch.no_grad()
def place(cfg, r: Route, lower: Optional[torch.Tensor] = None) -> Slots:
    """Sort ``r``'s slots and keep those inside capacity. ``lower`` (G, E):
    the slots of the tokens before this rank's, per (group, expert): the
    offset of its positions in the global batch (None: no tokens
    before)."""
    E = cfg.num_experts
    key = (r.group[:, None] * E + r.expert_ids).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    idx = torch.arange(sk.shape[0], device=sk.device)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    pos = idx - torch.where(start, idx, 0).cummax(dim=0).values
    at = pos if lower is None else \
        pos + lower[r.first:r.first + r.groups].reshape(-1)[sk]
    return Slots(order, sk, pos, at < capacity(cfg, r.size))


def moe_block(cfg, p: dict, x: torch.Tensor, tp=None, data=None
              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), aux {aux_loss, dropped_frac}), the
    aux values f32 scalars averaged over the dispatch groups. ``data``: a
    mesh whose ``data`` axis splits the rows of ``x`` (this rank's block
    of the global batch; None: ``x`` is the whole batch); ``tp``: a
    tensor-parallel mesh whose ``model`` axis splits the expert leaves
    of ``p`` (module docstring)."""
    B, S, d = x.shape
    n = B * S
    D = 1 if data is None else data.shape["data"]
    rank = 0 if data is None else data.coords["data"]
    xt = x.reshape(n, d)
    r = route(cfg, p["router"], xt, start=rank * n, total=D * n)
    lower, every = None, r.counts
    if D > 1:
        gathered = C.all_gather_rows(r.counts[None], data, "data")
        lower, every = gathered[:rank].sum(0), gathered.sum(0)
    slots = place(cfg, r, lower)
    out, split = _experts(cfg, p, xt, r, slots, tp, compact=D > 1)
    aux_loss, dropped = balance(cfg, r, every, D)

    if cfg.num_shared_experts:
        ffs = cfg.moe_d_ff * cfg.num_shared_experts
        shared_split = tp is not None and p["shared"]["wo"].shape[0] != ffs
        if split and not shared_split:
            out, split = C.reduce_from_model(out, tp), False
        # a split shared expert's partial output joins the experts'
        # before the one reduce
        shared = mlp_block(cfg, p["shared"], xt, tp, ff=ffs,
                           reduce=not split)
        out = out + shared.to(out.dtype)
    if split:
        out = C.reduce_from_model(out, tp)
    return (out.reshape(B, S, d).to(x.dtype),
            {"aux_loss": aux_loss, "dropped_frac": dropped})


def balance(cfg, r: Route, every: torch.Tensor, ranks: int = 1
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(aux loss, dropped_frac) of this rank's :class:`Route`, f32
    scalars, from ``every`` (G, E): the global batch's slots per (group,
    expert), over ``ranks`` ranks that split it in equal blocks. The
    load-balance loss (Switch) is ``E * sum_e me_e * ce_e`` a group,
    averaged over the groups and times ``router_aux_coef``, with ``me``
    from this rank's tokens, scaled by ``ranks`` so that the mean over
    the ranks is the global group's, and ``ce`` from the global counts.
    ``dropped_frac``, the slots beyond capacity, is the global batch's
    on every rank."""
    E, k = cfg.num_experts, cfg.experts_per_token
    psum = torch.stack([p.sum(dim=0) for p in r.probs.split(r.lengths)])
    ce = every[r.first:r.first + r.groups].float() / r.size
    aux = E * torch.sum((psum / r.size) * ce, dim=-1)
    aux_loss = aux.sum() * (ranks / every.shape[0])
    over = torch.clamp(every - capacity(cfg, r.size), min=0)
    dropped = over.sum(dim=-1).float() / (r.size * k)
    return aux_loss * cfg.router_aux_coef, dropped.mean()


def _experts(cfg, p: dict, xt: torch.Tensor, r: Route, s: Slots, tp,
             compact: bool) -> tuple[torch.Tensor, bool]:
    """Steps 4-6 for the experts this rank holds: (out (n, d) in the
    params' dtype, whether it is a partial sum over ``model``). Each
    group's buffer holds C rows an expert; with ``compact`` (tokens split
    over ``data``) as many as the rank keeps at most, so the products
    run on this rank's slots only."""
    n, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    El, ff = p["wi"].shape[0], p["wi"].shape[-1]
    split = tp is not None and (El != E or ff != cfg.moe_d_ff)
    e0 = tp.coords["model"] * El if El != E else 0
    gates = r.gates
    if split:
        xt, gates = C.copy_to_model(xt, tp), C.copy_to_model(gates, tp)
    with torch.no_grad():
        group, expert = s.key // E, s.key % E - e0
        mine = s.keep & (expert >= 0) & (expert < El)
        cap = capacity(cfg, r.size)
        if compact:
            cap = max(1, int(torch.where(mine, s.pos + 1, 0).max()))
        rows = r.groups * El * cap
        # slot -> buffer row; dropped slots and other ranks' experts to
        # the trash row, which is cut off
        buf = torch.where(mine, (group * El + expert) * cap + s.pos, rows)
        # each token's k slots (ascending expert id) -> buffer rows; a
        # slot not in the buffer has its output masked, so it reads row
        # (its slot index mod rows) rather than one shared row, which
        # would make one hot spot of the gather's backward
        buf_tok = torch.empty_like(buf).scatter_(0, s.order, buf)
        keep_tok = buf_tok < rows
        idx = torch.arange(n * k, device=xt.device)
        rows_tok = torch.where(keep_tok, buf_tok, idx % rows)
        keep_tok = keep_tok.reshape(n, k, 1)
    # each slot's token into its buffer row
    xe = xt.new_zeros(rows + 1, d).index_put(
        (buf,), xt[torch.div(s.order, k, rounding_mode="floor")])
    xe = xe[:-1].reshape(r.groups, El, cap, d)

    # ---- 5. per-expert products, in the params' dtype
    act = L.act_fn(cfg)
    h = torch.matmul(xe, p["wi"])                     # (G, El, cap, ff)
    if "wg" in p:
        h = act(torch.matmul(xe, p["wg"])) * h
    else:
        h = act(h)
    ye = torch.matmul(h, p["wo"])                     # (G, El, cap, d)

    # ---- 6. combine in the model dtype, a token's adds by ascending id
    slot_out = ye.reshape(rows, d)[rows_tok].reshape(n, k, d)
    contrib = torch.where(keep_tok, slot_out * gates[..., None].to(
        slot_out.dtype), 0)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out, split
