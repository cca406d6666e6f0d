"""Mixture-of-Experts block: port of ``repro/models/moe.py``. A top-k
token-choice router, capacity-bounded sort-based dispatch, optional
shared experts (DeepSeek-V2 style) and a Switch-style load-balance
auxiliary loss, as plain functions on tensors.

The reference's steps, each with its meaning kept:
  1. top-k route: (N, k) expert ids and gates. ``jax.lax.top_k`` breaks
     ties toward the lower expert index and ``torch.topk`` promises no
     tie order, so the ids come from a stable sort of ``-probs``;
  2. flatten to N*k slots and sort them by expert id, stably (as
     ``jnp.argsort``): inside an expert the lower token index comes
     first, and that order decides which tokens capacity drops;
  3. each sorted slot's position within its expert, from a cumulative
     max over the segment starts (``torch.cummax`` for the reference's
     ``associative_scan(jnp.maximum, ...)``);
  4. slot -> ``(E*C)`` buffer index, dropped slots to the trash row
     ``E*C``; the tokens into (E, C, d), the rows no slot fills zero (the
     reference gathers its zero trash token N there). The port writes
     each slot's token into its row, so the backward pass gathers where
     a gather's backward would accumulate (~E*C - N*k duplicates of the
     trash token);
  5. batched per-expert products (E, C, d) x (E, d, ff) in the params'
     dtype;
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
over; here the group axis is a batch axis of every step.
"""

from __future__ import annotations

import torch

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


def moe_block(cfg, p: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), aux {aux_loss, dropped_frac}), the
    aux values f32 scalars averaged over the dispatch groups."""
    B, S, d = x.shape
    G = max(1, cfg.moe_groups)
    N = B * S
    if N % G:
        raise ValueError(f"{N} tokens do not split into {G} moe_groups")
    out, aux = _moe_group(cfg, p, x.reshape(G, N // G, d))
    out = out.reshape(N, d)
    if cfg.num_shared_experts:
        shared = mlp_block(cfg, p["shared"], x.reshape(N, d))
        out = out + shared.to(out.dtype)
    return (out.reshape(B, S, d).to(x.dtype),
            {"aux_loss": aux["aux_loss"].mean(),
             "dropped_frac": aux["dropped_frac"].mean()})


def _moe_group(cfg, p: dict, xt: torch.Tensor
               ) -> tuple[torch.Tensor, dict]:
    """G dispatch groups at once. xt (G, N, d) -> (out (G, N, d), aux
    {aux_loss (G,), dropped_frac (G,)})."""
    G, N, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = xt.device

    # ---- 1. route: f32 logits, softmax, top-k with ties to the lower id
    # (the router leaf is f32, or bf16 under a bf16 compute policy, which
    # the f32 product upcasts, as JAX's type promotion does)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    with torch.no_grad():
        top = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
        # a token's k experts in ascending id: the order of its slots
        # after the stable sort by expert, and of its adds in the combine
        expert_ids, _ = top.sort(dim=-1)                      # (G, N, k)
    gates = probs.gather(-1, expert_ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=1)                                    # (G, E)
    counts = torch.zeros(G, E, device=dev).scatter_add_(
        1, expert_ids.reshape(G, N * k),
        torch.ones(G, N * k, device=dev))
    aux_loss = E * torch.sum(me * (counts / N), dim=-1)       # (G,)

    # ---- capacity (Python's round, half to even, as the reference's)
    C = int(max(1, round(k * N / E * cfg.capacity_factor)))

    with torch.no_grad():
        # ---- 2. sort slots by expert, stably
        slot_expert = expert_ids.reshape(G, N * k)
        order = torch.argsort(slot_expert, dim=-1, stable=True)
        se = slot_expert.gather(1, order)
        st = order // k                                       # slot token
        # ---- 3. position of each sorted slot within its expert
        idx = torch.arange(N * k, device=dev).expand(G, -1)
        start = torch.ones_like(se, dtype=torch.bool)
        start[:, 1:] = se[:, 1:] != se[:, :-1]
        seg_start = torch.where(start, idx, 0).cummax(dim=1).values
        pos = idx - seg_start
        keep = pos < C
        dropped_frac = 1.0 - keep.float().mean(dim=1)
        # ---- 4. slot -> buffer index; dropped slots to the trash row
        buf = torch.where(keep, se * C + pos, E * C)
        group = torch.arange(G, device=dev)[:, None]
        # each token's k slots (ascending expert id) -> buffer rows; a
        # dropped slot's output is masked, so it reads row (its slot
        # index mod E*C) rather than one shared row, which would make one
        # hot spot of the gather's backward
        buf_tok = torch.empty_like(buf).scatter_(1, order, buf)
        keep_tok = buf_tok < E * C
        rows = (torch.where(keep_tok, buf_tok, idx % (E * C))
                + group * (E * C))
        keep_tok = keep_tok.reshape(G, N, k, 1)
    # each slot's token into its buffer row; the trash row E*C takes the
    # dropped slots and is cut off
    xs = xt.reshape(G * N, d)[(st + group * N).reshape(-1)]
    xe = xt.new_zeros(G * (E * C + 1), d).index_put(
        ((buf + group * (E * C + 1)).reshape(-1),), xs)
    xe = xe.reshape(G, E * C + 1, d)[:, :-1].reshape(G, E, C, d)

    # ---- 5. per-expert products, in the params' dtype
    act = L.act_fn(cfg)
    h = torch.matmul(xe, p["wi"])                             # (G, E, C, ff)
    if "wg" in p:
        h = act(torch.matmul(xe, p["wg"])) * h
    else:
        h = act(h)
    ye = torch.matmul(h, p["wo"])                             # (G, E, C, d)

    # ---- 6. combine in the model dtype, a token's adds by ascending id
    slot_out = ye.reshape(G * E * C, d)[rows.reshape(-1)].reshape(G, N, k, d)
    contrib = torch.where(keep_tok, slot_out * gates[..., None].to(
        slot_out.dtype), 0)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out, {"aux_loss": aux_loss * cfg.router_aux_coef,
                 "dropped_frac": dropped_frac}
