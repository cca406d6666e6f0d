"""Selective state-space blocks: Mamba-1 (falcon-mamba-7b) and Mamba-2/SSD
(zamba2-7b). Port of ``repro/models/ssm.py``: plain functions over plain
dict params, in the reference's leaf layouts and dtype boundaries.

Recurrences (as the reference):
  mamba1: h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t + D x_t
          (A (d_inner, N) diagonal and real, dt per channel)
  mamba2: per head, a scalar decay a_t = exp(dt_t A_h):
          H_t = a_t H_{t-1} + dt_t x_t (x) B_t ;        y_t = H_t C_t + D x_t
          (H (hd, N); B and C shared by the heads of a group)

Decode (S = 1) is one recurrence step. Training and prefill stream the
sequence in chunks of ``chunk`` steps (the last one padded), carrying the
state from chunk to chunk, as the reference's scan over chunks; the
(B, S, d_inner, N) states are never held whole. The port takes GROUP
chunks at a time, each still scanned and carried on its own, so a chunk
costs a few kernel launches. Within a chunk Mamba-1 runs :func:`_scan_`,
the log-depth scan of the reference's ``associative_scan`` (its combine
and its odd-even tree), in place on the chunk's decays and inputs;
:class:`_SelectiveScan` saves only its inputs and recomputes the states
in its backward pass, as the reference's ``jax.checkpoint`` of its scan
body does, and there runs the adjoint recurrence as the same scan
reversed. Mamba-2 runs the SSD matmul form, whose intra-chunk weights
are masked before the ``exp``, each group checkpointed. XLA fuses and
contracts these sums its own way, so the tests state their tolerances.

With ``lengths`` (a right-padded batch) both set ``dt`` to 0 on pad
steps: decay 1 and no input, so the carried state is exactly the state
after each row's last true token, and the conv state is gathered at
each row's length.

The reference has no ``pallas_call`` here: everything is torch ops and
launches no hand kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


# ------------------------------------------------------------- causal conv1d

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  state=None, lengths=None):
    """Depthwise causal conv. x (B, S, C), w (K, C), b (C,).

    ``state`` (B, K-1, C) carries the left context for decode. Returns
    (y in x.dtype, new_state); the sums are f32. With ``lengths`` (B,)
    the new state is the last K-1 inputs before each row's padding, not
    the padded tail.
    """
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(w[i].float() * xp[:, i:i + S].float() for i in range(K))
    y = y + b.float()
    if K <= 1:
        new_state = x.new_zeros((B, 0, C))
    elif lengths is None:
        new_state = xp[:, -(K - 1):]
    else:
        # row b's state: xp[b, len_b : len_b + K-1] (xp is left-padded by
        # K-1), the start clamped into range as dynamic_slice clamps it
        start = lengths.long().clamp(0, S)
        idx = start[:, None] + torch.arange(K - 1, device=x.device)
        new_state = xp[torch.arange(B, device=x.device)[:, None], idx]
    return y.to(x.dtype), new_state


# ------------------------------------------------------------------- init

def _host(shape: tuple, device, make) -> torch.Tensor:
    """``make()`` computed on the host (from the caller's CPU generator,
    so one seed gives the same bits on every device) and moved to
    ``device``; on the meta device nothing is drawn or computed."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return make().to(device)


def _uniform(gen: torch.Generator, shape: tuple, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _dt_bias(gen, n: int, device) -> torch.Tensor:
    """softplus^-1 of U(1e-3, 1e-1)."""
    return _host((n,), device, lambda: torch.log(torch.expm1(
        _uniform(gen, (n,), 1e-3, 1e-1))))


def init_mamba1(gen: torch.Generator, cfg, dtype: torch.dtype,
                device) -> dict:
    """The reference's leaves, shapes, dtypes and distributions, drawn
    from ``gen`` in a fixed order."""
    d, din, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    R, K = cfg.dt_rank, cfg.ssm_conv
    return {
        "in_proj": L.dense_init(gen, d, 2 * din, dtype, device),
        "conv_w": L._normal(gen, (K, din), 1.0 / K ** 0.5, torch.float32,
                            device),
        "conv_b": torch.zeros(din, device=device),
        "x_proj": L.dense_init(gen, din, R + 2 * N, dtype, device),
        "dt_proj": L.dense_init(gen, R, din, torch.float32, device,
                                scale=R ** 0.5 / R),
        "dt_bias": _dt_bias(gen, din, device),
        "A_log": _host((din, N), device, lambda: torch.log(
            torch.arange(1, N + 1, dtype=torch.float32)[None].repeat(din,
                                                                     1))),
        "D": torch.ones(din, device=device),
        "out_proj": L.dense_init(gen, din, d, dtype, device),
    }


def init_mamba2(gen: torch.Generator, cfg, dtype: torch.dtype,
                device) -> dict:
    d, din, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    heads, G = din // cfg.ssm_head_dim, cfg.ssm_groups
    dxbc = din + 2 * G * N
    return {
        "in_proj": L.dense_init(gen, d, 2 * din + 2 * G * N + heads, dtype,
                                device),
        "conv_w": L._normal(gen, (cfg.ssm_conv, dxbc),
                            1.0 / cfg.ssm_conv ** 0.5, torch.float32,
                            device),
        "conv_b": torch.zeros(dxbc, device=device),
        "A_log": _host((heads,), device, lambda: torch.log(
            _uniform(gen, (heads,), 1.0, 16.0))),
        "dt_bias": _dt_bias(gen, heads, device),
        "D": torch.ones(heads, device=device),
        "norm_scale": torch.ones(din, device=device),
        "out_proj": L.dense_init(gen, din, d, dtype, device),
    }


# ------------------------------------------------------------------ scans

# chunks per group: the streamed scans take GROUP chunks at a time (each
# still scanned, and its state carried, chunk by chunk), so a (B, c,
# d_inner, N) chunk costs a few kernel launches, not dozens
GROUP = 8


def _scan_(d: torch.Tensor, u: torch.Tensor) -> None:
    """In place, over axis 1: the inclusive scan of the maps h -> d * h + u
    (d becomes the prefix decays, u the prefix inputs), with the
    reference's combine of a earlier than b, (a0 * b0, b0 * a1 + b1), and
    the odd-even recursion ``lax.associative_scan`` builds: combine
    neighbouring pairs into the odd positions, scan those (a half as long
    sequence), then extend each prefix to the even position after it.
    Depth 2 log2(c) for c steps, four strided in-place ops a level."""
    c = d.shape[1]
    if c < 2:
        return
    m = c // 2
    de, do = d[:, 0:2 * m:2], d[:, 1:2 * m:2]
    ue, uo = u[:, 0:2 * m:2], u[:, 1:2 * m:2]
    uo.addcmul_(do, ue)
    do.mul_(de)
    _scan_(do, uo)
    n = (c - 1) // 2                    # the even positions 2, 4, ...
    u[:, 2::2].addcmul_(d[:, 2::2], uo[:, :n])
    d[:, 2::2].mul_(do[:, :n])


def _selective_scan_fwd(dt, x, Bm, Cm, A, h0, chunk: int):
    """The Mamba-1 recurrence over one group of whole chunks, no autograd:
    dt, x (B, L, din); Bm, Cm (B, L, N); A (din, N); h0 (B, din, N), all
    f32. Each chunk is scanned on its own (as the reference's scan body)
    and its state carried into the next. Returns (y (B, L, din), the
    states h_all (B, L, din, N), the state after the group)."""
    B, L, din = dt.shape
    N = A.shape[1]
    d = torch.exp(dt[..., None] * A)                      # (B,L,din,N)
    u = (dt * x)[..., None] * Bm[:, :, None, :]
    _scan_(d.view(-1, chunk, din, N), u.view(-1, chunk, din, N))
    d5, u5 = d.view(B, -1, chunk, din, N), u.view(B, -1, chunk, din, N)
    h = h0
    for k in range(d5.shape[1]):        # h_all = istar + dstar * h
        u5[:, k].addcmul_(d5[:, k], h[:, None])
        h = u5[:, k, -1]
    y = torch.einsum("bldn,bln->bld", u, Cm)
    return y, u, h.clone()


class _SelectiveScan(torch.autograd.Function):
    """The Mamba-1 selective scan over a group of chunks: (dt, x, B, C, A,
    h0) -> (y, the state after the group). Saves only its inputs and
    recomputes the states in its backward pass, as the reference's
    ``jax.checkpoint`` of the scan body does. The backward pass runs the
    adjoint recurrence lambda_t = g_t + decay_{t+1} lambda_{t+1} (g the
    output's and the carried state's gradient) as the same in-place scan
    over the reversed sequence, then the closed-form gradients of the
    decays exp(dt A), the inputs dt x B and the read C . h."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A, h0, chunk):
        with torch.no_grad():
            y, _, h = _selective_scan_fwd(dt, x, Bm, Cm, A, h0, chunk)
        ctx.save_for_backward(dt, x, Bm, Cm, A, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, x, Bm, Cm, A, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(dt)
        with torch.no_grad():
            _, h_all, _ = _selective_scan_fwd(dt, x, Bm, Cm, A, h0,
                                              ctx.chunk)
            # the adjoint, in reversed time: g_t = dy_t C_t (+ dh at the
            # end), decays shifted by one step (decay_{t+1}; 1 at the end)
            g = dy.flip(1)[..., None] * Cm.flip(1)[:, :, None, :]
            if dh is not None:
                g[:, 0] += dh
            dts = torch.zeros_like(dt)
            dts[:, 1:] = dt.flip(1)[:, :-1]
            a = torch.exp(dts[..., None] * A)
            _scan_(a, g)
            del a
            lam = g.flip(1)                                # dL/du_t
            del g
            dtx_grad = torch.einsum("bldn,bln->bld", lam, Bm)
            dB = torch.einsum("bldn,bld->bln", lam, dt * x)
            dC = torch.einsum("bldn,bld->bln", h_all, dy)
            decay = torch.exp(dt[..., None] * A)
            dh0 = decay[:, 0] * lam[:, 0]
            # dL/d decay_t = lambda_t h_{t-1}, times d decay / d(dt A)
            lam[:, 1:].mul_(h_all[:, :-1])
            lam[:, 0].mul_(h0)
            del h_all
            lam.mul_(decay)
            del decay
            dA = (lam * dt[..., None]).sum((0, 1))
            ddt = lam.mul_(A).sum(-1) + dtx_grad * x
            dx = dtx_grad * dt
        return ddt, dx, dB, dC, dA, dh0, None


def _mamba2_group(h, dtc, xc, bc, cc, A, chunk: int):
    """The SSD form over a group of whole chunks: h (B, heads, hd, N);
    dtc (B, L, heads); xc (B, L, heads, hd); bc, cc (B, L, heads, N).
    Each chunk's intra-chunk output and own state contribution are
    computed for all the group's chunks at once; the state is then
    carried chunk by chunk, and each chunk reads the state it entered
    with. Returns (the state after the group, y (B, L, heads, hd))."""
    B, L, H = dtc.shape
    c = chunk
    dtc, xc, bc, cc = (t.reshape((B, L // c, c) + t.shape[2:])
                       for t in (dtc, xc, bc, cc))
    tri = torch.ones(c, c, dtype=torch.bool, device=dtc.device).tril()
    ldec = torch.cumsum(dtc * A, dim=2)                   # (B,g,c,h), <= 0
    # intra-chunk: W[t,s] = exp(l_t - l_s) (C_t . B_s) dt_s for s <= t.
    # Masked BEFORE the exp: for s > t the exponent is positive and can
    # overflow to inf, and inf * 0 is NaN; exp(-inf) = 0 is the safe zero
    diff = ldec[:, :, :, None] - ldec[:, :, None, :, :]   # (B,g,t,s,h)
    gate = torch.exp(torch.where(tri[:, :, None], diff, -math.inf))
    W = torch.einsum("bgthn,bgshn->bgtsh", cc, bc) * gate * dtc[:, :, None]
    y_intra = torch.einsum("bgtsh,bgshd->bgthd", W, xc)
    # each chunk's own contribution to the state it hands on:
    # sum_s exp(l_end - l_s) dt_s x_s (x) B_s
    l_end = ldec[:, :, -1]                                # (B,g,h)
    w_s = torch.exp(l_end[:, :, None] - ldec) * dtc       # (B,g,c,h)
    own = torch.einsum("bgchd,bgchn->bghdn", w_s[..., None] * xc, bc)
    entered = []                        # H' = exp(l_end) H + own
    for k in range(dtc.shape[1]):
        entered.append(h)
        h = torch.exp(l_end[:, k])[..., None, None] * h + own[:, k]
    # inter-chunk: the entered state read through C, decayed by exp(l_t)
    y_inter = torch.exp(ldec)[..., None] * torch.einsum(
        "bgthn,bghdn->bgthd", cc, torch.stack(entered, dim=1))
    return h, (y_intra + y_inter).reshape((B, L) + xc.shape[3:])


def _mamba2_checkpointed(h, *args):
    """:func:`_mamba2_group`, checkpointed when autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(_mamba2_group, h, *args, use_reentrant=False)
    return _mamba2_group(h, *args)


def _mamba1_group(h, dt, x, Bm, Cm, A, chunk: int):
    """:class:`_SelectiveScan` on one group of chunks: (state, y)."""
    y, h = _SelectiveScan.apply(dt, x, Bm, Cm, A, h, chunk)
    return h, y


def _stream(group, h0, per_step: list, A, chunk: int):
    """Run ``group(h, *slices, A, c)`` over the (B, S, ...) tensors
    ``per_step`` in groups of GROUP chunks of c = min(chunk, S) steps,
    carrying the state; the last chunk is padded with zeros (a zero dt is
    an identity step). Returns (the state after the last chunk, the
    outputs cut to S)."""
    S = per_step[0].shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        per_step = [F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                    for t in per_step]
    step, h, ys = c * GROUP, h0, []
    for i in range(0, S + pad, step):
        h, y = group(h, *(t[:, i:i + step] for t in per_step), A, c)
        ys.append(y)
    return h, torch.cat(ys, dim=1)[:, :S]


def _pad_mask(dt: torch.Tensor, lengths, S: int) -> torch.Tensor:
    """dt (B, S, ...) with the steps at and past each row's length set
    to 0 (identity steps of the recurrence)."""
    if lengths is None:
        return dt
    mask = torch.arange(S, device=dt.device)[None, :] < \
        lengths.to(dt.device)[:, None]
    return dt * mask.reshape(mask.shape + (1,) * (dt.ndim - 2))


# ----------------------------------------------------------------- mamba1

def mamba1_forward(cfg, p: dict, x: torch.Tensor, *, state=None,
                   chunk: int = 64, lengths=None):
    """x (B, S, d). ``state``: None (training, prefill from zeros) or
    {"conv", "h"} to carry. Returns (y (B, S, d), new_state, or None
    when ``state`` is None)."""
    B, S, _ = x.shape
    din, N, R = cfg.ssm_d_inner, cfg.ssm_state, cfg.dt_rank
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)      # (B,S,din)
    xs, new_conv = causal_conv1d(
        xs, p["conv_w"], p["conv_b"],
        state=state["conv"] if state is not None else None, lengths=lengths)
    xs = F.silu(xs)
    dt, Bc, Cc = torch.split(xs @ p["x_proj"], [R, N, N], dim=-1)
    # f32 x f32, as the reference promotes a bf16 dt_proj (bf16 policy)
    dt = F.softplus(dt.float() @ p["dt_proj"].float()
                    + p["dt_bias"])                       # (B,S,din)
    dt = _pad_mask(dt, lengths, S)
    A = -torch.exp(p["A_log"])                            # (din,N)
    xf, Bf, Cf = xs.float(), Bc.float(), Cc.float()
    h0 = state["h"] if state is not None else x.new_zeros(
        (B, din, N), dtype=torch.float32)
    if S == 1:          # decode: one recurrence step
        decay = torch.exp(dt[:, 0, :, None] * A)          # (B,din,N)
        inp = (dt[:, 0] * xf[:, 0])[..., None] * Bf[:, 0, None, :]
        h_last = decay * h0 + inp
        y = torch.einsum("bdn,bn->bd", h_last, Cf[:, 0])[:, None]
    else:
        h_last, y = _stream(_mamba1_group, h0, [dt, xf, Bf, Cf], A, chunk)
    y = y + p["D"] * xf
    y = y * F.silu(z.float())
    y = y.to(x.dtype) @ p["out_proj"]
    new_state = None if state is None else {"conv": new_conv, "h": h_last}
    return y, new_state


# ----------------------------------------------------------------- mamba2

def mamba2_forward(cfg, p: dict, x: torch.Tensor, *, state=None,
                   chunk: int = 64, lengths=None):
    """The SSD block. x (B, S, d) -> (y (B, S, d), new_state)."""
    B, S, _ = x.shape
    din, N, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_head_dim
    heads, G = din // hd, cfg.ssm_groups
    z, xbc, dt = torch.split(x @ p["in_proj"], [din, din + 2 * G * N, heads],
                             dim=-1)
    xbc, new_conv = causal_conv1d(
        xbc, p["conv_w"], p["conv_b"],
        state=state["conv"] if state is not None else None, lengths=lengths)
    xbc = F.silu(xbc)
    xs, Bc, Cc = torch.split(xbc, [din, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, heads, hd)
    rep = heads // G
    Bh = Bc.reshape(B, S, G, N).repeat_interleave(rep, dim=2)  # (B,S,h,N)
    Ch = Cc.reshape(B, S, G, N).repeat_interleave(rep, dim=2)
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B,S,heads)
    dt = _pad_mask(dt, lengths, S)
    A = -torch.exp(p["A_log"])                            # (heads,)
    xf, Bf, Cf = xs.float(), Bh.float(), Ch.float()
    h0 = state["h"] if state is not None else x.new_zeros(
        (B, heads, hd, N), dtype=torch.float32)
    if S == 1:
        decay = torch.exp(dt[:, 0] * A)                   # (B,heads)
        inp = torch.einsum("bhd,bhn->bhdn", dt[:, 0, :, None] * xf[:, 0],
                           Bf[:, 0])
        h_last = decay[..., None, None] * h0 + inp
        y = torch.einsum("bhdn,bhn->bhd", h_last, Cf[:, 0])[:, None]
    else:
        h_last, y = _stream(_mamba2_checkpointed, h0, [dt, xf, Bf, Cf], A,
                            chunk)
    y = y + p["D"][:, None] * xf
    y = y.reshape(B, S, din) * F.silu(z.float())          # gated
    y = L.rmsnorm(y.to(x.dtype), p["norm_scale"], cfg.norm_eps)
    y = y @ p["out_proj"]
    new_state = None if state is None else {"conv": new_conv, "h": h_last}
    return y, new_state
