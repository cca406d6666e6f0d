"""Plain-PyTorch oracles of the kernel semantics (port of
``repro/kernels/ref.py``): the per-leaf LARS norms and apply, the ground
truth the packed kernels and their adapters in
:mod:`repro_torch.kernels.ops` are held against, and single-token decode
attention, the plain version of the ``flash_decode`` kernel."""

from __future__ import annotations

import torch


def lars_norms(w: torch.Tensor, g: torch.Tensor, *, stacked: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint (||w||, ||g||) in f32; per leading slice when stacked."""
    axes = tuple(range(1, w.ndim)) if stacked else tuple(range(w.ndim))
    wf, gf = w.float(), g.float()
    return (torch.sqrt(torch.sum(torch.square(wf), dim=axes)),
            torch.sqrt(torch.sum(torch.square(gf), dim=axes)))


def lars_apply(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
               local_lr, momentum: float, weight_decay: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """m_new = momentum*m + local_lr*(g + wd*w);  w_new = w - m_new.
    ``local_lr`` is a scalar, or a (L,) vector broadcast against a stacked
    (L, ...) leaf."""
    wf, gf = w.float(), g.float()
    lr = torch.as_tensor(local_lr, dtype=torch.float32, device=w.device)
    if lr.ndim > 0 and lr.ndim != wf.ndim:
        lr = lr.reshape(lr.shape + (1,) * (wf.ndim - lr.ndim))
    m_new = momentum * m.float() + lr * (gf + weight_decay * wf)
    return (wf - m_new).to(w.dtype), m_new


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float | None = None
                 ) -> torch.Tensor:
    """Single-token decode attention with per-sequence valid lengths.

    q: (B, H, D); k/v: (B, S, Hkv, D); lengths: (B,) int — positions
    >= length are masked (a length past S masks nothing, a length of 0
    everything: that row gives zeros). GQA: H = G * Hkv. Returns
    (B, H, D) in q.dtype; scores and softmax in f32.
    """
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) * scale
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = pos < lengths.to(q.device)[:, None, None, None]
    p = _softmax(torch.where(mask, scores, -torch.inf))
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    m = torch.amax(x, dim=-1, keepdim=True)
    # guard fully-masked rows (all -inf): exp(-inf - -inf) -> nan; shift by 0
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(x - m)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
