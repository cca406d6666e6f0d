"""Plain-PyTorch oracles of the per-leaf LARS kernel semantics (port of
``repro/kernels/ref.py``, LARS part): the ground truth the packed
kernels and their adapters in :mod:`repro_torch.kernels.ops` are held
against."""

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
