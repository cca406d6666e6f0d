"""Loss functions (f32 accumulation regardless of model compute dtype).
Port of ``repro/train/losses.py``: the classification loss, the
next-token LM loss and its chunked form, which never holds the whole
(B, S, V) logits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean masked NLL. logits (..., V) any float dtype; labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """The paper's loss: softmax cross-entropy on the class head."""
    return softmax_cross_entropy(logits, labels)


def _loss_piece(h_c: torch.Tensor, w: torch.Tensor, t_c: torch.Tensor,
                v_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the valid NLLs, count of valid targets) of one chunk:
    the vocab matmul in the model dtype, then f32."""
    logits = (h_c @ w).float()                          # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, t_c.long()[..., None])[..., 0]
    return torch.sum((logz - ll) * v_c), torch.sum(v_c)


def chunked_lm_loss(hidden: torch.Tensor, w: torch.Tensor,
                    tokens: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Next-token loss WITHOUT materializing (B, S, V) logits.

    hidden (B, S, d) post-final-norm, aligned with tokens (B, S); w
    (d, V). The sequence is cut into chunks of ``chunk`` positions (the
    last padded, its pad counted out through ``valid``) and each chunk's
    vocab matmul and NLL run inside a non-reentrant
    ``torch.utils.checkpoint``, so only one (B, chunk, V) logits tile is
    live in the forward pass and in the backward pass.
    """
    hs = hidden[:, :-1]
    tg = tokens[:, 1:]
    valid = torch.ones(tg.shape, dtype=torch.float32, device=tg.device)
    Sm = hs.shape[1]
    c = min(chunk, Sm)
    pad = (-Sm) % c
    if pad:
        hs = F.pad(hs, (0, 0, 0, pad))
        tg = F.pad(tg, (0, pad))
        valid = F.pad(valid, (0, pad))
    tot = n = torch.zeros((), device=hidden.device)
    for i in range(0, Sm + pad, c):
        s, cnt = checkpoint(_loss_piece, hs[:, i:i + c], w, tg[:, i:i + c],
                            valid[:, i:i + c], use_reentrant=False)
        tot, n = tot + s, n + cnt
    return tot / torch.clamp(n, min=1.0)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
            prefix_len: int = 0) -> torch.Tensor:
    """Next-token loss. logits (B, S, V) aligned with tokens (B, S):
    predict tokens[:, t+1] from logits[:, t]. ``prefix_len`` masks the
    first positions (a bidirectional prefix)."""
    lg = logits[:, :-1]
    tg = tokens[:, 1:]
    mask = None
    if prefix_len:
        pos = torch.arange(lg.shape[1], device=lg.device)
        mask = (pos >= prefix_len).expand(tg.shape)
    return softmax_cross_entropy(lg, tg, mask)
