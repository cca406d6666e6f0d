"""Loss functions (f32 accumulation regardless of model compute dtype).
Port of ``repro/train/losses.py``: the classification loss, the
next-token LM loss and its chunked form, which never holds the whole
(B, S, V) logits.

Under tensor parallelism (``tp``: a mesh whose ``model`` axis splits
the vocabulary) the logits are this rank's block of the vocabulary, and
the cross-entropy is vocab-parallel (:func:`vocab_parallel_nll`): the
max, the sum of exponentials and the target's logit each combined over
the ranks, the gradient this rank's block of softmax minus one-hot.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C


class _VocabParallelNLL(torch.autograd.Function):
    """Per-position NLL from this rank's vocab block of the logits."""

    @staticmethod
    def forward(ctx, logits, labels, mesh):
        lf = logits.float()
        n = lf.shape[-1]
        m = C.all_reduce_max(lf.amax(dim=-1), mesh)
        e = torch.exp(lf - m[..., None])
        local = labels.long() - mesh.coords["model"] * n
        inside = (local >= 0) & (local < n)
        idx = torch.where(inside, local, 0)[..., None]
        # the target's logit less the max, from the rank that holds it
        t = (torch.gather(lf, -1, idx)[..., 0] - m).masked_fill(~inside, 0)
        both = C.all_reduce_sum(torch.stack([e.sum(dim=-1), t]), mesh,
                                "model")
        e /= both[0][..., None]                 # this block's softmax
        ctx.save_for_backward(e, idx, inside)
        ctx.dtype = logits.dtype
        return torch.log(both[0]) - both[1]

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx, -(g * inside)[..., None])
        return grad.to(ctx.dtype), None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, mesh
                       ) -> torch.Tensor:
    """NLL per position (f32, replicated over the ranks) of ``labels``
    (global vocabulary ids) under logits of which this rank of ``mesh``'s
    ``model`` axis holds the block ``[r * n, (r + 1) * n)`` of the
    vocabulary. Two collectives forward (a max, then one sum of the
    exponentials' sums and the target logits), none backward."""
    return _VocabParallelNLL.apply(logits, labels, mesh)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          tp=None) -> torch.Tensor:
    """Mean masked NLL. logits (..., V) any float dtype; labels (...) int;
    ``tp``: the logits are this rank's vocab block (vocab-parallel)."""
    if tp is not None:
        nll = vocab_parallel_nll(logits, labels, tp)
    else:
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
                v_c: torch.Tensor, tp=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the valid NLLs, count of valid targets) of one chunk:
    the vocab matmul in the model dtype, then f32 (``tp``: over this
    rank's vocab block, vocab-parallel)."""
    if tp is not None:
        logits = (C.copy_to_model(h_c, tp) @ w).float()
        nll = vocab_parallel_nll(logits, t_c, tp)
        return torch.sum(nll * v_c), torch.sum(v_c)
    logits = (h_c @ w).float()                          # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, t_c.long()[..., None])[..., 0]
    return torch.sum((logz - ll) * v_c), torch.sum(v_c)


def chunked_lm_loss(hidden: torch.Tensor, w: torch.Tensor,
                    tokens: torch.Tensor, *, chunk: int, tp=None
                    ) -> torch.Tensor:
    """Next-token loss WITHOUT materializing (B, S, V) logits.

    hidden (B, S, d) post-final-norm, aligned with tokens (B, S); w
    (d, V). The sequence is cut into chunks of ``chunk`` positions (the
    last padded, its pad counted out through ``valid``) and each chunk's
    vocab matmul and NLL run inside a non-reentrant
    ``torch.utils.checkpoint``, so only one (B, chunk, V) logits tile is
    live in the forward pass and in the backward pass. ``tp``: ``w`` is
    this rank's vocab block (columns); each tile's loss is
    vocab-parallel, its collectives replayed by the recompute on every
    rank in the same order.
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
                            valid[:, i:i + c], tp, use_reentrant=False)
        tot, n = tot + s, n + cnt
    return tot / torch.clamp(n, min=1.0)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
            prefix_len: int = 0, tp=None) -> torch.Tensor:
    """Next-token loss. logits (B, S, V) aligned with tokens (B, S):
    predict tokens[:, t+1] from logits[:, t]. ``prefix_len`` masks the
    first positions (a bidirectional prefix); ``tp``: vocab-parallel
    logits."""
    lg = logits[:, :-1]
    tg = tokens[:, 1:]
    mask = None
    if prefix_len:
        pos = torch.arange(lg.shape[1], device=lg.device)
        mask = (pos >= prefix_len).expand(tg.shape)
    return softmax_cross_entropy(lg, tg, mask, tp=tp)
