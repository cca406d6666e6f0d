"""Per-layer norm / trust-ratio telemetry (port of
``repro/core/grad_stats.py``).

The LARS paper's key diagnostic (and this paper's §3.2 argument) is that
||w||/||g|| varies wildly across layers. ``layer_stats`` computes that
table on the device; ``summarize`` reads it on the host in one copy.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import trust_ratio as tr
from repro_torch.treepath import (flatten_up_to, path_str,
                                  tree_flatten_with_path)

Pytree = Any


STATS = ("w_norm", "g_norm", "ratio_wg", "trust_ratio")


def layer_stats(params: Pytree, grads: Pytree, *,
                eta: float = 0.001, weight_decay: float = 1e-4,
                stacked: Optional[Pytree] = None
                ) -> dict[str, dict[str, torch.Tensor]]:
    """{layer_path: {w_norm, g_norm, ratio_wg, trust_ratio}} (per-slice for
    stacked leaves: entries are vectors of length L)."""
    flat_p, treedef = tree_flatten_with_path(params)
    flat_g = flatten_up_to(treedef, grads)
    flat_s = ([False] * len(flat_p) if stacked is None
              else [bool(s) for s in flatten_up_to(treedef, stacked)])
    out: dict[str, dict[str, torch.Tensor]] = {}
    for (path, w), g, s in zip(flat_p, flat_g, flat_s):
        w_norm, g_norm = tr.layer_norms(w, g, s)
        trust = tr.lars_trust_ratio(w_norm, g_norm, eta=eta,
                                    weight_decay=weight_decay)
        out[path_str(path)] = {
            "w_norm": w_norm,
            "g_norm": g_norm,
            "ratio_wg": w_norm / (g_norm + 1e-12),
            "trust_ratio": trust,
        }
    return out


def stats_hook(*, eta: float = 0.001, weight_decay: float = 1e-4):
    """A :class:`~repro_torch.train.pipeline.TrainPipeline` ``stats_fn``.

    The pipeline calls it on the pre-update params and the mean gradient
    of the global batch; the table stays on the device under
    ``metrics["stats"]`` until the consumer reads it. ``eta`` and
    ``weight_decay`` should match the optimizer under study so the
    logged trust ratios are the ratios LARS applies.
    """

    def fn(params: Pytree, grads: Pytree, stacked: Optional[Pytree]):
        return layer_stats(params, grads, eta=eta,
                           weight_decay=weight_decay, stacked=stacked)

    return fn


def summarize(stats: dict[str, dict[str, Any]]) -> dict[str, float]:
    """Compress a :func:`layer_stats` table to scalar telemetry: min/max/
    mean trust ratio across layer slices plus global weight/grad norms.

    One host read: the trust ratios and norms of every layer go to the
    host in a single copy, then everything is summed in f64 in the
    reference's order.
    """
    keys = ("trust_ratio", "w_norm", "g_norm")
    parts = [v[k].float().reshape(-1) for v in stats.values() for k in keys]
    host = torch.cat(parts).cpu().numpy().astype(np.float64)
    split = np.cumsum([p.numel() for p in parts])[:-1]
    per = np.split(host, split)
    trust = np.concatenate(per[0::3])
    w_sq = sum(float(np.sum(np.square(x))) for x in per[1::3])
    g_sq = sum(float(np.sum(np.square(x))) for x in per[2::3])
    return {
        "trust_min": float(trust.min()),
        "trust_max": float(trust.max()),
        "trust_mean": float(trust.mean()),
        "w_norm_global": float(np.sqrt(w_sq)),
        "g_norm_global": float(np.sqrt(g_sq)),
    }
