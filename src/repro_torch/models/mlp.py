"""Dense MLP sub-block (gated SiLU/GELU or plain). Port of
``repro/models/mlp.py``."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def init_mlp(gen: torch.Generator, cfg, d: int, ff: int,
             dtype: torch.dtype, device) -> dict:
    p = {"wi": L.dense_init(gen, d, ff, dtype, device),
         "wo": L.dense_init(gen, ff, d, dtype, device)}
    if L.gated(cfg):
        p["wg"] = L.dense_init(gen, d, ff, dtype, device)
    return p


def mlp_block(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = L.act_fn(cfg)
    h = x @ p["wi"]
    if "wg" in p:
        h = act(x @ p["wg"]) * h
    else:
        h = act(h)
    return h @ p["wo"]
