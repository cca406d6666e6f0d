"""Dense MLP sub-block (gated SiLU/GELU or plain). Port of
``repro/models/mlp.py``."""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L


def init_mlp(gen: torch.Generator, cfg, d: int, ff: int,
             dtype: torch.dtype, device) -> dict:
    p = {"wi": L.dense_init(gen, d, ff, dtype, device),
         "wo": L.dense_init(gen, ff, d, dtype, device)}
    if L.gated(cfg):
        p["wg"] = L.dense_init(gen, d, ff, dtype, device)
    return p


def mlp_block(cfg, p: dict, x: torch.Tensor, tp=None, ff=None,
              reduce: bool = True) -> torch.Tensor:
    """``tp``: a tensor-parallel mesh. Where its ``model`` axis splits
    the hidden width (``wi``/``wg`` by columns, ``wo`` by rows: ``wo``
    holds fewer rows than the whole width ``ff``, ``cfg.d_ff`` by
    default; a shared expert's is ``moe_d_ff * num_shared_experts``) the
    block runs between ``copy_to_model`` and ``reduce_from_model``: this
    rank's block of the hidden units, the ranks' partial outputs summed
    (Megatron's MLP); with ``reduce=False`` the partial output, for the
    caller to sum. A leaf the split left whole is computed whole."""
    split = tp is not None and p["wo"].shape[0] != (cfg.d_ff if ff is None
                                                    else ff)
    if split:
        x = C.copy_to_model(x, tp)
    act = L.act_fn(cfg)
    h = x @ p["wi"]
    if "wg" in p:
        h = act(x @ p["wg"]) * h
    else:
        h = act(h)
    y = h @ p["wo"]
    return C.reduce_from_model(y, tp) if split and reduce else y
