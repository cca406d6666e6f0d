"""Carry params, packed optimizer states and decode caches (K/V, the
encoder-decoder's K/V with its cross-attention K/V, latent, or SSM and
hybrid recurrent states) between the JAX package and the port, as numpy
arrays.

The caller turns the JAX side into numpy (``jax.device_get`` /
``np.asarray``) and back; this module only sees numpy, so the port stays
free of JAX. Params are nested dicts in the reference's leaf layouts
(HWIO convs, ``(in, out)`` dense weights). Packed slot buffers have the
same ``(rows, 512)`` layout in both packages — f32, bf16-policy master,
and int8 states alike — and tree-layout slots the same trees (f32 leaves
or int8 codes, per-leaf scales, the f32 master tree), so an optimizer
state carries across mid-run.

bfloat16 arrays (``ml_dtypes.bfloat16`` on the JAX side) arrive through
float32, which holds every bfloat16 value exactly; they leave as
float32 arrays.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.optim_base import SCALE_SUFFIX, OptState
from repro_torch.core.packing import PackedLayout
from repro_torch.treepath import tree_flatten_with_path, tree_map

Pytree = Any


def tensor_from_numpy(a, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_torch(params: Pytree, device: torch.device | str = "cpu"
                    ) -> Pytree:
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), params)


def params_to_numpy(params: Pytree) -> Pytree:
    return tree_map(tensor_to_numpy, params)


def opt_state_to_torch(step: int, slots: dict,
                       layout: Optional[PackedLayout],
                       device: torch.device | str = "cpu") -> OptState:
    """An optimizer state from the reference's step and slots. The slot
    names are the reference's (``WEIGHT_SLOT`` or ``MASTER_SLOT``, the
    rule slots, and a ``<slot>_scale`` beside each int8 code slot).

    ``layout`` is the port's layout of the same params for a packed
    state: code slots stay int8, scale slots are ``(num_blocks, 1)`` f32
    and every other slot is a ``buffer_shape`` buffer. ``None`` takes a
    tree state: every slot is a nested dict of arrays with the same leaf
    paths (int8 codes stay int8)."""
    if layout is None:
        out = {k: tree_map(lambda a: tensor_from_numpy(a, device), v)
               for k, v in slots.items()}
        paths = {k: tree_flatten_with_path(v)[1] for k, v in out.items()}
        if len(set(paths.values())) > 1:
            raise ValueError(f"the slot trees {sorted(out)} differ in "
                             "their leaf paths")
        return OptState(step=int(step), slots=out)
    out = {k: tensor_from_numpy(v, device) for k, v in slots.items()}
    for k, v in out.items():
        want = (layout.num_blocks, 1) if k.endswith(SCALE_SUFFIX) \
            else layout.buffer_shape
        if tuple(v.shape) != want:
            raise ValueError(f"slot {k!r} has shape {tuple(v.shape)}, the "
                             f"layout wants {want}")
    return OptState(step=int(step), slots=out, layout=layout)


def opt_state_to_numpy(state: OptState) -> tuple[int, dict]:
    """(step, slots as numpy): buffers, or nested dicts for a tree state."""
    return state.step, {k: tree_map(tensor_to_numpy, v)
                        for k, v in state.slots.items()}


def lm_params_to_torch(params: Pytree, model,
                       device: torch.device | str = "cpu") -> Pytree:
    """An LM's or an encoder-decoder's params (the reference's nested
    dict of numpy arrays: stacked ``(L, ...)`` layer leaves, ``(in,
    out)`` dense weights) as the port's tree on ``device``. Every leaf's path and shape is
    checked against the port's own ``model.init`` (drawn on the meta
    device, so nothing is computed)."""
    got = params_to_torch(params, device)
    want = model.init(torch.Generator().manual_seed(0), "meta")
    got_leaves, got_def = tree_flatten_with_path(got)
    want_leaves, want_def = tree_flatten_with_path(want)
    if got_def != want_def:
        raise ValueError(f"param paths differ from the port's init: "
                         f"missing {sorted(set(want_def) - set(got_def))}, "
                         f"extra {sorted(set(got_def) - set(want_def))}")
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        if g.shape != w.shape:
            raise ValueError(f"param {'/'.join(path)} has shape "
                             f"{tuple(g.shape)}, the port's init "
                             f"{tuple(w.shape)}")
    return got


CACHE_LEAVES = ({"pos", "k", "v"}, {"pos", "k", "v", "xk", "xv"},
                {"pos", "ckv", "krope"}, {"pos", "conv", "h"},
                {"pos", "conv", "h", "attn_k", "attn_v"})


def cache_to_torch(cache: dict, device: torch.device | str = "cpu"
                   ) -> dict:
    """A decode cache from the reference, as tensors on ``device``:
    ``pos`` (B,) int32 and ``k``/``v`` (L, B, S, Hkv, hd) (and the
    encoder-decoder's ``xk``/``xv`` (L, B, S_enc, Hkv, hd)), MLA's ``ckv``
    (L, B, S, r) and ``krope`` (L, B, S, rope), the SSM family's
    ``conv`` (L, B, K-1, C) and f32 ``h``, or the hybrid's ``conv``,
    ``h`` and ``attn_k``/``attn_v`` (A, B, S, Hkv, hd)."""
    if set(cache) not in CACHE_LEAVES:
        raise ValueError(f"expected a decode cache with the leaves of one "
                         f"of {[sorted(c) for c in CACHE_LEAVES]}, got "
                         f"{sorted(cache)}")
    out = {k: tensor_from_numpy(v, device) for k, v in cache.items()}
    out["pos"] = out["pos"].to(torch.int32)
    return out


def cache_to_numpy(cache: dict) -> dict:
    return {k: tensor_to_numpy(v) for k, v in cache.items()}
