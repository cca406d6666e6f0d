"""Carry params and packed optimizer states between the JAX package and
the port, as numpy arrays.

The caller turns the JAX side into numpy (``jax.device_get`` /
``np.asarray``) and back; this module only sees numpy, so the port stays
free of JAX. Params are nested dicts in the reference's leaf layouts
(HWIO convs, ``(in, out)`` dense weights). Packed slot buffers have the
same ``(rows, 512)`` layout in both packages, so an optimizer state
carries across mid-run.

bfloat16 arrays (``ml_dtypes.bfloat16`` on the JAX side) arrive through
float32, which holds every bfloat16 value exactly; they leave as
float32 arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.optim_base import OptState
from repro_torch.core.packing import PackedLayout
from repro_torch.treepath import tree_map

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


def opt_state_to_torch(step: int, slots: dict, layout: PackedLayout,
                       device: torch.device | str = "cpu") -> OptState:
    """A packed state from the reference's step and slot buffers. The
    reference keeps the packed weights under the same ``WEIGHT_SLOT``
    name; ``layout`` is the port's layout of the same params."""
    out = {k: tensor_from_numpy(v, device) for k, v in slots.items()}
    for k, v in out.items():
        if tuple(v.shape) != layout.buffer_shape:
            raise ValueError(f"slot {k!r} has shape {tuple(v.shape)}, the "
                             f"layout wants {layout.buffer_shape}")
    return OptState(step=int(step), slots=out, layout=layout)


def opt_state_to_numpy(state: OptState) -> tuple[int, dict]:
    return state.step, {k: tensor_to_numpy(v)
                        for k, v in state.slots.items()}
