"""Public wrappers around the LARS kernels (port of
``repro/kernels/ops.py``, LARS part): the whole-pytree packed phases
``lars_norms_packed`` and ``lars_apply_packed`` over the superbuffer of
:mod:`repro_torch.core.packing` — one kernel launch each per optimizer
step, whatever the leaf count — and ``check_use_kernels``, the check
behind LARS's ``use_kernels`` option. The JAX package's per-leaf adapters are not
ported: nothing in the port calls them.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import lars_kernels


def check_use_kernels(mode: bool | str, device: torch.device) -> None:
    """Raise unless buffers on ``device`` fit the ``use_kernels`` mode.

    The wrappers choose by the buffers' device: the CUDA kernels on CUDA
    tensors, their plain versions on CPU tensors. ``"auto"`` takes
    either; ``True`` asks for the kernels, so it needs CUDA buffers;
    ``False`` asks for the plain versions, so it needs CPU buffers.
    """
    if mode not in ("auto", True, False):
        raise ValueError(f"use_kernels must be 'auto', True or False, "
                         f"got {mode!r}")
    on_cuda = torch.device(device).type == "cuda"
    if mode is True and not on_cuda:
        raise ValueError(f"use_kernels=True needs CUDA buffers, got "
                         f"{device}; use 'auto' on the CPU")
    if mode is False and on_cuda:
        raise ValueError(f"use_kernels=False needs CPU buffers, got "
                         f"{device}: on the card LARS runs the kernels")


# ------------------------------------------------------------ packed kernels

def lars_norms_packed(layout: packing.PackedLayout, wbuf: torch.Tensor,
                      gbuf: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint per-layer-slice (||w||, ||g||) over the whole superbuffer:
    ONE norms_flat launch (per-block partial sums), then a fixed-order
    fold of the blocks into slices. Two (num_slices,) f32 vectors."""
    wsq_blk, gsq_blk = lars_kernels.norms_flat(
        wbuf, gbuf, block_rows=layout.block_rows)
    return (torch.sqrt(packing.fold_blocks(layout, wsq_blk)),
            torch.sqrt(packing.fold_blocks(layout, gsq_blk)))


def lars_apply_packed(layout: packing.PackedLayout, wbuf: torch.Tensor,
                      gbuf: torch.Tensor, mbuf: torch.Tensor,
                      lr_slices: torch.Tensor, *, momentum: float,
                      weight_decay: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused m' = mu*m + lr_l*(g + beta*w); w' = w - m' over the whole
    superbuffer. lr_slices: (num_slices,) per-layer local LR. ONE launch.
    """
    lr_blocks = packing.blocks_expand(layout, lr_slices.float())
    return lars_kernels.apply_flat(
        wbuf, gbuf, mbuf, lr_blocks, momentum=momentum,
        weight_decay=weight_decay, block_rows=layout.block_rows)
