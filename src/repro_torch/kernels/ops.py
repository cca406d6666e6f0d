"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``):
the whole-pytree packed LARS phases ``lars_norms_packed``,
``lars_apply_packed`` and, for int8 momentum, ``lars_apply_packed_q8``
over the superbuffer of :mod:`repro_torch.core.packing` — one kernel
launch each per optimizer step, whatever the leaf count —;
``flash_decode``, the ``(B, H, D)`` front end of the decode-attention
kernel; and ``check_use_kernels``, the placement check behind LARS's
``use_kernels`` and the decode path's ``use_flash`` options. The JAX
package's per-leaf LARS adapters are not ported: nothing in the port
calls them.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import lars_kernels


def check_use_kernels(mode: bool | str, device: torch.device, *,
                      option: str = "use_kernels") -> None:
    """Raise unless buffers on ``device`` fit the mode of ``option``.

    The wrappers choose by the buffers' device: the CUDA kernels on CUDA
    tensors, their plain versions on CPU tensors. ``"auto"`` takes
    either; ``True`` asks for the kernels, so it needs CUDA buffers;
    ``False`` asks for the plain path, so it needs CPU buffers.
    """
    if mode not in ("auto", True, False):
        raise ValueError(f"{option} must be 'auto', True or False, "
                         f"got {mode!r}")
    on_cuda = torch.device(device).type == "cuda"
    if mode is True and not on_cuda:
        raise ValueError(f"{option}=True needs CUDA buffers, got "
                         f"{device}; use 'auto' on the CPU")
    if mode is False and on_cuda:
        raise ValueError(f"{option}=False needs CPU buffers, got "
                         f"{device}: on the card the kernels run")


# ------------------------------------------------------------ packed kernels

def lars_norms_packed(layout: packing.PackedLayout, wbuf: torch.Tensor,
                      gbuf: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint per-layer-slice (||w||, ||g||) over the whole superbuffer:
    ONE norms_flat launch (per-row partial sums), then a fixed-order
    fold of the rows into slices. Two (num_slices,) f32 vectors."""
    wsq_rows, gsq_rows = lars_kernels.norms_flat(wbuf, gbuf, block_rows=1)
    return (torch.sqrt(packing.fold_rows(layout, wsq_rows)),
            torch.sqrt(packing.fold_rows(layout, gsq_rows)))


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


def lars_apply_packed_q8(layout: packing.PackedLayout, wbuf: torch.Tensor,
                         gbuf: torch.Tensor, q_m: torch.Tensor,
                         m_scale: torch.Tensor, lr_slices: torch.Tensor, *,
                         momentum: float, weight_decay: float
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """``lars_apply_packed`` with int8 momentum codes + per-block scales:
    dequantize, update and requantize in the ONE apply launch. Returns
    (w_new, q_new, scale_new)."""
    lr_blocks = packing.blocks_expand(layout, lr_slices.float())
    return lars_kernels.apply_flat_q8(
        wbuf, gbuf, q_m, m_scale, lr_blocks, momentum=momentum,
        weight_decay=weight_decay, block_rows=layout.block_rows)


# ------------------------------------------------------------ flash decode

def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float | None = None
                 ) -> torch.Tensor:
    """Single-token decode attention. q (B, H, D); k/v (B, S, Hkv, D);
    lengths (B,) int. Returns (B, H, D) in q.dtype. ONE launch.

    The reference pads the whole cache to its block size whenever S is
    not a multiple of it; the kernel takes any S and reads only the
    ``min(lengths[b], S)`` valid rows, so nothing is copied here.
    """
    B, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out4 = fd.flash_decode(q.reshape(B, Hkv, H // Hkv, D), k, v,
                           lengths.to(torch.int32), scale=scale)
    return out4.reshape(B, H, D)
