"""The collectives of a data-parallel step, over a mesh axis's process
group: the gradient reduction (``all_reduce_sum``, or for ZeRO
``reduce_scatter_rows`` into this rank's row shard), the per-step
all-gather of the updated weight rows and of the norm partials
(``all_gather_rows``), and ``barrier``.

Over an axis of one rank every collective is the identity and sends
nothing. NCCL and gloo take CPU or CUDA tensors as their backends do,
with one exception: gloo's CUDA support covers ``broadcast`` and
``all_reduce`` only, so an all-gather or a reduce-scatter of CUDA
tensors over gloo goes through host staging: each call copies its input
into pinned host memory, runs the gloo collective there and copies the
result back to the device. That is a transport, used where two ranks
share one card (NCCL refuses two ranks on one device); the compute stays
on the card. The staged calls, their copies and bytes are counted in
:data:`STAGED`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# host-staged gloo collectives of CUDA tensors since the last reset
STAGED = {"calls": 0, "copies": 0, "bytes": 0}


def reset_counts() -> None:
    for k in STAGED:
        STAGED[k] = 0


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    STAGED["copies"] += 1
    STAGED["bytes"] += x.numel() * x.element_size()
    return h


def _to_device(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    STAGED["copies"] += 1
    STAGED["bytes"] += h.numel() * h.element_size()
    return h.to(device)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str = "data"
                   ) -> torch.Tensor:
    """Sum ``x`` over the axis, in place; returns ``x``."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    dist.all_reduce(x, group=group)
    return x


def reduce_scatter_rows(x: torch.Tensor, mesh, axis: str = "data"
                        ) -> torch.Tensor:
    """Sum ``x`` over the axis and keep this rank's block of dim 0: rows
    ``[i * n / size, (i + 1) * n / size)`` for the rank at coordinate
    ``i``. A new tensor (``x`` itself over an axis of one rank)."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    size = mesh.shape[axis]
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} "
                         f"ranks of {axis!r}")
    x = x.contiguous()
    shape = (x.shape[0] // size,) + tuple(x.shape[1:])
    if _staged(x, group):
        STAGED["calls"] += 1
        out = torch.empty(shape, dtype=x.dtype)
        dist.reduce_scatter_tensor(out, _to_host(x), group=group)
        return _to_device(out, x.device)
    out = x.new_empty(shape)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_gather_rows(x: torch.Tensor, mesh, axis: str = "data"
                    ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0 in coordinate order."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    size = mesh.shape[axis]
    x = x.contiguous()
    shape = (x.shape[0] * size,) + tuple(x.shape[1:])
    if _staged(x, group):
        STAGED["calls"] += 1
        out = torch.empty(shape, dtype=x.dtype)
        dist.all_gather_into_tensor(out, _to_host(x), group=group)
        return _to_device(out, x.device)
    out = x.new_empty(shape)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def barrier(mesh, axis: str = "data") -> None:
    group = None if mesh is None else mesh.group(axis)
    if group is not None:
        dist.barrier(group=group)
