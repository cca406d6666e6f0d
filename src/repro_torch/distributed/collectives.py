"""The collectives of a data- and tensor-parallel step, over a mesh
axis's process group: the gradient reduction (``all_reduce_sum``, or for
ZeRO ``reduce_scatter_rows`` into this rank's row shard), the per-step
all-gather of the updated weight rows and of the norm partials
(``all_gather_rows``), ``all_reduce_max`` and ``barrier``; and over the
``model`` axis, the all-gather of a leaf along any dim
(``all_gather_dim``) and Megatron's conjugate pair as autograd
functions: :func:`copy_to_model` (identity forward, all-reduce backward),
:func:`reduce_from_model` (all-reduce forward, identity backward) and
:func:`gather_from_model` (all-gather forward, the sum over the ranks of
this rank's slice backward).

Over an axis of one rank every collective is the identity and sends
nothing. NCCL and gloo take CPU or CUDA tensors as their backends do,
with one exception: gloo's CUDA support covers ``broadcast`` and
``all_reduce`` only, so an all-gather or a reduce-scatter of CUDA
tensors over gloo goes through host staging: each call copies its input
into pinned host memory, runs the gloo collective there and copies the
result back to the device. That is a transport, used where two ranks
share one card (NCCL refuses two ranks on one device); the compute stays
on the card. The staged calls, their copies and bytes are counted in
:data:`STAGED`; the bytes each rank hands to every collective (its input
tensor's) in :data:`MOVED`, by kind.

The autograd functions keep the mesh they were called with, so a
backward pass on the autograd engine's own thread (CUDA tensors) sends
over the same group without reading the ambient mesh. Every rank of the
axis calls them in the same order: forward, a checkpoint's recompute
and backward run the same graph on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# host-staged gloo collectives of CUDA tensors since the last reset
STAGED = {"calls": 0, "copies": 0, "bytes": 0}
# bytes of the input of each collective this rank joined, by kind
MOVED = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def reset_counts() -> None:
    for counts in (STAGED, MOVED):
        for k in counts:
            counts[k] = 0


def _moved(kind: str, x: torch.Tensor) -> None:
    MOVED[kind] += x.numel() * x.element_size()


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
    _moved("all_reduce", x)
    dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, mesh, axis: str = "model"
                   ) -> torch.Tensor:
    """The elementwise max of ``x`` over the axis, in place; returns
    ``x``."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    _moved("all_reduce", x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
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
    _moved("reduce_scatter", x)
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
    _moved("all_gather", x)
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


def all_gather_dim(x: torch.Tensor, mesh, dim: int, axis: str = "model"
                   ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in coordinate order
    (one all-gather: dim 0 of the moved tensor)."""
    if mesh is None or mesh.group(axis) is None:
        return x
    dim = dim % x.ndim
    if dim == 0:
        return all_gather_rows(x, mesh, axis)
    return all_gather_rows(x.movedim(dim, 0), mesh, axis).movedim(0, dim)


def split_dim(x: torch.Tensor, mesh, dim: int, axis: str = "model"
              ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // mesh.shape[axis]
    return x.narrow(dim, mesh.coords[axis] * n, n)


# ------------------------------------------- tensor parallelism (Megatron)

def model_parallel(mesh):
    """``mesh`` where its ``model`` axis has more than one rank (the
    models' tensor-parallel context), else None."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.contiguous()
        if y is x:                  # a product's output, summed in place
            ctx.mark_dirty(x)
        return all_reduce_sum(y, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather_dim(x, mesh, dim, "model")

    @staticmethod
    def backward(ctx, g):
        # the whole leaf's gradient is the sum of the ranks' partial
        # gradients, of which this rank keeps its block
        g = reduce_scatter_rows(g.movedim(ctx.dim, 0).contiguous(),
                                ctx.mesh, "model")
        return g.movedim(0, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Where a replicated tensor enters the ranks' split computation:
    the identity, and in backward the sum of the ranks' partial
    gradients. The identity without a tensor-parallel mesh."""
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ranks' partial results (row-parallel products, the
    vocab-parallel lookup), replicated; the identity in backward."""
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A leaf split over ``model`` along ``dim`` made whole for a product
    inside the split computation; backward keeps this rank's block of the
    summed gradient."""
    return x if mesh is None else _GatherFromModel.apply(x, mesh, dim)
