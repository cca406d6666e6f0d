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
this rank's slice backward). The serving mesh adds :func:`broadcast_scalar`
(rank 0's clock to every rank), :func:`merge_stripes` (decode attention
over a sequence split into stripes, merged by each stripe's log-sum-exp)
and :func:`gather_vocab` / :func:`argmax_vocab` (sampling from logits
split over the vocabulary). ``all_reduce_sum``, ``all_reduce_max``,
``all_gather_rows`` and the merge take an axis name or the pair
``("data", "model")`` (a dim split over both).

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
MOVED = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
         "broadcast": 0}


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


def all_reduce_sum(x: torch.Tensor, mesh, axis="data") -> torch.Tensor:
    """Sum ``x`` over the axis (a name or a tuple of names), in place;
    returns ``x``."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    _moved("all_reduce", x)
    dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """The elementwise max of ``x`` over the axis (a name or a tuple of
    names), in place; returns ``x``."""
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


def all_gather_rows(x: torch.Tensor, mesh, axis="data") -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0 in coordinate order
    (over a tuple of axes: row-major, the ranks' order in the mesh)."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    size = dist.get_world_size(group)
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


# ------------------------------------------------------- the serving mesh

def _host_values(values: list, dtype, mesh, group) -> torch.Tensor:
    """A few host values as a tensor for a collective over ``group``: on
    the host for gloo, on the rank's device for NCCL (which takes CUDA
    tensors only)."""
    dev = mesh.device if dist.get_backend(group) == "nccl" else "cpu"
    return torch.tensor(values, dtype=dtype, device=dev)


def broadcast_scalar(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank of the mesh (one f64 broadcast;
    the value itself on a mesh of one rank). Every rank calls it at the
    same point: the serving engine's clock, so that every rank's
    scheduler decides from the same time."""
    group = None if mesh is None else mesh.group(("data", "model"))
    if group is None:
        return value
    x = _host_values([value], torch.float64, mesh, group)
    _moved("broadcast", x)
    dist.broadcast(x, src=0, group=group)
    return float(x.item())


def all_agree(value: int, mesh) -> bool:
    """Whether every rank of the mesh holds the same integer ``value``
    (|value| < 2^63): one all-reduce of (value, -value) by max. True on
    a mesh of one rank."""
    group = None if mesh is None else mesh.group(("data", "model"))
    if group is None:
        return True
    x = _host_values([value, -value], torch.int64, mesh, group)
    all_reduce_max(x, mesh, ("data", "model"))
    return int(x[0]) == -int(x[1]) == value


def merge_stripes(out: torch.Tensor, lse: torch.Tensor, mesh, axis
                  ) -> torch.Tensor:
    """Decode attention over a sequence split into stripes over ``axis``
    (a name or a tuple of names: the ranks' order along it is the
    stripes'), from this rank's stripe's ``(out, lse)``
    (``flash_decode(..., lse=True)``: out (..., D) f32, lse (...) f32,
    -inf where the stripe holds no key of the row). ONE all-gather of
    every rank's (out, lse) side by side, then each rank merges them in
    stripe order (:func:`repro_torch.kernels.flash_decode.merge_stripes`:
    each stripe weighted by exp(lse - max lse), 0 where it is empty), in
    f32: every rank computes the same result from the same bits."""
    from repro_torch.kernels.flash_decode import merge_stripes as merge
    both = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
    every = all_gather_rows(both[None].contiguous(), mesh, axis)
    return merge(list(every[..., :-1]), list(every[..., -1]))


def gather_vocab(logits: torch.Tensor, mesh) -> torch.Tensor:
    """Logits (..., V / ranks) split over ``model`` by blocks of the
    vocabulary -> the whole rows (..., V), on every rank."""
    return all_gather_dim(logits.contiguous(), mesh, -1, "model")


def argmax_vocab(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The argmax over the whole vocabulary of logits (B, V / ranks)
    split over ``model`` by blocks, int32 (B,), without gathering the
    rows: each rank's block max and its index, gathered (B, 2 x ranks
    floats), and the first block holding the largest value wins — the
    first occurrence of the maximum, as ``torch.argmax`` of the whole
    row takes it."""
    n = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = logits.float().gather(-1, idx[:, None])[:, 0]
    idx = idx + mesh.coords["model"] * n
    both = all_gather_dim(torch.stack([val, idx.float()], dim=-1)[:, None],
                          mesh, 1, "model")                # (B, ranks, 2)
    best = both[..., 0].argmax(dim=-1, keepdim=True)
    return both[..., 1].gather(1, best)[:, 0].to(torch.int32)

