"""Flat-packed layer-wise substrate: one superbuffer for the whole pytree.

Port of ``repro/core/packing.py``. The layout is the reference's to the
byte: the same segment table, the same ``(total_rows, LANE)`` f32
superbuffer, the same zero padding of every layer slice to whole
``BLOCK_ROWS`` row blocks, the same leaf order (dict keys sorted, as
``jax.tree_util`` flattens them), and for a ZeRO layout (``shards > 1``)
the same all-zero pad rows at the tail. Packed buffers and slot states
therefore carry between the two packages unchanged.

ZeRO row shards. Under an ambient data-parallel mesh whose ``data`` axis
has ``layout.shards`` ranks, a slot buffer of a ZeRO layout holds only
this rank's rows: the block ``[i * n, (i + 1) * n)`` with ``n =
total_rows / shards`` for the rank at data coordinate ``i``
(:func:`shard_span`). Every shard boundary lies on a row-block boundary,
so the per-block int8 scales split with the rows. :func:`constrain_rows`
cuts a whole buffer to this rank's rows, :func:`gather_rows` all-gathers
a row shard back to the whole buffer (the step's one weight gather),
and the per-slice reductions take a row shard's per-row (or per-block)
partials, all-gather them and fold the whole vector, so a sharded run's
trust ratios are bit-identical to an unsharded one's. Without a mesh a
ZeRO layout is a padded whole buffer, updated whole.

Per-slice reductions sum each row block (or each row, as the CUDA
``norms_flat`` does), then fold the partials into slices through a
static ``(num_slices, max_partials)`` gather and a row sum. Slices are
contiguous, so that is a sorted-segment reduction with a fixed order:
deterministic on the card, where ``index_add_`` would use atomics and
change its summation order from run to run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.constrain import current_mesh
from repro_torch.treepath import (TreeDef, flatten_up_to, path_str,
                                  tree_flatten_with_path, tree_unflatten)

Pytree = Any

LANE = 512        # superbuffer column count
BLOCK_ROWS = 8    # rows per kernel block; slices are block-aligned

# Reserved OptState slot name for the f32 master-weight copy kept by the
# bf16 precision policy. The master IS the (rows, lane) superbuffer: the
# optimizer reads and writes it, and the params are its storage-dtype
# view.
MASTER_SLOT = "master"

# Reserved OptState slot name for the persistent packed weight buffer
# kept under the f32 precision policy: the weights live packed across
# steps so the per-step params pack disappears. The buffer is rounded
# through each segment's storage dtype after every update
# (``round_to_storage_``), so the trajectory equals repacking the
# storage-dtype params every step.
WEIGHT_SLOT = "packed_weights"
# rows ``round_to_storage_`` rounds at once (128 MiB of f32 at lane 512)
ROUND_CHUNK_ROWS = 1 << 16


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32" (the JAX package's dtype names)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class Segment:
    """Static placement of one parameter leaf in the superbuffer."""

    name: str                   # "/"-joined key path
    shape: tuple[int, ...]      # original leaf shape
    dtype: str                  # original leaf dtype name
    stacked: bool               # leading axis is a layer stack
    layers: int                 # number of layer slices (1 if unstacked)
    rows: int                   # padded rows per slice (multiple of BLOCK_ROWS)
    n: int                      # true elements per slice (before padding)
    row_offset: int             # first superbuffer row of slice 0
    slice_offset: int           # id of slice 0 in per-slice vectors
    adapt: bool                 # slice rank > 1 -> trust ratio applies


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static description of a whole-pytree superbuffer packing.

    ``shards > 1`` marks a ZeRO row-sharded layout: ``total_rows`` is
    padded up to a multiple of ``shards * block_rows`` (``pad_rows``
    all-zero rows at the tail), so the buffer splits evenly over the
    mesh's ``data`` axis with every shard boundary on a block boundary.
    The pad rows belong to no slice: reductions drop them, and every
    buffer keeps them exactly zero (int8 pad blocks: code 0, scale 1).
    """

    segments: tuple[Segment, ...]
    treedef: TreeDef            # leaf key paths, in flatten order
    lane: int
    block_rows: int
    total_rows: int
    num_slices: int
    shards: int = 1             # ZeRO row-shard count (1 = replicated)
    pad_rows: int = 0           # all-zero tail rows padding to shards

    @property
    def buffer_shape(self) -> tuple[int, int]:
        return (self.total_rows, self.lane)

    @property
    def num_blocks(self) -> int:
        return self.total_rows // self.block_rows

    @property
    def base_rows(self) -> int:
        """Rows holding real data (the shards=1 layout's total_rows)."""
        return self.total_rows - self.pad_rows

    @property
    def shard_rows(self) -> int:
        """Rows of one ZeRO row shard."""
        return self.total_rows // self.shards

    def stacked_flags(self) -> tuple[bool, ...]:
        return tuple(s.stacked for s in self.segments)


@functools.lru_cache(maxsize=64)
def _build_layout_static(treedef: TreeDef,
                         shapes: tuple[tuple[int, ...], ...],
                         dtypes: tuple[str, ...],
                         stacked: tuple[bool, ...],
                         lane: int, block_rows: int,
                         shards: int) -> PackedLayout:
    segments = []
    row_offset = 0
    slice_offset = 0
    per_block = lane * block_rows
    for path, shape, dtype, stk in zip(treedef, shapes, dtypes, stacked):
        name = path_str(path)
        size = math.prod(shape)
        if stk and not shape:
            raise ValueError(f"scalar leaf {name!r} cannot be stacked")
        layers = shape[0] if stk else 1
        if layers == 0:
            raise ValueError(f"empty layer stack for leaf {name!r}")
        n = size // layers
        rows = max(1, math.ceil(n / per_block)) * block_rows
        segments.append(Segment(
            name=name, shape=shape, dtype=dtype, stacked=stk,
            layers=layers, rows=rows, n=n, row_offset=row_offset,
            slice_offset=slice_offset,
            adapt=len(shape) - (1 if stk else 0) > 1))
        row_offset += layers * rows
        slice_offset += layers
    # ZeRO: pad to a multiple of shards * block_rows, so the row shards
    # are even and every shard boundary is a block boundary
    pad = -row_offset % (shards * block_rows) if shards > 1 else 0
    return PackedLayout(segments=tuple(segments), treedef=treedef,
                        lane=lane, block_rows=block_rows,
                        total_rows=row_offset + pad,
                        num_slices=slice_offset, shards=shards,
                        pad_rows=pad)


def build_layout(params: Pytree, stacked: Pytree, *, lane: int = LANE,
                 block_rows: int = BLOCK_ROWS,
                 shards: int = 1) -> PackedLayout:
    """Static layout from a param tree (tensors, or anything with
    ``.shape`` and ``.dtype``) and a full bool tree marking ``(L, ...)``
    layer-stacked leaves. ``shards``: the ZeRO row-shard count (see
    :class:`PackedLayout`)."""
    leaves, treedef = tree_flatten_with_path(params)
    if not leaves:
        raise ValueError("cannot build a packed layout for an empty pytree")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    flags = tuple(bool(s) for s in flatten_up_to(treedef, stacked))
    shapes = tuple(tuple(int(d) for d in leaf.shape) for _, leaf in leaves)
    dtypes = tuple(dtype_name(leaf.dtype) for _, leaf in leaves)
    return _build_layout_static(treedef, shapes, dtypes, flags, lane,
                                block_rows, int(shards))


# ------------------------------------------------------- static index maps

@functools.lru_cache(maxsize=64)
def _row_slice_ids(layout: PackedLayout) -> np.ndarray:
    """(total_rows,) int64: owning slice id of every superbuffer row; a
    ZeRO pad row gets the out-of-range id ``num_slices``."""
    ids = np.full(layout.total_rows, layout.num_slices, np.int64)
    for seg in layout.segments:
        ids[seg.row_offset:seg.row_offset + seg.layers * seg.rows] = \
            np.repeat(np.arange(seg.slice_offset,
                                seg.slice_offset + seg.layers), seg.rows)
    return ids


@functools.lru_cache(maxsize=64)
def _gather_ids(layout: PackedLayout) -> np.ndarray:
    """``_row_slice_ids`` with the pad rows on slice 0, for broadcasts:
    whatever scalar lands on a pad row multiplies zeros."""
    ids = _row_slice_ids(layout).copy()
    ids[ids == layout.num_slices] = 0
    return ids


@functools.lru_cache(maxsize=64)
def _adapt_mask(layout: PackedLayout) -> np.ndarray:
    mask = np.empty(layout.num_slices, bool)
    for seg in layout.segments:
        mask[seg.slice_offset:seg.slice_offset + seg.layers] = seg.adapt
    return mask


@functools.lru_cache(maxsize=64)
def _fold_index(layout: PackedLayout, stride: int) -> np.ndarray:
    """(num_slices, max_partials) int64 gather index over partials of
    ``stride`` rows each (``block_rows`` or 1): the partial ids of each
    slice, in order, padded with the out-of-range id ``total_rows //
    stride`` (a zero appended by :func:`_fold`). ZeRO pad rows are in no
    slice's list: the fold of a padded buffer's partials is the unpadded
    fold, op for op."""
    ids = _row_slice_ids(layout)[::stride]
    counts = np.bincount(ids, minlength=layout.num_slices + 1)[
        :layout.num_slices]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = np.arange(int(counts.max()))
    idx = starts[:, None] + cols[None, :]
    return np.where(cols[None, :] < counts[:, None], idx, len(ids))


@functools.lru_cache(maxsize=256)
def _on_device(fn, layout: PackedLayout, device: torch.device, *args
               ) -> torch.Tensor:
    """One copy of a static map per (layout, device, args), so the step
    path makes no host-to-device copy after the first. Callers only read
    it."""
    return torch.from_numpy(fn(layout, *args)).to(device)


def row_slice_ids(layout: PackedLayout, device=None) -> torch.Tensor:
    return _on_device(_row_slice_ids, layout, torch.device(device or "cpu"))


def block_slice_ids(layout: PackedLayout, device=None) -> torch.Tensor:
    return row_slice_ids(layout, device)[::layout.block_rows]


def adapt_mask(layout: PackedLayout, device=None) -> torch.Tensor:
    return _on_device(_adapt_mask, layout, torch.device(device or "cpu"))


def _fold(layout: PackedLayout, partials: torch.Tensor, stride: int
          ) -> torch.Tensor:
    idx = _on_device(_fold_index, layout, partials.device, stride)
    padded = torch.cat([partials, partials.new_zeros(1)])
    return padded[idx].sum(dim=1)


def fold_blocks(layout: PackedLayout, per_block: torch.Tensor
                ) -> torch.Tensor:
    """(num_blocks,) per-row-block partials -> (num_slices,) sums, in a
    fixed order (a sorted-segment sum over the static block counts)."""
    return _fold(layout, per_block, layout.block_rows)


def fold_rows(layout: PackedLayout, per_row: torch.Tensor) -> torch.Tensor:
    """(total_rows,) per-row partials -> (num_slices,) sums, in the same
    fixed order and with the same ops as :func:`fold_blocks`. A ZeRO
    row shard's partials are all-gathered to the whole vector first."""
    per_row = gather_rows(layout, per_row)
    return _fold(layout, per_row, 1)


# ------------------------------------------------------------ ZeRO shards

def _zero_mesh(layout: PackedLayout):
    """The ambient mesh if it row-shards this layout, else None."""
    mesh = current_mesh()
    if layout.shards > 1 and mesh is not None \
            and "data" in mesh.axis_names:
        if mesh.shape["data"] != layout.shards:
            raise ValueError(
                f"a ZeRO layout of {layout.shards} shards under a mesh "
                f"whose data axis has {mesh.shape['data']} ranks")
        return mesh
    return None


def shard_span(layout: PackedLayout, rows: int) -> tuple[int, int]:
    """The superbuffer rows ``[start, stop)`` that a buffer of ``rows``
    rows holds: all of them, or under an ambient mesh this rank's ZeRO
    row shard. Raises for any other row count."""
    if rows == layout.total_rows:
        return 0, rows
    mesh = _zero_mesh(layout)
    if mesh is not None and rows == layout.shard_rows:
        start = mesh.coords["data"] * rows
        return start, start + rows
    raise ValueError(
        f"a buffer of {rows} rows is neither the layout's {layout.total_rows} "
        f"nor, under a mesh of {layout.shards} data ranks, one shard of "
        f"{layout.shard_rows}")


def is_shard(layout: PackedLayout, buf: torch.Tensor) -> bool:
    """True where ``buf`` holds a row shard, not the whole buffer."""
    return shard_span(layout, buf.shape[0]) != (0, layout.total_rows)


def constrain_rows(layout: PackedLayout, buf: torch.Tensor) -> torch.Tensor:
    """This rank's ZeRO row shard of a whole superbuffer (or of its
    ``(num_blocks, 1)`` per-block scales) under an ambient mesh: a fresh
    contiguous copy, so the whole buffer can be freed. The buffer as it is
    without a mesh, for an unsharded layout, or when it already is a
    shard."""
    mesh = _zero_mesh(layout)
    # a per-block column is (num_blocks, 1); anything else is in rows
    # (both can have num_blocks rows: a shard's under 8 ranks)
    blocks = buf.ndim == 2 and buf.shape[1] == 1
    whole = layout.num_blocks if blocks else layout.total_rows
    if mesh is None or buf.shape[0] != whole:
        return buf
    n = buf.shape[0] // layout.shards
    start = mesh.coords["data"] * n
    return buf[start:start + n].clone()


def gather_rows(layout: PackedLayout, buf: torch.Tensor) -> torch.Tensor:
    """All-gather a row shard (of the superbuffer, or a per-row vector
    such as ``norms_flat``'s partials) over the mesh's data axis back to
    the whole; a whole buffer as it is. This is the ZeRO step's one
    weight all-gather, and the gather of the norm partials."""
    if not is_shard(layout, buf):
        return buf
    return collectives.all_gather_rows(buf, _zero_mesh(layout))


def gather_blocks(layout: PackedLayout, scales: torch.Tensor
                  ) -> torch.Tensor:
    """:func:`gather_rows` for a per-block column (the int8 scales)."""
    if scales.shape[0] == layout.num_blocks:
        return scales
    return collectives.all_gather_rows(scales, _zero_mesh(layout))


# ---------------------------------------------------------- pack / unpack

def pack(layout: PackedLayout, tree: Pytree) -> torch.Tensor:
    """Pytree -> (total_rows, lane) f32 superbuffer (zero padded, and the
    ZeRO pad rows zero), on the device of the leaves. Always the whole
    buffer: :func:`constrain_rows` cuts a rank's shard."""
    leaves = flatten_up_to(layout.treedef, tree)
    parts = []
    for seg, leaf in zip(layout.segments, leaves):
        flat = leaf.float().reshape(seg.layers, -1)
        pad = seg.rows * layout.lane - seg.n
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        parts.append(flat.reshape(-1))
    if layout.pad_rows:
        parts.append(parts[0].new_zeros(layout.pad_rows * layout.lane))
    return torch.cat(parts).reshape(layout.total_rows, layout.lane)


def init_master(layout: PackedLayout, params: Pytree) -> torch.Tensor:
    """f32 master-weight superbuffer seeded from the current params."""
    return pack(layout, params)


def round_to_storage_(layout: PackedLayout, buf: torch.Tensor
                      ) -> torch.Tensor:
    """The reference's ``quantize_to_storage``, in place: round each
    segment's rows of ``buf`` through its storage dtype (in f32) and
    return ``buf``. The reference returns a new buffer; a copy of the
    whole superbuffer at the update's peak would not fit beside a
    tensor-parallel rank's state, so the caller hands this a buffer no
    one else holds (an update's fresh output), never a slot. All-f32
    layouts are left as they are. Zero padding is preserved. A ZeRO row
    shard rounds the rows of each segment that it holds.
    """
    lowp = [seg for seg in layout.segments if seg.dtype != "float32"]
    if not lowp:
        return buf
    start, stop = shard_span(layout, buf.shape[0])
    for seg in lowp:
        lo = max(seg.row_offset, start)
        hi = min(seg.row_offset + seg.layers * seg.rows, stop)
        # a chunk of rows at a time: the rounded copies stay small
        for at in range(lo, hi, ROUND_CHUNK_ROWS):
            rows = slice(at - start, min(at + ROUND_CHUNK_ROWS, hi) - start)
            buf[rows] = buf[rows].to(torch_dtype(seg.dtype)).float()
    return buf


def unpack(layout: PackedLayout, buf: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> Pytree:
    """(total_rows, lane) superbuffer -> pytree.

    Leaves are cast to their original dtypes, or to ``dtype`` when given
    (slot buffers are unpacked as f32 regardless of the param dtype).
    Leaves in f32 are views of ``buf``.
    """
    if tuple(buf.shape) != layout.buffer_shape:
        raise ValueError(f"buffer shape {tuple(buf.shape)} != layout "
                         f"{layout.buffer_shape}")
    leaves = []
    for seg in layout.segments:
        block = buf[seg.row_offset:seg.row_offset + seg.layers * seg.rows]
        flat = block.reshape(seg.layers, seg.rows * layout.lane)[:, :seg.n]
        leaves.append(flat.reshape(seg.shape).to(
            dtype or torch_dtype(seg.dtype)))
    return tree_unflatten(layout.treedef, leaves)


# -------------------------------------------------- per-slice reductions

def slice_sumsq(layout: PackedLayout, buf: torch.Tensor) -> torch.Tensor:
    """(num_slices,) f32: sum of squares per layer slice. A ZeRO row
    shard's per-block partials are all-gathered first, then folded
    whole (pad blocks fall out of the fold)."""
    per_block = torch.sum(torch.square(buf.float()).reshape(
        buf.shape[0] // layout.block_rows, -1), dim=1)
    if is_shard(layout, buf):
        per_block = collectives.all_gather_rows(per_block,
                                                _zero_mesh(layout))
    return fold_blocks(layout, per_block)


def slice_norms(layout: PackedLayout, a: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint per-slice L2 norms of two superbuffers; (num_slices,) each."""
    return (torch.sqrt(slice_sumsq(layout, a)),
            torch.sqrt(slice_sumsq(layout, b)))


def tree_slice_sumsq(layout: PackedLayout, tree: Pytree) -> torch.Tensor:
    """(num_slices,) f32 sum of squares computed from the UNPACKED tree
    (same values as ``slice_sumsq(layout, pack(layout, tree))`` up to f32
    summation order)."""
    leaves = flatten_up_to(layout.treedef, tree)
    return torch.cat([torch.sum(torch.square(
        leaf.float().reshape(seg.layers, -1)), dim=1)
        for seg, leaf in zip(layout.segments, leaves)])


def rows_expand(layout: PackedLayout, per_slice: torch.Tensor,
                rows: Optional[int] = None) -> torch.Tensor:
    """(num_slices,) -> (total_rows, 1): broadcast per-slice scalars so
    they multiply against the superbuffer; ``rows``: the row count of
    the buffer they meet (a ZeRO shard takes its own rows)."""
    start, stop = shard_span(layout, rows or layout.total_rows)
    ids = _on_device(_gather_ids, layout, per_slice.device)
    return per_slice[ids[start:stop]][:, None]


def blocks_expand(layout: PackedLayout, per_slice: torch.Tensor,
                  rows: Optional[int] = None) -> torch.Tensor:
    """(num_slices,) -> (num_blocks, 1): per-row-block scalars (the apply
    kernel reads one scalar per row block); ``rows`` as in
    :func:`rows_expand`."""
    start, stop = shard_span(layout, rows or layout.total_rows)
    ids = _on_device(_gather_ids, layout, per_slice.device)
    b = layout.block_rows
    return per_slice[ids[start:stop:b]][:, None]


def check_marker(layout: PackedLayout, params: Pytree,
                 stacked: Pytree) -> None:
    """Validate an update-time stacked marker against the init-time layout."""
    flags = tuple(bool(s) for s in flatten_up_to(layout.treedef, stacked))
    if flags != layout.stacked_flags():
        raise ValueError(
            "stacked marker passed to update() disagrees with the marker "
            "the packed OptState was built with at init(); rebuild the "
            "optimizer state with the new marker")


# ------------------------------------------------- int8 slot quantization

# Symmetric int8 range. +-127 (not -128) keeps the code symmetric around
# zero so q == -q for negated buffers and dequantize(quantize(0)) == 0
# exactly: zero padding rows stay exactly zero through a round trip.
Q8_LEVELS = 127.0


def _q8_scale(amax: torch.Tensor) -> torch.Tensor:
    """absmax -> quantization scale, guarding all-zero groups (scale 1.0
    round-trips zeros). A NaN absmax stays NaN, so a block whose values
    went NaN keeps that visible instead of quantizing as finite. The
    divisor is a tensor on amax's device: PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal instead of dividing, which
    would move the scale off the IEEE quotient the CUDA kernel takes."""
    keep = (amax > 0.0) | torch.isnan(amax)
    return torch.where(keep, amax / amax.new_full((), Q8_LEVELS),
                       torch.ones_like(amax))


def quantize_blocks_q8(grouped: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``(groups, n)`` -> (int8 codes ``(groups, n)``, f32 scales
    ``(groups, 1)``): symmetric absmax quantization per group, round
    half to even, clip to +-127, code 0 where the value is NaN."""
    scale = _q8_scale(torch.amax(torch.abs(grouped), dim=1, keepdim=True))
    q = torch.clamp(torch.round(grouped / scale), -Q8_LEVELS, Q8_LEVELS)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int8), scale


def _rows_shape(layout: PackedLayout, buf: torch.Tensor
                ) -> tuple[int, int]:
    """``buf``'s (rows, lane) if it is the whole buffer or a row shard."""
    if buf.ndim != 2 or buf.shape[1] != layout.lane:
        raise ValueError(f"buffer shape {tuple(buf.shape)} != layout "
                         f"{layout.buffer_shape}")
    shard_span(layout, buf.shape[0])
    return tuple(buf.shape)


def quantize_q8(layout: PackedLayout, buf: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 superbuffer (or a ZeRO row shard) -> (int8 codes (rows, lane),
    f32 scales (rows // block_rows, 1)): one scale per block_rows row
    block. Slices are block-aligned, so every scale group lies inside
    one layer slice."""
    shape = _rows_shape(layout, buf)
    q, scale = quantize_blocks_q8(buf.float().reshape(
        shape[0] // layout.block_rows, -1))
    return q.reshape(shape), scale


def dequantize_q8(layout: PackedLayout, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """(int8 codes, per-block scales) -> f32 superbuffer (or shard)."""
    shape = _rows_shape(layout, q)
    blocks = shape[0] // layout.block_rows
    if tuple(scale.shape) != (blocks, 1):
        raise ValueError(f"codes {tuple(q.shape)} / scales "
                         f"{tuple(scale.shape)} do not fit the layout "
                         f"{layout.buffer_shape}")
    grouped = q.reshape(blocks, -1).float() * scale
    return grouped.reshape(shape)


def quantize_leaf_q8(x: torch.Tensor, amax_over=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf int8 quantization for the tree engine: one scale per
    leading index, shape ``(d0, 1, ..., 1)``; a vector's scale is its
    absolute values and a scalar leaf gets a scalar scale. The scale
    shape depends on the leaf shape only, never on the stacked marker,
    so slot shapes are the same whether ``update`` gets one or not. The
    rules are :func:`quantize_blocks_q8`'s (a NaN keeps its scale NaN).
    ``amax_over``: a mesh whose ``model`` axis splits ``x`` past dim 0;
    each absmax is then the max over its ranks (the whole leaf's)."""
    x = x.float()
    # amax over no axis is the identity, as jnp.max(axis=()) is;
    # torch.amax(dim=()) would reduce every axis instead
    amax = torch.abs(x) if x.ndim <= 1 else torch.amax(
        torch.abs(x), dim=tuple(range(1, x.ndim)), keepdim=True)
    if amax_over is not None:
        amax = collectives.all_reduce_max(amax.contiguous(), amax_over)
    scale = _q8_scale(amax)
    q = torch.clamp(torch.round(x / scale), -Q8_LEVELS, Q8_LEVELS)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int8), scale


def dequantize_leaf_q8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-leaf inverse of :func:`quantize_leaf_q8` (broadcast multiply)."""
    return q.float() * scale
