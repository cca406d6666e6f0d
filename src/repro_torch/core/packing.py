"""Flat-packed layer-wise substrate: one superbuffer for the whole pytree.

Port of ``repro/core/packing.py`` (unsharded layouts only). The layout
is the reference's to the byte: the same segment table, the same
``(total_rows, LANE)`` f32 superbuffer, the same zero padding of every
layer slice to whole ``BLOCK_ROWS`` row blocks, and the same leaf order
(dict keys sorted, as ``jax.tree_util`` flattens them). Packed buffers
and slot states therefore carry between the two packages unchanged.

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
# (``quantize_to_storage``), so the trajectory equals repacking the
# storage-dtype params every step.
WEIGHT_SLOT = "packed_weights"


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
    """Static description of a whole-pytree superbuffer packing."""

    segments: tuple[Segment, ...]
    treedef: TreeDef            # leaf key paths, in flatten order
    lane: int
    block_rows: int
    total_rows: int
    num_slices: int

    @property
    def buffer_shape(self) -> tuple[int, int]:
        return (self.total_rows, self.lane)

    @property
    def num_blocks(self) -> int:
        return self.total_rows // self.block_rows

    def stacked_flags(self) -> tuple[bool, ...]:
        return tuple(s.stacked for s in self.segments)


@functools.lru_cache(maxsize=64)
def _build_layout_static(treedef: TreeDef,
                         shapes: tuple[tuple[int, ...], ...],
                         dtypes: tuple[str, ...],
                         stacked: tuple[bool, ...],
                         lane: int, block_rows: int) -> PackedLayout:
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
    return PackedLayout(segments=tuple(segments), treedef=treedef,
                        lane=lane, block_rows=block_rows,
                        total_rows=row_offset, num_slices=slice_offset)


def build_layout(params: Pytree, stacked: Pytree, *, lane: int = LANE,
                 block_rows: int = BLOCK_ROWS) -> PackedLayout:
    """Static layout from a param tree (tensors, or anything with
    ``.shape`` and ``.dtype``) and a full bool tree marking ``(L, ...)``
    layer-stacked leaves."""
    leaves, treedef = tree_flatten_with_path(params)
    if not leaves:
        raise ValueError("cannot build a packed layout for an empty pytree")
    flags = tuple(bool(s) for s in flatten_up_to(treedef, stacked))
    shapes = tuple(tuple(int(d) for d in leaf.shape) for _, leaf in leaves)
    dtypes = tuple(dtype_name(leaf.dtype) for _, leaf in leaves)
    return _build_layout_static(treedef, shapes, dtypes, flags, lane,
                                block_rows)


# ------------------------------------------------------- static index maps

@functools.lru_cache(maxsize=64)
def _row_slice_ids(layout: PackedLayout) -> np.ndarray:
    """(total_rows,) int64: owning slice id of every superbuffer row."""
    ids = np.empty(layout.total_rows, np.int64)
    for seg in layout.segments:
        ids[seg.row_offset:seg.row_offset + seg.layers * seg.rows] = \
            np.repeat(np.arange(seg.slice_offset,
                                seg.slice_offset + seg.layers), seg.rows)
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
    stride`` (a zero appended by :func:`_fold`)."""
    ids = _row_slice_ids(layout)[::stride]
    counts = np.bincount(ids, minlength=layout.num_slices)
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
    fixed order and with the same ops as :func:`fold_blocks`."""
    return _fold(layout, per_row, 1)


# ---------------------------------------------------------- pack / unpack

def pack(layout: PackedLayout, tree: Pytree) -> torch.Tensor:
    """Pytree -> (total_rows, lane) f32 superbuffer (zero padded), on the
    device of the leaves."""
    leaves = flatten_up_to(layout.treedef, tree)
    parts = []
    for seg, leaf in zip(layout.segments, leaves):
        flat = leaf.float().reshape(seg.layers, -1)
        pad = seg.rows * layout.lane - seg.n
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        parts.append(flat.reshape(-1))
    return torch.cat(parts).reshape(layout.total_rows, layout.lane)


def init_master(layout: PackedLayout, params: Pytree) -> torch.Tensor:
    """f32 master-weight superbuffer seeded from the current params."""
    return pack(layout, params)


def quantize_to_storage(layout: PackedLayout, buf: torch.Tensor
                        ) -> torch.Tensor:
    """Round each segment's rows through its storage dtype (in f32).

    All-f32 layouts are returned as they are; otherwise a new buffer is
    returned and ``buf`` is left untouched. Zero padding is preserved.
    """
    lowp = [seg for seg in layout.segments if seg.dtype != "float32"]
    if not lowp:
        return buf
    buf = buf.clone()
    for seg in lowp:
        rows = slice(seg.row_offset, seg.row_offset + seg.layers * seg.rows)
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
    """(num_slices,) f32: sum of squares per layer slice."""
    per_block = torch.sum(torch.square(buf.float()).reshape(
        layout.num_blocks, -1), dim=1)
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


def rows_expand(layout: PackedLayout, per_slice: torch.Tensor
                ) -> torch.Tensor:
    """(num_slices,) -> (total_rows, 1): broadcast per-slice scalars so
    they multiply against the superbuffer."""
    return per_slice[row_slice_ids(layout, per_slice.device)][:, None]


def blocks_expand(layout: PackedLayout, per_slice: torch.Tensor
                  ) -> torch.Tensor:
    """(num_slices,) -> (num_blocks, 1): per-row-block scalars (the apply
    kernel reads one scalar per row block)."""
    return per_slice[block_slice_ids(layout, per_slice.device)][:, None]


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


def quantize_q8(layout: PackedLayout, buf: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 superbuffer -> (int8 codes (rows, lane), f32 scales
    (num_blocks, 1)): one scale per block_rows row block. Slices are
    block-aligned, so every scale group lies inside one layer slice."""
    if tuple(buf.shape) != layout.buffer_shape:
        raise ValueError(f"buffer shape {tuple(buf.shape)} != layout "
                         f"{layout.buffer_shape}")
    q, scale = quantize_blocks_q8(buf.float().reshape(layout.num_blocks,
                                                      -1))
    return q.reshape(layout.buffer_shape), scale


def dequantize_q8(layout: PackedLayout, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """(int8 codes, per-block scales) -> f32 superbuffer."""
    if tuple(q.shape) != layout.buffer_shape \
            or tuple(scale.shape) != (layout.num_blocks, 1):
        raise ValueError(f"codes {tuple(q.shape)} / scales "
                         f"{tuple(scale.shape)} do not fit the layout "
                         f"{layout.buffer_shape}")
    grouped = q.reshape(layout.num_blocks, -1).float() * scale
    return grouped.reshape(layout.buffer_shape)
