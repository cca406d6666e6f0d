"""TrainState <-> npz (port of ``repro/checkpoint/npz.py``).

``save_train_state`` / ``restore_train_state`` round-trip the FULL
:class:`~repro_torch.train.state.TrainState` — params, every optimizer
slot (momentum, int8 codes and their scales, the packed weight or f32
master buffer, or on a tree state the slot trees) and the step counter —
so large-batch runs resume mid-schedule. The packed ``layout`` is not
stored: the caller's freshly initialized template state supplies it, and
the restore checks the stored arrays against the template.

The file is the JAX package's, key for key. Keys are the "/"-joined
paths that ``jax.tree_util`` gives a ``TrainState`` there — attribute
names carry a leading dot, dict keys do not. A packed slot is one
buffer, a tree slot one key per leaf::

    .params/conv1/w   .opt_state/.step   .opt_state/.slots/momentum
    .opt_state/.slots/momentum/conv1/w
    .opt_state/.slots/momentum_scale/conv1/w

so a state saved by either package restores into the other. bfloat16
leaves are stored as float32 (npz cannot hold them; every bfloat16 value
is exact in float32) and cast back to the template's dtype on restore.

ZeRO layouts stay layout-independent on disk, as the reference keeps
them: a save all-gathers each row-sharded slot (a collective: every rank
of the mesh calls it, and only rank 0 of the process group writes),
then strips the pad rows and the pad blocks' scales down to the
``shards=1`` shapes; a restore re-pads to the template's layout (zero
rows and codes, unit scales: exactly the live values) and keeps this
rank's rows where the template holds a row shard. A file saved under
any shard count is byte-equal to the reference's for the same state.

Tensor-parallel states (``shardings=``: one
:class:`~repro_torch.distributed.sharding.LeafSharding` a param leaf,
``TrainPipeline.param_shardings``) are stored whole too: a save
all-gathers the split params and a tree state's slots over ``model``
(packed slots are already global), so the file is byte-equal to a
``1x1`` run's for the same state; a restore reads the whole leaves on
the host and keeps this rank's blocks.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import tensor_to_numpy
from repro_torch.core import packing
from repro_torch.core.optim_base import SCALE_SUFFIX, OptState
from repro_torch.distributed.sharding import (gather_leaf, scale_sharding,
                                              shard_leaf)
from repro_torch.launch.mesh import world
from repro_torch.train.state import TrainState
from repro_torch.treepath import (path_str, tree_flatten_with_path,
                                  tree_map, tree_unflatten)

PARAMS = ".params/"
STEP = ".opt_state/.step"
SLOTS = ".opt_state/.slots/"


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _slot_key(name: str, path: tuple) -> str:
    """The key of one slot leaf: the slot's name, then the leaf's path
    inside a slot tree (none for a packed buffer)."""
    return SLOTS + "/".join((name,) + tuple(path))


def _flatten(state: TrainState) -> dict[str, Any]:
    """npz key -> tensor (or the step as an int32 scalar), in the
    reference's order: params, step, then slots and their leaves sorted."""
    flat = {PARAMS + path_str(p): leaf
            for p, leaf in tree_flatten_with_path(state.params)[0]}
    flat[STEP] = np.asarray(state.opt_state.step, np.int32)
    for k, v in sorted(state.opt_state.slots.items()):
        flat.update({_slot_key(k, p): leaf
                     for p, leaf in tree_flatten_with_path(v)[0]})
    return flat


def _atomic(dst: str, write) -> None:
    """Write through a temporary file and rename it: a kill inside the
    write never leaves a torn npz behind."""
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    tmp = dst + ".tmp.npz"          # keep the suffix np.savez insists on
    write(tmp)
    os.replace(tmp, dst)


def _strip(name: str, buf: torch.Tensor, layout) -> torch.Tensor:
    """A packed slot's whole buffer cropped to the ``shards=1`` rows (or
    scale blocks)."""
    keep = layout.base_rows // layout.block_rows \
        if name.endswith(SCALE_SUFFIX) else layout.base_rows
    return buf[:keep]


def _repad(name: str, arr: np.ndarray, layout) -> np.ndarray:
    """Inverse of :func:`_strip` for ``layout``: zero rows and codes,
    UNIT scales for the pad blocks (what the live state holds there)."""
    if not layout.pad_rows:
        return arr
    if name.endswith(SCALE_SUFFIX):
        tail = np.ones((layout.num_blocks - arr.shape[0], 1), arr.dtype)
    else:
        tail = np.zeros((layout.total_rows - arr.shape[0], layout.lane),
                        arr.dtype)
    return np.concatenate([arr, tail])


def _whole_slots(state: TrainState) -> TrainState:
    """A ZeRO state's slots gathered to whole buffers and stripped of
    their pad rows (a collective under a mesh); any other state as it
    is."""
    layout = state.opt_state.layout
    if layout is None or layout.shards == 1:
        return state
    slots = {}
    for k, v in state.opt_state.slots.items():
        whole = packing.gather_blocks(layout, v) \
            if k.endswith(SCALE_SUFFIX) else packing.gather_rows(layout, v)
        slots[k] = _strip(k, whole, layout)
    return state._replace(opt_state=OptState(
        step=state.opt_state.step, slots=slots, layout=layout))


def _map_split(fn, state: TrainState, shardings, *others: TrainState
               ) -> TrainState:
    """``fn(leaf, sharding, *other leaves)`` over the params and a tree
    state's slots (an int8 scale slot sharded as its leaf's dim 0); a
    packed state's slots as they are."""
    def tree(t, shs, *rest):
        return tree_map(fn, t, shs, *rest)

    opt = state.opt_state
    slots = dict(opt.slots)
    if opt.layout is None:
        for k, v in opt.slots.items():
            shs = shardings if not k.endswith(SCALE_SUFFIX) else tree_map(
                lambda x, sh: scale_sharding(sh, x.ndim), v, shardings)
            slots[k] = tree(v, shs, *(o.opt_state.slots[k] for o in others))
    return TrainState(
        params=tree(state.params, shardings, *(o.params for o in others)),
        opt_state=OptState(step=opt.step, slots=slots, layout=opt.layout))


def save_train_state(path: str, state: TrainState, *,
                     shardings=None) -> None:
    """Persist a full TrainState (params + opt slots + step) to npz,
    atomically. A ZeRO state is gathered and stripped of its pad rows
    first, a tensor-parallel state's split leaves gathered
    (``shardings``); every rank of its mesh must call this, and only
    rank 0 of the process group writes. Every array is written in C
    order, as the reference writes it (a leaf gathered along its last
    dim is a transposed view, which ``np.save`` would write in Fortran
    order)."""
    state = _whole_slots(state)
    if shardings is not None:
        state = _map_split(gather_leaf, state, shardings)
    if world()[0] != 0:
        return
    arrays = {k: np.asarray(
        v if isinstance(v, np.ndarray) else tensor_to_numpy(v), order="C")
        for k, v in _flatten(state).items()}
    _atomic(_npz(path), lambda tmp: np.savez(tmp, **arrays))


def clone_checkpoint(src: str, dst: str) -> None:
    """Atomically copy a checkpoint file."""
    _atomic(_npz(dst), lambda tmp: shutil.copyfile(_npz(src), tmp))


def restore_train_state(path: str, template: TrainState, *,
                        shardings=None) -> TrainState:
    """Restore a TrainState into ``template``'s structure.

    ``template`` is a freshly initialized state from the same (model,
    optimizer, precision) triple: it supplies the structure, dtypes,
    device and packed layout; the checkpoint supplies every tensor and
    the step. Mismatches fail loudly: a leaf the checkpoint lacks, a
    leaf the template has no place for (e.g. a bf16-policy master buffer
    restored into an f32-policy state) and a shape mismatch.

    A ZeRO template (``layout.shards > 1``) is checked against the
    stored pad-free shapes; each slot is re-padded to the template's
    layout and, where the template holds a row shard, cut to this rank's
    rows. No collective: every rank reads the file.

    ``shardings``: ``template`` holds this rank's blocks of a
    tensor-parallel state; the whole leaves are read on the host and
    cut to the template's blocks on its devices.
    """
    if shardings is not None:
        whole = _map_split(lambda x, sh: torch.empty(
            sh.whole_shape(x.shape), dtype=x.dtype) if sh.split else x,
            template, shardings)
        got = restore_train_state(path, whole)
        return _map_split(lambda x, sh, like: shard_leaf(x, sh).to(
            like.device), got, shardings, template)
    layout = template.opt_state.layout
    if layout is None or layout.shards == 1:
        return _restore_exact(path, template)
    like = template.opt_state.slots
    # a pad-free template on the host (torch.empty touches no memory)
    stripped = template._replace(opt_state=OptState(
        step=template.opt_state.step, layout=layout, slots={
            k: torch.empty(_strip_shape(k, layout), dtype=v.dtype)
            for k, v in like.items()}))
    got = _restore_exact(path, stripped)
    slots = {k: _fit(k, v, layout, like[k])
             for k, v in got.opt_state.slots.items()}
    return got._replace(opt_state=OptState(
        step=got.opt_state.step, slots=slots, layout=layout))


def _strip_shape(name: str, layout) -> tuple[int, int]:
    if name.endswith(SCALE_SUFFIX):
        return (layout.base_rows // layout.block_rows, 1)
    return (layout.base_rows, layout.lane)


def _fit(name: str, base: torch.Tensor, layout, like: torch.Tensor
         ) -> torch.Tensor:
    """A restored pad-free slot re-padded to ``layout`` (zero rows and
    codes, unit scales), cut to ``like``'s rows where it is a row shard,
    on ``like``'s device."""
    whole = torch.from_numpy(_repad(name, base.numpy(), layout))
    if like.shape[0] != whole.shape[0]:
        per = layout.block_rows if name.endswith(SCALE_SUFFIX) else 1
        start, stop = packing.shard_span(layout, like.shape[0] * per)
        whole = whole[start // per:stop // per]
    return whole.contiguous().to(like.device)


def _restore_exact(path: str, template: TrainState) -> TrainState:
    """Shape-strict restore against the template as it is."""
    with np.load(_npz(path)) as data:
        stored = {k: data[k] for k in data.files}
    want = _flatten(template)
    extra = sorted(set(stored) - set(want))
    if extra:
        raise ValueError(
            f"checkpoint has leaves the template cannot hold: {extra[:5]} "
            "— wrong optimizer/precision for this checkpoint (e.g. "
            "restoring a bf16 master-weight state without precision="
            "'bf16')")
    missing = sorted(set(want) - set(stored))
    if missing:
        raise ValueError(f"checkpoint {path!r} lacks leaves {missing[:5]}")
    out = {}
    for key, like in want.items():
        arr = stored[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                f"the template expects {tuple(like.shape)} — wrong arch/"
                "optimizer/precision for this checkpoint")
        if key != STEP:
            arr = torch.from_numpy(np.array(arr)).to(device=like.device,
                                                     dtype=like.dtype)
        out[key] = arr
    treedef = tree_flatten_with_path(template.params)[1]
    params = tree_unflatten(treedef, [out[PARAMS + path_str(p)]
                                      for p in treedef])
    slots = {}
    for k, v in template.opt_state.slots.items():
        slot_def = tree_flatten_with_path(v)[1]
        slots[k] = tree_unflatten(slot_def, [out[_slot_key(k, p)]
                                             for p in slot_def])
    return TrainState(params=params, opt_state=OptState(
        step=int(out[STEP]), slots=slots,
        layout=template.opt_state.layout))
