"""TrainState <-> npz (port of ``repro/checkpoint/npz.py``, unsharded
layouts).

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
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import tensor_to_numpy
from repro_torch.core.optim_base import OptState
from repro_torch.train.state import TrainState
from repro_torch.treepath import (path_str, tree_flatten_with_path,
                                  tree_unflatten)

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


def save_train_state(path: str, state: TrainState) -> None:
    """Persist a full TrainState (params + opt slots + step) to npz,
    atomically."""
    arrays = {k: v if isinstance(v, np.ndarray) else tensor_to_numpy(v)
              for k, v in _flatten(state).items()}
    _atomic(_npz(path), lambda tmp: np.savez(tmp, **arrays))


def clone_checkpoint(src: str, dst: str) -> None:
    """Atomically copy a checkpoint file."""
    _atomic(_npz(dst), lambda tmp: shutil.copyfile(_npz(src), tmp))


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Restore a TrainState into ``template``'s structure.

    ``template`` is a freshly initialized state from the same (model,
    optimizer, precision) triple: it supplies the structure, dtypes,
    device and packed layout; the checkpoint supplies every tensor and
    the step. Mismatches fail loudly: a leaf the checkpoint lacks, a
    leaf the template has no place for (e.g. a bf16-policy master buffer
    restored into an f32-policy state) and a shape mismatch.
    """
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
