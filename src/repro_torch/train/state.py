"""TrainState: what is carried across steps (port of
``repro/train/state.py``), and the precision policy it is built on.

The ``stacked`` marker (which leaves are ``(L, ...)`` layer stacks) is
static per architecture. By default it goes into ``optimizer.init``, so
the optimizer state is born on the flat-packed substrate: weights and
slots (momentum, second moment) live packed in superbuffers across steps
and the OptState carries the static PackedLayout. ``packed=False`` keeps
per-leaf slot trees instead: the reference's layout where slots must
shard leaf for leaf beside FSDP-sharded params (its pjit dry run builds
its states that way). The packed superbuffers are replicated per device
unless the state is built ZeRO-sharded (``zero_shards=n``): under an
ambient data-parallel mesh of ``n`` data ranks each rank then holds its
own row shard of every slot (:mod:`repro_torch.core.optim_base`). The
tree layout is the per-leaf engine: no kernel launch, a pass over every
leaf per step.

Under a tensor-parallel mesh (``mesh=``, a ``model`` axis above 1) the
params are this rank's blocks (:func:`~repro_torch.distributed.sharding.
shard_params`); a packed state is built from the WHOLE params, in the
global layout (replicated over ``model``, as the reference's
``state_pspecs``), a tree state from the blocks (its slots sharded like
the params).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.optim_base import OptState
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import param_shardings, shard_params
from repro_torch.treepath import tree_map

Pytree = Any


class TrainState(NamedTuple):
    params: Pytree
    opt_state: OptState


# ------------------------------------------------------------- precision

@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy for one training run: ``compute_dtype`` is what
    params, activations and batch floats run in (``None`` leaves the
    model's own dtypes); ``master_weights`` keeps an f32 master copy of
    the params as an optimizer slot."""

    name: str
    compute_dtype: Optional[torch.dtype]
    master_weights: bool


PRECISIONS: dict[str, Precision] = {
    "f32": Precision("f32", None, False),
    "bf16": Precision("bf16", torch.bfloat16, True),
}


def get_precision(precision: str | Precision) -> Precision:
    if isinstance(precision, Precision):
        return precision
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"have {sorted(PRECISIONS)}")
    return PRECISIONS[precision]


def cast_floats(tree: Pytree, dtype: Optional[torch.dtype]) -> Pytree:
    """Cast float leaves to ``dtype``; int/bool leaves pass through."""
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


# ----------------------------------------------------------------- state

def create_train_state(model, optimizer, generator: torch.Generator, *,
                       device: torch.device | str, packed: bool = True,
                       precision: str | Precision = "f32",
                       zero_shards: int = 1, mesh=None) -> TrainState:
    """Fresh TrainState on ``device`` from ``model.init(generator)``;
    ``precision="bf16"`` stores params in bfloat16 and seeds an f32
    master-weight slot — the policy ``TrainPipeline`` applies.
    ``packed=False`` builds the optimizer state without a marker: per-leaf
    slot trees (the tree engine). ``zero_shards``: the ZeRO row-shard
    count of the packed state. ``mesh``: a tensor-parallel mesh cuts the
    params to this rank's blocks (every rank draws the whole init)."""
    return train_state_from_params(model, optimizer,
                                   model.init(generator, device),
                                   precision=precision, packed=packed,
                                   zero_shards=zero_shards, mesh=mesh)


def train_state_from_params(model, optimizer, params: Pytree, *,
                            precision: str | Precision = "f32",
                            packed: bool = True,
                            zero_shards: int = 1, mesh=None) -> TrainState:
    """TrainState from given (whole) params on a precision policy: params
    cast to its compute dtype, the optimizer state packed from them
    (per-leaf slot trees with ``packed=False``; row shards of a ZeRO
    layout under an ambient mesh with ``zero_shards > 1``). Under a mesh
    whose ``model`` axis has more than one rank the params are cut to
    this rank's blocks: after the packed state is built from the whole,
    before a tree state is."""
    policy = get_precision(precision)
    params = cast_floats(params, policy.compute_dtype)
    kw = {"zero_shards": zero_shards} if zero_shards > 1 else {}
    shardings = None
    if collectives.model_parallel(mesh) is not None:
        shardings = param_shardings(model.cfg, params, mesh)
        if not packed:
            params = shard_params(params, shardings)
    opt_state = optimizer.init(
        params, stacked=model.stacked_marker(params) if packed else None,
        master=policy.master_weights, **kw)
    if shardings is not None and packed:
        params = shard_params(params, shardings)
    return TrainState(params=params, opt_state=opt_state)
