"""Shared layer-wise optimizer substrate (port of
``repro/core/optim_base.py``: the flat-packed engine with f32 slots).

* ``Optimizer.init(params, stacked) -> OptState``;
  ``Optimizer.update(grads, state, params, stacked=None) ->
  (new_params, new_state)``. The step counter is a host ``int`` in the
  state, so the learning rate is computed on the host each step.
* A :class:`LayerwiseRule` factors an optimizer of the trust-ratio family
  into ``direction`` (the trust-ratio norm operand), ``trust`` (the
  per-layer ratio; ``None`` for SGD) and ``apply`` (fold the local LR
  into the weight and slot update). All are elementwise over the whole
  superbuffer or per-slice scalars.
* The engine keeps the weights packed across steps in the
  ``WEIGHT_SLOT`` buffer and every slot packed beside them; per step it
  packs only the gradients. A rule with a trust ratio (LARS) runs its two
  memory-bound passes through its kernel wrappers: exactly one
  ``norms_flat`` and one ``apply_flat`` launch per step on CUDA buffers,
  whatever the leaf count, and their plain versions on CPU buffers.

Not yet ported: the per-leaf tree engine (``init`` without a marker),
int8 slots, the bf16 master-weight slot and ZeRO-sharded layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.schedules import Schedule
from repro_torch.treepath import tree_map

Pytree = Any

SLOT_DTYPES = ("f32",)


class PackedGrads(NamedTuple):
    """Mean gradients already living in the (rows, lane) superbuffer: the
    engine then skips its per-step gradient pack and takes the trust
    norms from the buffer."""

    buf: torch.Tensor


@dataclasses.dataclass
class OptState:
    """Step counter + packed slot buffers. Each slot is a (rows, lane) f32
    superbuffer; ``layout`` is the static
    :class:`~repro_torch.core.packing.PackedLayout`."""

    step: int
    slots: dict[str, torch.Tensor]
    layout: packing.PackedLayout


@dataclasses.dataclass(frozen=True)
class LayerwiseRule:
    """One optimizer of the layer-wise trust-ratio family."""

    name: str
    slots: tuple[str, ...]
    # (g, w, slots) -> (u, slots'): the trust-ratio norm operand.
    direction: Callable[..., tuple[torch.Tensor, dict]]
    # (w_norm, u_norm) -> per-layer ratio; None = always 1 (SGD).
    trust: Optional[Callable[..., torch.Tensor]] = None
    # Without a trust ratio: (w, g, u, lr, slots) -> (w_new, slots').
    apply: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # With a trust ratio, the two memory-bound passes as kernel wrappers:
    # (layout, wbuf, ubuf) -> (w_norm, u_norm) per slice, and
    # (layout, wbuf, gbuf, ubuf, lr_slices, slots) -> (wbuf', slots').
    packed_norms: Optional[Callable[..., tuple]] = None
    packed_apply: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # rank<=1 slices (biases) keep trust ratio 1.
    skip_adaptation_1d: bool = True


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A named pair of functions (init, update)."""

    name: str
    init: Callable[..., OptState]
    update: Callable[..., tuple[Pytree, OptState]]
    hyperparams: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:
        hp = ", ".join(f"{k}={v}" for k, v in self.hyperparams.items()
                       if not callable(v))
        return f"Optimizer({self.name}, {hp})"


# ------------------------------------------------------------------ engine

def _packed_update(rule: LayerwiseRule, layout: packing.PackedLayout,
                   lr: float, grads: Pytree | PackedGrads,
                   slots: dict, wbuf: torch.Tensor) -> tuple[Pytree, dict]:
    """Flat-packed engine: whole-pytree buffers, per-slice scalars.

    A rule without a trust ratio updates the buffers with its ``apply``.
    A rule with one takes the per-slice norms and the fused update from
    its kernel wrappers; the trust ratio and the adaptation mask are
    computed here. Returns the new params (views of the new weight
    buffer) and the new slots, including the new ``WEIGHT_SLOT`` buffer.
    """
    gbuf = grads.buf if isinstance(grads, PackedGrads) \
        else packing.pack(layout, grads)
    u, slots = rule.direction(gbuf, wbuf, dict(slots))
    if rule.trust is None:
        wbuf2, new_slots = rule.apply(wbuf, gbuf, u, lr, slots)
    else:
        w_norm, u_norm = rule.packed_norms(layout, wbuf, u)
        ratio = rule.trust(w_norm, u_norm)
        if rule.skip_adaptation_1d:
            ratio = torch.where(packing.adapt_mask(layout, ratio.device),
                                ratio, torch.ones_like(ratio))
        wbuf2, new_slots = rule.packed_apply(layout, wbuf, gbuf, u,
                                             lr * ratio, slots)
    wbuf2 = packing.quantize_to_storage(layout, wbuf2)
    new_slots[packing.WEIGHT_SLOT] = wbuf2
    return packing.unpack(layout, wbuf2), new_slots


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to repro_torch")


def make_optimizer(rule: LayerwiseRule, learning_rate: float | Schedule, *,
                   slot_dtype: str = "f32",
                   hyperparams: Optional[dict] = None) -> Optimizer:
    """Build an :class:`Optimizer` from a rule."""
    lr_fn = as_schedule(learning_rate)
    if slot_dtype not in SLOT_DTYPES:
        raise _not_yet_ported(f"slot_dtype={slot_dtype!r}")

    def init(params: Pytree, stacked: Optional[Pytree] = None,
             master: bool = False) -> OptState:
        if stacked is None:
            raise _not_yet_ported(
                "the per-leaf tree engine (init without a stacked marker)")
        if master:
            raise _not_yet_ported("the bf16 master-weight slot")
        layout = packing.build_layout(params, normalize_stacked(params,
                                                                stacked))
        weights = packing.pack(layout, params)
        slots = {k: torch.zeros_like(weights) for k in rule.slots}
        slots[packing.WEIGHT_SLOT] = weights
        return OptState(step=0, slots=slots, layout=layout)

    def update(grads: Pytree | PackedGrads, state: OptState, params: Pytree,
               stacked: Optional[Pytree] = None
               ) -> tuple[Pytree, OptState]:
        if stacked is not None:
            packing.check_marker(state.layout, params, stacked)
        slots = dict(state.slots)
        weights = slots.pop(packing.WEIGHT_SLOT)
        lr = float(lr_fn(state.step))
        new_params, new_slots = _packed_update(
            rule, state.layout, lr, grads, slots, weights)
        return new_params, OptState(step=state.step + 1, slots=new_slots,
                                    layout=state.layout)

    return Optimizer(name=rule.name, init=init, update=update,
                     hyperparams=dict(hyperparams or {}))


# ------------------------------------------------------------------ helpers

def as_schedule(lr: float | Schedule) -> Schedule:
    """Promote a constant learning rate to a schedule."""
    if callable(lr):
        return lr
    value = np.float32(lr)
    return lambda step: value


def normalize_stacked(params: Pytree, stacked: Pytree) -> Pytree:
    """Return a full bool tree mirroring params."""
    return tree_map(lambda p, s: bool(s), params, stacked)
