"""Shared layer-wise optimizer substrate (port of
``repro/core/optim_base.py``: both engines).

* ``Optimizer.init(params, stacked=None, master=False) -> OptState``;
  ``Optimizer.update(grads, state, params, stacked=None) ->
  (new_params, new_state)``. The step counter is a host ``int`` in the
  state, so the learning rate and the rule's step scalars (``prepare``)
  are computed on the host each step.
* A :class:`LayerwiseRule` factors an optimizer of the trust-ratio family
  into ``prepare`` (step-dependent scalars, the ``ctx`` every other
  function receives), ``direction`` (the trust-ratio norm operand and
  the slot updates that precede it), ``trust`` (the per-layer ratio;
  ``None`` for SGD and AdamW) and ``apply`` (fold the local LR into the
  weight and slot update). All are elementwise over a leaf or the whole
  superbuffer, or per-layer scalars, so one rule runs on two engines.
* The **tree engine** (``init(params)`` without a marker): every slot
  is a tree mirroring the params leaf for leaf, and ``update`` runs the
  rule per leaf in torch ops on the leaves' device, with per-leaf norms
  (per leading index for the leaves ``update``'s marker calls stacked).
  The bf16 policy's f32 master copy is an f32 tree in ``MASTER_SLOT``.
  It has no kernel path, as the reference's has none: a tree-state step
  launches no ``norms_flat``, ``apply_flat`` or ``apply_flat_q8``, and a
  rule built with ``use_kernels=True`` refuses tree states.
* The **packed engine** (``init(params, stacked=marker)``) keeps the
  weights packed across steps — in the ``WEIGHT_SLOT`` buffer, or under
  the bf16 policy in the f32 ``MASTER_SLOT`` buffer — and every slot
  packed beside them; per step it packs only the gradients. LARS runs
  its two memory-bound passes through its kernel wrappers: exactly one
  ``norms_flat`` and one ``apply_flat`` (``apply_flat_q8`` for int8
  slots) launch per step on CUDA buffers, whatever the leaf count, and
  their plain versions on CPU buffers. A rule with a trust ratio and no
  kernel wrappers (LAMB) takes the per-slice norms with
  ``packing.slice_norms`` and runs its ``apply`` with the local LR
  broadcast per row, as the reference's engine does without Pallas;
  neither LAMB nor AdamW has a kernel there or here.
* ``needs_grad_sq`` (the Adam family): the packed engine hands
  ``direction`` the f32 square of the packed gradient as
  ``ctx["grad_sq"]``; the tree engine squares each leaf's gradient in
  ``direction``, as the reference's does.
* ``slot_dtype="int8"`` stores every rule slot as int8 codes plus f32
  scales (sibling slot ``<name>_scale``): one per row block on the
  packed engine, one per leading index of each leaf on the tree engine
  (``packing.quantize_leaf_q8``). Packed LARS hands the raw codes to its
  fused kernel; everywhere else the engine dequantizes on read, runs the
  rule and requantizes on write.

Not yet ported: ZeRO-sharded layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import trust_ratio as tr
from repro_torch.core.schedules import Schedule
from repro_torch.treepath import (flatten_up_to, tree_flatten_with_path,
                                  tree_map, tree_unflatten)

Pytree = Any

# Optimizer-slot storage dtypes. "int8" stores every rule slot as int8
# codes + one f32 scale per row block; the weight and master buffers
# always stay f32.
SLOT_DTYPES = ("f32", "int8")

# Suffix of the per-block f32 scale slot paired with each int8 code slot
# ("momentum" -> "momentum_scale"), as in the JAX package, so npz
# checkpoints carry the scales by name.
SCALE_SUFFIX = "_scale"


class PackedGrads(NamedTuple):
    """Mean gradients already living in the (rows, lane) superbuffer: the
    engine then skips its per-step gradient pack and takes the trust
    norms from the buffer."""

    buf: torch.Tensor


@dataclasses.dataclass
class OptState:
    """Step counter + slots. Tree layout (``layout is None``): each slot
    is a tree mirroring the params (f32, or int8 codes with a
    ``quantize_leaf_q8`` scale tree beside them). Packed layout: each
    slot is a (rows, lane) superbuffer (f32, or int8 codes with a
    (num_blocks, 1) f32 scale slot beside it), and ``layout`` is the
    static :class:`~repro_torch.core.packing.PackedLayout`."""

    step: int
    slots: dict[str, Any]
    layout: Optional[packing.PackedLayout] = None


@dataclasses.dataclass(frozen=True)
class LayerwiseRule:
    """One optimizer of the layer-wise trust-ratio family. Every function
    takes the step's ``ctx`` first (``prepare``'s dict, plus
    ``grad_sq`` for a rule that ``needs_grad_sq``)."""

    name: str
    slots: tuple[str, ...]
    # (ctx, g, w, slots) -> (u, slots'): the trust-ratio norm operand.
    direction: Callable[..., tuple[torch.Tensor, dict]]
    # (ctx, w, g, u, local_lr, slots) -> (w_new, slots'); local_lr is the
    # scalar LR, or under a trust ratio the per-row LRs (packed engine)
    # or the per-layer LR broadcast against the leaf (tree engine). The
    # packed engine takes ``packed_apply`` instead where a rule has it.
    apply: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # (ctx, w_norm, u_norm) -> per-layer ratio; None = always 1.
    trust: Optional[Callable[..., torch.Tensor]] = None
    # step (host int) -> dict of step-dependent scalars (the ctx).
    prepare: Optional[Callable[[int], dict]] = None
    # rank<=1 slices (biases, norm scales) keep trust ratio 1.
    skip_adaptation_1d: bool = True
    # True when ``direction`` consumes g^2 as well as g (Adam family).
    needs_grad_sq: bool = False
    # The two memory-bound passes as kernel wrappers (LARS):
    # (layout, wbuf, ubuf) -> (w_norm, u_norm) per slice, and
    # (layout, wbuf, gbuf, ubuf, lr_slices, slots) -> (wbuf', slots').
    packed_norms: Optional[Callable[..., tuple]] = None
    packed_apply: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # int8 slots: packed_apply's signature, but ``slots`` holds the raw
    # codes and scales (keys ``k`` and ``k + SCALE_SUFFIX``) and comes
    # back requantized by the kernel. Only for rules whose ``direction``
    # ignores its slots.
    packed_apply_q8: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None


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


# ------------------------------------------------------------------ engines

def _tree_update(rule: LayerwiseRule, lr: float, ctx: dict, grads: Pytree,
                 slots: dict, params: Pytree, stacked_full: Pytree,
                 master: Optional[Pytree] = None) -> tuple[Pytree, dict]:
    """Per-leaf engine: ``direction``, the trust ratio from the leaf's
    norms (per leading index where ``stacked_full`` marks the leaf;
    rank <= 1 leaves keep the scalar LR under ``skip_adaptation_1d``),
    then ``apply``, all in f32 torch ops on the leaf's device.

    ``master``: the f32 master tree of the bf16 policy. The update then
    reads and writes it, the new params are it cast down to each leaf's
    dtype, and the new master rides back in the slot dict.
    """
    n_rule = len(rule.slots)
    extras = [slots[k] for k in rule.slots]
    if master is not None:
        extras.append(master)

    def leaf(g, w, s, *extra):
        sl = dict(zip(rule.slots, extra[:n_rule]))
        gf = g.float()
        wf = extra[n_rule] if master is not None else w.float()
        u, sl = rule.direction(ctx, gf, wf, sl)
        local_lr = lr
        if rule.trust is not None and not (
                rule.skip_adaptation_1d and tr.effective_rank(w, s) <= 1):
            w_norm, u_norm = tr.layer_norms(wf, u, s)
            ratio = rule.trust(ctx, w_norm, u_norm)
            local_lr = lr * tr.broadcast_ratio(ratio, wf, s)
        w_new, sl = rule.apply(ctx, wf, gf, u, local_lr, sl)
        return (w_new.to(w.dtype), [sl[k] for k in rule.slots], w_new)

    leaves, treedef = tree_flatten_with_path(params)
    others = [flatten_up_to(treedef, t) for t in [grads, stacked_full]
              + extras]
    outs = [leaf(others[0][i], w, others[1][i], *(o[i] for o in others[2:]))
            for i, (_, w) in enumerate(leaves)]
    new_params = tree_unflatten(treedef, [o[0] for o in outs])
    new_slots = {k: tree_unflatten(treedef, [o[1][j] for o in outs])
                 for j, k in enumerate(rule.slots)}
    if master is not None:
        new_slots[packing.MASTER_SLOT] = tree_unflatten(
            treedef, [o[2] for o in outs])
    return new_params, new_slots


def _packed_update(rule: LayerwiseRule, layout: packing.PackedLayout,
                   lr: float, ctx: dict, grads: Pytree | PackedGrads,
                   slots: dict, wbuf: torch.Tensor, *, master: bool,
                   quant: bool) -> tuple[Pytree, dict]:
    """Flat-packed engine: whole-pytree buffers, per-slice scalars.

    ``wbuf`` is the f32 master (``master=True``) or the persistent
    weight buffer. A rule without a trust ratio updates the buffers with
    its ``apply`` at the scalar LR. A rule with one takes the per-slice
    norms and the fused update from its kernel wrappers where it has
    them, else from ``packing.slice_norms`` and its ``apply`` with the
    local LR broadcast per row; the trust ratio and the adaptation mask
    are computed here either way. ``quant``: the rule slots are int8
    codes + scales — handed raw to ``packed_apply_q8`` where the rule
    has one, else dequantized on read and requantized on write.
    Returns the new params (the storage-dtype view of the new weight
    buffer) and the new slots, including the new weight or master buffer.
    """
    gbuf = grads.buf if isinstance(grads, PackedGrads) \
        else packing.pack(layout, grads)
    if rule.needs_grad_sq:
        # the square of the f32 gradient: pack casts to f32 first, so
        # squaring the packed buffer is the reference's square-then-pack
        ctx = dict(ctx, grad_sq=torch.square(gbuf))
    q8_kernel = quant and rule.packed_apply_q8 is not None
    if quant and not q8_kernel:
        slots = {k: packing.dequantize_q8(layout, slots[k],
                                          slots[k + SCALE_SUFFIX])
                 for k in rule.slots}
    u, slots = rule.direction(ctx, gbuf, wbuf, dict(slots))
    if rule.trust is None:
        wbuf2, new_slots = rule.apply(ctx, wbuf, gbuf, u, lr, slots)
    else:
        if rule.packed_norms is not None:
            w_norm, u_norm = rule.packed_norms(layout, wbuf, u)
        else:
            w_norm, u_norm = packing.slice_norms(layout, wbuf, u)
        ratio = rule.trust(ctx, w_norm, u_norm)
        if rule.skip_adaptation_1d:
            ratio = torch.where(packing.adapt_mask(layout, ratio.device),
                                ratio, torch.ones_like(ratio))
        if rule.packed_apply is not None:
            apply = rule.packed_apply_q8 if q8_kernel else rule.packed_apply
            wbuf2, new_slots = apply(layout, wbuf, gbuf, u, lr * ratio,
                                     slots)
        else:
            wbuf2, new_slots = rule.apply(
                ctx, wbuf, gbuf, u, lr * packing.rows_expand(layout, ratio),
                slots)
    if quant and not q8_kernel:
        for k in rule.slots:
            new_slots[k], new_slots[k + SCALE_SUFFIX] = \
                packing.quantize_q8(layout, new_slots[k])
    if master:
        new_slots[packing.MASTER_SLOT] = wbuf2
    else:
        wbuf2 = packing.quantize_to_storage(layout, wbuf2)
        new_slots[packing.WEIGHT_SLOT] = wbuf2
    return packing.unpack(layout, wbuf2), new_slots


def make_optimizer(rule: LayerwiseRule, learning_rate: float | Schedule, *,
                   slot_dtype: str = "f32", use_kernels: bool | str = "auto",
                   hyperparams: Optional[dict] = None) -> Optimizer:
    """Build an :class:`Optimizer` from a rule. ``use_kernels`` is the
    rule's kernel option (LARS's): ``True`` refuses tree-layout states,
    which have no kernel path, as the reference's ``use_pallas=True``
    refuses them."""
    lr_fn = as_schedule(learning_rate)
    if slot_dtype not in SLOT_DTYPES:
        raise ValueError(f"unknown slot_dtype {slot_dtype!r}; "
                         f"have {SLOT_DTYPES}")
    quant = slot_dtype == "int8"

    def init(params: Pytree, stacked: Optional[Pytree] = None,
             master: bool = False) -> OptState:
        if stacked is None:
            return OptState(step=0, slots=_tree_slots(params, master))
        layout = packing.build_layout(params, normalize_stacked(params,
                                                                stacked))
        weights = packing.pack(layout, params)
        slots = {}
        for k in rule.slots:
            zeros = torch.zeros_like(weights)
            if quant:
                # 0 codes, unit scales: what quantizing f32 zeros gives
                slots[k], slots[k + SCALE_SUFFIX] = \
                    packing.quantize_q8(layout, zeros)
            else:
                slots[k] = zeros
        slots[packing.MASTER_SLOT if master else packing.WEIGHT_SLOT] = \
            weights
        return OptState(step=0, slots=slots, layout=layout)

    def _tree_slots(params: Pytree, master: bool) -> dict:
        """Slot trees: f32 zeros per leaf, or their int8 codes (0) and
        unit scales, and an f32 copy of the params as the master."""
        slots = {}
        for k in rule.slots:
            zeros = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            if quant:
                slots[k], slots[k + SCALE_SUFFIX] = _split_pairs(
                    tree_map(packing.quantize_leaf_q8, zeros))
            else:
                slots[k] = zeros
        if master:
            slots[packing.MASTER_SLOT] = tree_map(
                lambda p: p.to(torch.float32, copy=True), params)
        return slots

    def update(grads: Pytree | PackedGrads, state: OptState, params: Pytree,
               stacked: Optional[Pytree] = None
               ) -> tuple[Pytree, OptState]:
        slots = dict(state.slots)
        lr = float(lr_fn(state.step))
        ctx = rule.prepare(state.step) if rule.prepare is not None else {}
        if state.layout is None:
            new_params, new_slots = tree_update(grads, slots, params,
                                                stacked, lr, ctx)
        else:
            if stacked is not None:
                packing.check_marker(state.layout, params, stacked)
            master = packing.MASTER_SLOT in slots
            weights = slots.pop(packing.MASTER_SLOT if master
                                else packing.WEIGHT_SLOT)
            new_params, new_slots = _packed_update(
                rule, state.layout, lr, ctx, grads, slots, weights,
                master=master, quant=quant)
        return new_params, OptState(step=state.step + 1, slots=new_slots,
                                    layout=state.layout)

    def tree_update(grads, slots, params, stacked, lr, ctx):
        if use_kernels is True:
            raise ValueError(
                f"{rule.name}(use_kernels=True) requires the flat-packed "
                "layout: build the state with init(params, stacked="
                "marker). Tree-layout states (init(params)) run the "
                "per-leaf torch path only.")
        if isinstance(grads, PackedGrads):
            raise ValueError(
                "PackedGrads requires the flat-packed layout; tree-"
                "layout states take param-shaped gradient pytrees")
        master = slots.pop(packing.MASTER_SLOT, None)
        if quant:
            slots = {k: tree_map(packing.dequantize_leaf_q8, slots[k],
                                 slots[k + SCALE_SUFFIX])
                     for k in rule.slots}
        new_params, new_slots = _tree_update(
            rule, lr, ctx, grads, slots, params,
            normalize_stacked(params, stacked), master=master)
        if quant:
            for k in rule.slots:
                new_slots[k], new_slots[k + SCALE_SUFFIX] = _split_pairs(
                    tree_map(packing.quantize_leaf_q8, new_slots[k]))
        return new_params, new_slots

    return Optimizer(name=rule.name, init=init, update=update,
                     hyperparams=dict(hyperparams or {}))


def _split_pairs(packs: Pytree) -> tuple[Pytree, Pytree]:
    """Tree of (a, b) tuples -> (tree of a, tree of b)."""
    return (tree_map(lambda t: t[0], packs), tree_map(lambda t: t[1], packs))


# ------------------------------------------------------------------ helpers

def adam_moments(b1: float, b2: float, eps: float, weight_decay: float
                 ) -> tuple[Callable, Callable]:
    """Shared (prepare, direction) for the Adam family.

    AdamW and LAMB are the same bias-corrected moment update; they differ
    only in the trust ratio applied afterwards (None vs phi(||w||)/||u||).
    The bias corrections ``1 - b**t`` are f32, as the reference's
    ``jnp.power`` gives them (numpy's f32 ``power`` can differ from it
    by an ulp), and divide as device scalars: PyTorch's CUDA division by
    a host scalar multiplies by its reciprocal instead.
    """

    def prepare(step: int) -> dict:
        t = np.float32(step + 1)
        one = np.float32(1.0)
        return {"c1": one - np.power(np.float32(b1), t),
                "c2": one - np.power(np.float32(b2), t)}

    def direction(ctx, g, w, slots):
        c1, c2 = (g.new_full((), float(ctx[k])) for k in ("c1", "c2"))
        mu = b1 * slots["mu"] + (1 - b1) * g
        gsq = ctx.get("grad_sq")
        nu = b2 * slots["nu"] + (1 - b2) * (
            torch.square(g) if gsq is None else gsq)
        u = (mu / c1) / (torch.sqrt(nu / c2) + eps) + weight_decay * w
        return u, {"mu": mu, "nu": nu}

    return prepare, direction


def as_schedule(lr: float | Schedule) -> Schedule:
    """Promote a constant learning rate to a schedule."""
    if callable(lr):
        return lr
    value = np.float32(lr)
    return lambda step: value


def normalize_stacked(params: Pytree, stacked: Optional[Pytree]) -> Pytree:
    """Return a full bool tree mirroring params (all False for None)."""
    if stacked is None:
        return tree_map(lambda p: False, params)
    return tree_map(lambda p, s: bool(s), params, stacked)
