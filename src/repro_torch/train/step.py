"""Train/eval step factories for every model family (port of
``repro/train/step.py``). A step is an eager function (TrainState,
batch) -> (TrainState, metrics): autograd for the gradients, then the
optimizer update. The metrics stay on the device; reading them is the
caller's choice. The batch's contents follow the family:

  cnn      {"x": images (B,28,28,1), "y": labels (B,)}
  lm       {"tokens": (B, S)}              loss: predict [1:] from [:-1]
  vlm      {"tokens", "image_embeddings"}  prefix-LM loss mask
  encdec   {"tokens", "frames"}            teacher-forced decoder loss

With ``loss_chunk > 0`` the LM's loss runs chunked over the sequence
(:func:`~repro_torch.train.losses.chunked_lm_loss`) and the step returns
no logits; evaluation always takes the whole logits. The encdec family
always takes the whole logits, as the reference. The MoE family's loss
adds its load-balance ``aux_loss`` (0 for the other families).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.train.losses import (chunked_lm_loss, classification_loss,
                                      lm_loss)
from repro_torch.train.metrics import accuracy
from repro_torch.train.state import TrainState
from repro_torch.treepath import (tree_flatten_with_path, tree_leaves,
                                  tree_unflatten)

Pytree = Any


def _forward_and_loss(model, cfg, params, batch):
    """(loss, (logits, aux)) for any family; logits are None on the
    chunked-loss path. The vlm family's logits come back without the
    image prefix, so they line up with the text tokens."""
    if cfg.family == "cnn":
        logits, aux = model.forward(params, batch["x"])
        return classification_loss(logits, batch["y"]), (logits, aux)
    if cfg.family == "encdec":
        logits, aux = model.forward(params, batch["tokens"],
                                    frames=batch["frames"])
        loss = lm_loss(logits, batch["tokens"])
        return loss + aux["aux_loss"], (logits, aux)
    if cfg.family == "vlm":
        img = batch["image_embeddings"]
        n_img = img.shape[1]
        if cfg.loss_chunk:
            hidden, aux = model.forward(params, batch["tokens"],
                                        image_embeddings=img,
                                        return_hidden=True)
            loss = chunked_lm_loss(hidden[:, n_img:],
                                   model.unembed_matrix(params),
                                   batch["tokens"], chunk=cfg.loss_chunk)
            return loss + aux["aux_loss"], (None, aux)
        logits, aux = model.forward(params, batch["tokens"],
                                    image_embeddings=img)
        text_logits = logits[:, n_img:]
        loss = lm_loss(text_logits, batch["tokens"])
        return loss + aux["aux_loss"], (text_logits, aux)
    if cfg.loss_chunk:
        hidden, aux = model.forward(params, batch["tokens"],
                                    return_hidden=True)
        loss = chunked_lm_loss(hidden, model.unembed_matrix(params),
                               batch["tokens"], chunk=cfg.loss_chunk)
        return loss + aux["aux_loss"], (None, aux)
    logits, aux = model.forward(params, batch["tokens"])
    loss = lm_loss(logits, batch["tokens"])
    return loss + aux["aux_loss"], (logits, aux)


def value_and_grad(model, cfg, params: Pytree, batch
                   ) -> tuple[torch.Tensor, Pytree, tuple]:
    """(loss, grads, (logits, aux)): the loss and its gradient with
    respect to every leaf of ``params``; the aux values detached."""
    leaves, treedef = tree_flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in leaves]
    loss, (logits, aux) = _forward_and_loss(
        model, cfg, tree_unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), tree_unflatten(treedef, grads),
            (logits, {k: v.detach() for k, v in aux.items()}))


def apply_update(optimizer, state: TrainState, grads, loss, aux_loss,
                 stacked) -> tuple[TrainState, dict]:
    """One optimizer update from the step's gradients (a tree, or
    ``PackedGrads``), and the step's metrics. ``stacked`` is the marker
    the update gets (``None``: none, as the reference's
    ``TrainPipeline(packed=False)`` passes)."""
    new_params, new_opt = optimizer.update(
        grads, state.opt_state, state.params, stacked=stacked)
    metrics = {"loss": loss, "aux_loss": aux_loss, "step": new_opt.step}
    return TrainState(new_params, new_opt), metrics


def make_train_step(model, optimizer, cfg=None) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics dict)."""
    cfg = cfg if cfg is not None else model.cfg

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads, (_, aux) = value_and_grad(model, cfg, state.params,
                                               batch)
        return apply_update(optimizer, state, grads, loss, aux["aux_loss"],
                            model.stacked_marker(state.params))

    return step


def make_eval_step(model, cfg=None) -> Callable:
    """(params, batch) -> metrics {loss, accuracy}. The cnn family scores
    the class head directly against the labels; the LM's logit at
    position t predicts the token at t+1, so ``logits[:, :-1]`` is scored
    against ``tokens[:, 1:]`` (the vlm family's logits come without the
    image prefix, so the same shift holds). Evaluation takes the whole
    logits even where training runs the chunked loss."""
    cfg = cfg if cfg is not None else model.cfg
    if cfg.loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=0)

    @torch.no_grad()
    def step(params, batch) -> dict:
        # batch floats in the params' float dtype, so a bf16-policy state
        # evaluates on f32 host data
        dt = next(x.dtype for x in tree_leaves(params)
                  if x.is_floating_point())
        batch = {k: v.to(dt) if v.is_floating_point() else v
                 for k, v in batch.items()}
        loss, (logits, _) = _forward_and_loss(model, cfg, params, batch)
        if cfg.family == "cnn":
            acc = accuracy(logits, batch["y"])
        else:
            acc = accuracy(logits[:, :-1], batch["tokens"][:, 1:])
        return {"loss": loss, "accuracy": acc}

    return step
