"""Large-batch execution pipeline: microbatched gradient accumulation and
the bf16/f32 precision policy (port of ``repro/train/pipeline.py``, one
device, no mesh).

The paper's point is scaling the *global* batch without losing accuracy
(LARS); You et al. reach 16K-32K batches only through gradient
accumulation + LR scaling/warmup + mixed precision. :class:`TrainPipeline`
is that execution layer:

* **Accumulation** — the global batch ``(B, ...)`` is split into
  ``accum_steps`` microbatches of ``B / accum_steps``, run one after the
  other in an eager loop. Microbatch gradients are summed in f32 directly
  into the packed ``(rows, lane)`` buffer (the reference's fused update)
  and the optimizer update, hence the LARS trust ratio, runs once per
  global batch on the mean gradient. With ``accum_steps=1`` the step is
  :func:`repro_torch.train.step.make_train_step`'s.
* **Precision policy** — ``"f32"`` leaves every dtype alone; ``"bf16"``
  stores params and runs forward/backward in bfloat16 while the
  optimizer keeps f32 master weights in the packed superbuffer
  (:data:`repro_torch.core.packing.MASTER_SLOT`) and gradients
  accumulate in f32. Batch float leaves are cast to bf16 inside the
  step. The policy itself (:class:`Precision`) lives in
  :mod:`repro_torch.train.state`.

Not yet ported: meshes, ZeRO-sharded optimizer states, the per-step
statistics hook, and unfused (tree) accumulation, which the reference
keeps for those.

Typical use::

    pipe = TrainPipeline(model, opt, cfg, accum_steps=8, precision="bf16")
    state = pipe.init_state(torch.Generator().manual_seed(0), "cuda")
    for batch in batches:
        state, metrics = pipe(state, batch)
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.optim_base import PackedGrads
from repro_torch.train.state import (PRECISIONS, Precision,  # noqa: F401
                                     TrainState, cast_floats,
                                     create_train_state, get_precision)
from repro_torch.train.step import (apply_update, make_train_step,
                                    value_and_grad)


class TrainPipeline:
    """Train step: accumulate over microbatches, update once."""

    def __init__(self, model, optimizer, cfg=None, *, accum_steps: int = 1,
                 precision: str | Precision = "f32",
                 fuse_update: bool | str = "auto", mesh=None,
                 zero: bool = False, stats_fn=None):
        if mesh is not None or zero or stats_fn is not None \
                or fuse_update not in (True, "auto"):
            raise NotImplementedError(
                "TrainPipeline's mesh, zero, stats_fn and unfused "
                "(fuse_update=False) accumulation are not yet ported to "
                "repro_torch")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg if cfg is not None else model.cfg
        self.accum_steps = accum_steps
        self.precision = get_precision(precision)
        self._step = make_train_step(model, optimizer, self.cfg)

    def init_state(self, generator: torch.Generator,
                   device: torch.device | str) -> TrainState:
        """Fresh TrainState on ``device`` from ``model.init``."""
        return create_train_state(self.model, self.optimizer, generator,
                                  device=device, precision=self.precision)

    def __call__(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        model, cfg, k = self.model, self.cfg, self.accum_steps
        batch = cast_floats(batch, self.precision.compute_dtype)
        if k == 1:
            return self._step(state, batch)
        first = next(iter(batch.values()))
        b, n = first.shape[0], first.shape[0] // k
        if b % k:
            raise ValueError(f"global batch {b} not divisible by "
                             f"accum_steps={k}")
        layout = state.opt_state.layout
        gsum = torch.zeros(layout.buffer_shape, dtype=torch.float32,
                           device=first.device)
        lsum = asum = torch.zeros((), dtype=torch.float32,
                                  device=first.device)
        for i in range(k):
            mb = {key: v[i * n:(i + 1) * n] for key, v in batch.items()}
            loss, g, (_, aux) = value_and_grad(model, cfg, state.params, mb)
            # pack casts to f32 before the add: the sum is in f32 even
            # when the gradients are bf16
            gsum = gsum + packing.pack(layout, g)
            lsum = lsum + loss
            asum = asum + aux["aux_loss"]
        # equal-size microbatches + mean losses: the mean of the
        # microbatch mean gradients IS the full-batch mean gradient, so
        # the (single) LARS trust ratio matches one step on the whole
        # global batch
        inv = 1.0 / k
        return apply_update(model, self.optimizer, state,
                            PackedGrads(gsum * inv), lsum * inv, asum * inv)
