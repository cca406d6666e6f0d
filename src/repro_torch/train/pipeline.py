"""Large-batch execution pipeline: microbatched gradient accumulation and
the bf16/f32 precision policy (port of ``repro/train/pipeline.py``, one
device, no mesh).

The paper's point is scaling the *global* batch without losing accuracy
(LARS); You et al. reach 16K-32K batches only through gradient
accumulation + LR scaling/warmup + mixed precision. :class:`TrainPipeline`
is that execution layer:

* **Accumulation** — the global batch ``(B, ...)`` is split into
  ``accum_steps`` microbatches of ``B / accum_steps``, run one after the
  other in an eager loop, and the optimizer update, hence the LARS trust
  ratio, runs once per global batch on the mean gradient. On a packed
  state the microbatch gradients are summed in f32 directly into the
  packed ``(rows, lane)`` buffer (the reference's fused update,
  ``fuse_update="auto"`` or ``True``); unfused (``fuse_update=False``,
  and always on a tree state) they are summed into an f32 tree, scaled
  by ``1/k`` and handed to the update as a tree. With ``accum_steps=1``
  the step is :func:`repro_torch.train.step.make_train_step`'s.
* **Layout** — ``packed=True`` (default) builds states on the flat-packed
  substrate and hands the update the model's stacked marker;
  ``packed=False`` builds per-leaf tree states (the tree engine) and, as
  the reference's pipeline, hands the update no marker, so each leaf's
  trust ratio is taken over the whole leaf.
* **Precision policy** — ``"f32"`` leaves every dtype alone; ``"bf16"``
  stores params and runs forward/backward in bfloat16 while the
  optimizer keeps f32 master weights in the packed superbuffer, or an
  f32 tree on a tree state (:data:`repro_torch.core.packing.MASTER_SLOT`),
  and gradients accumulate in f32. Batch float leaves are cast to bf16
  inside the step; integer leaves (LM tokens) pass through. The policy
  itself (:class:`Precision`) lives in :mod:`repro_torch.train.state`.
* **Statistics hook** — ``stats_fn(params, grads, stacked)`` (e.g.
  :func:`repro_torch.core.grad_stats.stats_hook`) runs on the pre-update
  params and the mean gradient of the global batch; its table rides back
  on the device under ``metrics["stats"]``.

``donate`` is taken as the reference takes it. The reference donates the
state to its jitted step (``donate=True``) or keeps the caller's state
alive (``False``); the port's eager step never frees or overwrites the
caller's state, which is what ``False`` promises and ``True`` permits,
so both run the same step.

Not yet ported: meshes and ZeRO-sharded optimizer states.

Typical use::

    pipe = TrainPipeline(model, opt, cfg, accum_steps=8, precision="bf16")
    state = pipe.init_state(torch.Generator().manual_seed(0), "cuda")
    for batch in ShardedLoader(host_batches, "cuda"):
        state, metrics = pipe(state, batch)
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.optim_base import PackedGrads
from repro_torch.train.state import (PRECISIONS, Precision,  # noqa: F401
                                     TrainState, cast_floats,
                                     create_train_state, get_precision)
from repro_torch.train.step import apply_update, value_and_grad
from repro_torch.treepath import tree_leaves, tree_map


class TrainPipeline:
    """Train step: accumulate over microbatches, update once."""

    def __init__(self, model, optimizer, cfg=None, *, accum_steps: int = 1,
                 precision: str | Precision = "f32", mesh=None,
                 donate: bool = True, packed: bool = True,
                 fuse_update: bool | str = "auto", zero: bool = False,
                 stats_fn: Optional[Callable] = None):
        if mesh is not None or zero:
            raise NotImplementedError(
                "TrainPipeline's mesh and zero are not yet ported to "
                "repro_torch")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if fuse_update not in (True, False, "auto"):
            raise ValueError(f"fuse_update must be True/False/'auto', "
                             f"got {fuse_update!r}")
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg if cfg is not None else model.cfg
        self.accum_steps = accum_steps
        self.precision = get_precision(precision)
        self.donate = donate
        self.packed = packed
        self.fuse_update = fuse_update
        self.stats_fn = stats_fn
        self._peak_bytes: Optional[int] = None
        self._card_steps = 0

    def init_state(self, generator: torch.Generator,
                   device: torch.device | str) -> TrainState:
        """Fresh TrainState on ``device`` from ``model.init``."""
        return create_train_state(self.model, self.optimizer, generator,
                                  device=device, packed=self.packed,
                                  precision=self.precision)

    def peak_bytes(self, batch) -> Optional[int]:
        """Peak device memory of one step on ``batch``'s device, in bytes;
        ``None`` on the CPU.

        It is read from the CUDA caching allocator, not from XLA's
        compile-time memory analysis (the reference's ``compiled_peak_bytes``), so the
        two packages' numbers do not compare. It is taken over the
        pipeline's second step on the card (the first may allocate
        cuBLAS's one-time workspace): the peak of the bytes the step's
        tensors requested from the caching allocator (its
        ``requested_bytes`` statistics) after ``reset_peak_memory_stats``,
        less what was requested when the step began, plus the step's
        inputs (state and batch). Requested bytes, not the allocator's
        blocks: a cached block it hands out unsplit counts whole, so
        ``max_memory_allocated`` depends on what the pool held before the
        step, and a resumed run would read another peak. Cached per
        pipeline; where fewer than two steps have run on the card, steps
        of a fresh state (seed 0) on ``batch`` measure it.
        """
        first = next(iter(batch.values()))
        if not first.is_cuda:
            return None
        if self._peak_bytes is None:
            state = self.init_state(torch.Generator().manual_seed(0),
                                    first.device)
            while self._peak_bytes is None:
                state, _ = self(state, batch)
        return self._peak_bytes

    def __call__(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        if self._peak_bytes is None and next(iter(batch.values())).is_cuda:
            self._card_steps += 1
            if self._card_steps == 2:
                return self._measured_step(state, batch)
        return self._step(state, batch)

    def _measured_step(self, state: TrainState, batch
                       ) -> tuple[TrainState, dict]:
        dev = next(iter(batch.values())).device
        # tensors held only by reference cycles would otherwise be freed
        # whenever the collector runs, inside the window or not
        gc_enabled = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_stats(dev)[
                "requested_bytes.all.current"]
            torch.cuda.reset_peak_memory_stats(dev)
            out = self._step(state, batch)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"]
        finally:
            if gc_enabled:
                gc.enable()
        inputs = {}                          # by storage: views count once
        for leaf in tree_leaves(state.params) + tree_leaves(
                state.opt_state.slots) + tree_leaves(batch):
            st = leaf.untyped_storage()
            inputs[st.data_ptr()] = st.nbytes()
        self._peak_bytes = int(peak - before + sum(inputs.values()))
        return out

    def _step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        model, cfg, k = self.model, self.cfg, self.accum_steps
        batch = cast_floats(batch, self.precision.compute_dtype)
        layout = state.opt_state.layout
        can_fuse = k > 1 and layout is not None
        if self.fuse_update is True and not can_fuse:
            raise ValueError(
                "fuse_update=True needs accum_steps > 1, a flat-packed "
                "opt state, and no mesh or a pure data-parallel mesh "
                "(model axis size 1); use fuse_update='auto' to fall "
                "back silently")
        fuse = can_fuse and self.fuse_update is not False
        stacked = model.stacked_marker(state.params) if self.packed \
            else None
        if k == 1:
            # make_train_step's step
            loss, grads, (_, aux) = value_and_grad(model, cfg, state.params,
                                                   batch)
            aux_loss = aux["aux_loss"]
        else:
            first = next(iter(batch.values()))
            b, n = first.shape[0], first.shape[0] // k
            if b % k:
                raise ValueError(f"global batch {b} not divisible by "
                                 f"accum_steps={k}")
            if fuse:
                gsum = torch.zeros(layout.buffer_shape, dtype=torch.float32,
                                   device=first.device)
            else:
                gsum = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device),
                    state.params)
            lsum = asum = torch.zeros((), dtype=torch.float32,
                                      device=first.device)
            for i in range(k):
                mb = {key: v[i * n:(i + 1) * n] for key, v in batch.items()}
                loss, g, (_, aux) = value_and_grad(model, cfg, state.params,
                                                   mb)
                if fuse:
                    # pack casts to f32 before the add: the sum is in f32
                    # even when the gradients are bf16, and each element
                    # sees the tree carry's chain of f32 additions
                    gsum = gsum + packing.pack(layout, g)
                else:
                    gsum = tree_map(lambda a, gi: a + gi.float(), gsum, g)
                lsum = lsum + loss
                asum = asum + aux["aux_loss"]
            # equal-size microbatches + mean losses: the mean of the
            # microbatch mean gradients IS the full-batch mean gradient, so
            # the (single) LARS trust ratio matches one step on the whole
            # global batch
            inv = 1.0 / k
            grads = PackedGrads(gsum * inv) if fuse \
                else tree_map(lambda g: g * inv, gsum)
            loss, aux_loss = lsum * inv, asum * inv
        stats = None
        if self.stats_fn is not None:
            # taken before the update, on the params the update starts
            # from, as the reference's step reads them
            stat_grads = packing.unpack(layout, grads.buf,
                                        dtype=torch.float32) \
                if isinstance(grads, PackedGrads) else grads
            stats = self.stats_fn(state.params, stat_grads, stacked)
        state, metrics = apply_update(self.optimizer, state, grads, loss,
                                      aux_loss, stacked)
        if stats is not None:
            metrics["stats"] = stats
        return state, metrics
