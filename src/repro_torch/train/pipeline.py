"""Large-batch execution pipeline: microbatched gradient accumulation,
the bf16/f32 precision policy, and data-parallel meshes with ZeRO-sharded
optimizer states (port of ``repro/train/pipeline.py``).

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

* **Data-parallel mesh** (``mesh=``, a
  :class:`~repro_torch.launch.mesh.Mesh` whose ``model`` axis is 1; one
  process per rank over ``torch.distributed``). Every rank holds the
  params whole and takes its rows of the global batch as
  :func:`~repro_torch.distributed.sharding.batch_pspecs` cuts them — a
  :class:`~repro_torch.distributed.sharding.LocalBatch` from
  ``ShardedLoader(mesh=)`` as it is, a global batch dict cut here; a
  batch the data axis does not divide is replicated, as in the
  reference, and then nothing is reduced. Each rank accumulates its
  microbatches locally, then the mean gradient is reduced across the
  ``data`` group ONCE per global step: with ``zero=False`` one
  ``all_reduce`` of the packed gradient and the full update on every
  rank; with ``zero=True`` one reduce-scatter into this rank's row shard
  and the update on its rows (:mod:`repro_torch.core.optim_base`). The
  reference reduces once per microbatch (GSPMD reduces each
  microbatch's gradient inside its scan): the port sums a rank's
  microbatches first and the ranks after, which re-brackets the sum
  (held by tests/test_torch_zero.py). The loss and aux loss are the
  mean over the ranks. A rank's microbatch is a block of its own
  contiguous rows; the mean gradient is the reference's. The moe family
  is the exception: its routing couples the tokens of a microbatch
  through the experts' capacity, so with ``accum_steps`` k > 1 each
  rank's rows are cut as its block of each of the k global microbatches
  (``row_blocks``; ``shard_rows(blocks=)``, ``ShardedLoader(blocks=)``),
  and its microbatch i is its block of the reference's microbatch i.
  The forward runs within ``constrain.rows_over_data``, and the MoE
  blocks route the global microbatch, as the reference's GSPMD program
  does (:mod:`repro_torch.models.moe`: capacity, dropped slots and the
  load-balance loss of the global microbatch; the ranks' mean aux loss
  and gradient are the reference's).
* **Tensor-parallel mesh** (a ``model`` axis larger than 1; the dense
  and moe families, with GQA or MLA attention, and LeNet, whose specs
  are all replicated; the ssm, hybrid, encdec and vlm families raise
  ``NotImplementedError`` naming queue 1 item 4b-ii). The params are
  this rank's blocks as :func:`~repro_torch.distributed.sharding.
  model_pspecs` cuts them (``param_shardings``); the forward and
  backward are Megatron's, with expert parallelism in the MoE blocks
  (:mod:`repro_torch.models.lm`, :mod:`repro_torch.models.moe`), and
  ranks in one ``data`` row take the same batch rows. A packed optimizer
  state is the GLOBAL one, as the reference's ``state_pspecs`` keeps it
  (replicated over ``model``; with ZeRO, rows over ``data``): once per
  global step the split leaves' gradients are all-gathered over
  ``model`` into whole leaves, packed and reduced over ``data`` as on a
  data-parallel mesh, the update runs as there (one ``norms_flat`` and
  one apply a rank, on the global rows or the ZeRO shard) and the new
  params are cut to this rank's blocks again. A tree state is sharded
  like the params: its slots are this rank's blocks, reduced over
  ``data`` only, and the tree engine sums a split leaf's squared norms
  over ``model`` (``Optimizer.update(shardings=)``).
* ``fuse_update`` follows the reference's rules under a mesh: ``"auto"``
  fuses only in ZeRO mode on a pure data-parallel mesh and runs unfused
  on a ``model`` axis larger than 1; ``True`` is valid on a pure
  data-parallel mesh only (the reference's ``ValueError`` otherwise).

Typical use::

    pipe = TrainPipeline(model, opt, cfg, accum_steps=8, precision="bf16")
    state = pipe.init_state(torch.Generator().manual_seed(0), "cuda")
    for batch in ShardedLoader(host_batches, "cuda"):
        state, metrics = pipe(state, batch)

and on a mesh (under ``torchrun``; see ``launch/train.py``)::

    mesh = mesh_from_spec("auto")
    pipe = TrainPipeline(model, opt, cfg, mesh=mesh, zero=True)
    state = pipe.init_state(torch.Generator().manual_seed(0))
    for batch in ShardedLoader(host_batches, mesh.device, mesh=mesh,
                               spec=pipe.batch_specs(B),
                               blocks=pipe.row_blocks):
        state, metrics = pipe(state, batch)
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.optim_base import PackedGrads
from repro_torch.distributed import collectives
from repro_torch.distributed.constrain import rows_over_data
from repro_torch.distributed.sharding import (LocalBatch, batch_pspecs,
                                              check_model_parallel,
                                              gather_params, param_shardings,
                                              shard_leaf, shard_params,
                                              shard_rows, tree_named)
from repro_torch.train.state import (PRECISIONS, Precision,  # noqa: F401
                                     TrainState, cast_floats,
                                     create_train_state, get_precision)
from repro_torch.train.step import apply_update, value_and_grad
from repro_torch.treepath import (tree_flatten_with_path, tree_leaves,
                                  tree_map, tree_unflatten)

FUSE_ERROR = (
    "fuse_update=True needs accum_steps > 1, a flat-packed opt state, and "
    "no mesh or a pure data-parallel mesh (model axis size 1); use "
    "fuse_update='auto' to fall back silently")


class TrainPipeline:
    """Train step: accumulate over microbatches, update once."""

    def __init__(self, model, optimizer, cfg=None, *, accum_steps: int = 1,
                 precision: str | Precision = "f32", mesh=None,
                 donate: bool = True, packed: bool = True,
                 fuse_update: bool | str = "auto", zero: bool = False,
                 stats_fn: Optional[Callable] = None):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if fuse_update not in (True, False, "auto"):
            raise ValueError(f"fuse_update must be True/False/'auto', "
                             f"got {fuse_update!r}")
        if zero:
            if mesh is None:
                raise ValueError(
                    "zero=True (ZeRO-sharded optimizer states) requires "
                    "a mesh — the slots shard across its 'data' axis")
            if not packed:
                raise ValueError(
                    "zero=True requires the flat-packed substrate "
                    "(packed=True): ZeRO shards the superbuffer rows")
            if "data" not in mesh.axis_names:
                raise ValueError(
                    f"zero=True needs a mesh with a 'data' axis, got "
                    f"axes {mesh.axis_names}")
        if mesh is not None:
            if not all(hasattr(mesh, a) for a in ("shape", "axis_names",
                                                  "coords", "device")):
                raise TypeError(f"mesh must be a repro_torch.launch.mesh."
                                f"Mesh, got {type(mesh).__name__}")
            tp = {a: mesh.shape[a] for a in mesh.axis_names
                  if a not in ("data", "pod") and mesh.shape[a] > 1}
            if tp and fuse_update is True:
                raise ValueError(FUSE_ERROR)
            check_model_parallel(cfg if cfg is not None else model.cfg,
                                 mesh)
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg if cfg is not None else model.cfg
        self.accum_steps = accum_steps
        self.precision = get_precision(precision)
        self.mesh = mesh
        self.donate = donate
        self.packed = packed
        self.fuse_update = fuse_update
        # ZeRO: row-shard every packed slot across the mesh's data axis
        self.zero = zero
        self._zero_shards = int(mesh.shape["data"]) if zero else 1
        self.stats_fn = stats_fn
        # the moe family routes each global microbatch together: each
        # rank's rows are its block of every microbatch
        self.row_blocks = accum_steps if (
            mesh is not None and self.cfg.family == "moe"
            and mesh.shape["data"] > 1) else 1
        self._peak_bytes: Optional[int] = None
        self._card_steps = 0
        # tensor parallelism: the whole params' shapes (a meta init,
        # ``whole_params``) and one LeafSharding a leaf; None without a
        # model axis above 1
        self._tp = collectives.model_parallel(mesh)
        self.whole_params = self.param_shardings = None
        if self._tp is not None:
            self.whole_params = model.init(torch.Generator(), "meta")
            self.param_shardings = param_shardings(self.cfg,
                                                   self.whole_params,
                                                   mesh)

    def mesh_context(self):
        """``with pipe.mesh_context():`` makes the pipeline's mesh the
        ambient one (nothing without a mesh): what a ZeRO state's
        checkpoint save and restore need around them."""
        return self.mesh if self.mesh is not None \
            else contextlib.nullcontext()

    def init_state(self, generator: torch.Generator,
                   device: Optional[torch.device | str] = None
                   ) -> TrainState:
        """Fresh TrainState on ``device`` from ``model.init``. On a mesh
        the device defaults to the mesh's (every rank draws the same
        params from the same generator), and a ZeRO state holds this
        rank's row shard of every slot."""
        if self.mesh is not None:
            mine = self.mesh.device
            if device is not None and torch.device(device) not in (
                    mine, torch.device(mine.type)):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mine}")
            device = mine
        elif device is None:
            raise ValueError("init_state needs a device without a mesh")
        with self.mesh_context():
            return create_train_state(
                self.model, self.optimizer, generator, device=device,
                packed=self.packed, precision=self.precision,
                zero_shards=self._zero_shards, mesh=self.mesh)

    def place_state(self, state: TrainState) -> TrainState:
        """A (host or restored) state on the mesh's device, each ZeRO slot
        cut to this rank's row shard and, on a tensor-parallel mesh,
        each whole param cut to this rank's block; the state as it is
        without a mesh."""
        if self.mesh is None:
            return state
        dev = self.mesh.device
        opt = state.opt_state
        move = lambda t: t.to(dev)                          # noqa: E731
        params = tree_map(move, state.params)
        if self._tp is not None:
            params = tree_map(
                lambda x, w, sh: shard_leaf(x, sh)
                if tuple(x.shape) == tuple(w.shape) else x,
                params, self.whole_params, self.param_shardings)
        with self.mesh:
            slots = {k: packing.constrain_rows(opt.layout, move(v))
                     if opt.layout is not None else tree_map(move, v)
                     for k, v in opt.slots.items()}
        return TrainState(params=params,
                          opt_state=type(opt)(step=opt.step, slots=slots,
                                              layout=opt.layout))

    def save(self, path: str, state: TrainState) -> None:
        """``save_train_state`` under the pipeline's mesh: a ZeRO state's
        rows and a tensor-parallel state's params and tree slots are
        gathered first (collective: every rank calls it; rank 0
        writes, and every rank returns once the file is there)."""
        from repro_torch.checkpoint import save_train_state
        with self.mesh_context():
            save_train_state(path, state, shardings=self.param_shardings)
        for axis in ("model", "data"):
            collectives.barrier(self.mesh, axis)

    def restore(self, path: str, template: TrainState) -> TrainState:
        """``restore_train_state`` under the pipeline's mesh: each rank
        keeps its ZeRO rows and its blocks of the split leaves."""
        from repro_torch.checkpoint import restore_train_state
        with self.mesh_context():
            return restore_train_state(path, template,
                                       shardings=self.param_shardings)

    def batch_specs(self, global_batch: int):
        """PartitionSpecs a host loader should place batches with."""
        if self.mesh is None:
            raise ValueError("batch_specs requires a mesh-aware pipeline")
        return batch_pspecs(self.cfg, self.mesh, batch=global_batch)

    def local_batch(self, batch) -> LocalBatch:
        """This rank's part of a global batch dict (a LocalBatch, e.g.
        from ``ShardedLoader(mesh=, blocks=pipe.row_blocks)``, as it
        is), cut in ``row_blocks`` blocks."""
        if isinstance(batch, LocalBatch):
            if batch.sharded and batch.blocks != self.row_blocks:
                raise ValueError(
                    f"a batch cut in {batch.blocks} row blocks; this "
                    f"pipeline takes {self.row_blocks} (ShardedLoader("
                    "blocks=pipe.row_blocks))")
            return batch
        rows = next(iter(batch.values())).shape[0]
        return shard_rows(batch, tree_named(self.mesh,
                                            self.batch_specs(rows)),
                          blocks=self.row_blocks)

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
        with self.mesh_context():
            return self._local_step(state, batch)

    def _grads(self, params, batch, rows_mesh):
        """``value_and_grad`` on this rank's rows (of ``rows_mesh``'s
        ``data`` axis, or a whole batch where it is None)."""
        with rows_over_data(rows_mesh):
            return value_and_grad(self.model, self.cfg, params, batch)

    def _local_step(self, state: TrainState, batch
                    ) -> tuple[TrainState, dict]:
        model, k, mesh = self.model, self.accum_steps, self.mesh
        # the ranks' gradients differ only where their batch rows do; over
        # a one-rank data axis the reduction is the identity (sent through
        # the backend where a process group holds the axis)
        reduce = False
        if mesh is not None:
            batch = self.local_batch(batch)
            reduce = batch.sharded
        rows_mesh = mesh if reduce else None
        batch = cast_floats(batch, self.precision.compute_dtype)
        layout = state.opt_state.layout
        # never on a model axis above 1: the gradients are blocks there
        can_fuse = k > 1 and layout is not None and self._tp is None
        if self.fuse_update is True and not can_fuse:
            raise ValueError(FUSE_ERROR)
        # "auto" fuses off-mesh and in ZeRO mode, as the reference's does
        fuse = can_fuse and (self.fuse_update is True or (
            self.fuse_update is not False and (mesh is None or self.zero)))
        stacked = model.stacked_marker(state.params) if self.packed \
            else None
        if k == 1:
            # make_train_step's step
            loss, grads, (_, aux) = self._grads(state.params, batch,
                                                rows_mesh)
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
                loss, g, (_, aux) = self._grads(state.params, mb, rows_mesh)
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
        shardings = self.param_shardings
        if shardings is not None and layout is not None:
            # the global packed state takes whole leaves: one all-gather
            # over model of each split leaf's gradient, once a step,
            # packed at once (the whole tree is freed before the update)
            grads = PackedGrads(packing.pack(
                layout, gather_params(grads, shardings)))
        if reduce:
            grads = self._reduce_grads(grads, layout)
            both = collectives.all_reduce_sum(torch.stack(
                [loss.float(), torch.as_tensor(aux_loss).float().to(
                    loss.device)]), mesh)
            loss, aux_loss = torch.div(both, mesh.shape["data"]).unbind()
        stats = None
        if self.stats_fn is not None:
            # taken before the update, on the params the update starts
            # from, as the reference's step reads them
            stat_grads = packing.unpack(
                layout, packing.gather_rows(layout, grads.buf),
                dtype=torch.float32) \
                if isinstance(grads, PackedGrads) else grads
            stat_params = state.params
            if shardings is not None:
                # whole leaves, as the reference's step reads them
                stat_params = gather_params(stat_params, shardings)
                if layout is None:
                    stat_grads = gather_params(stat_grads, shardings)
            stats = self.stats_fn(stat_params, stat_grads, stacked)
        state, metrics = apply_update(
            self.optimizer, state, grads, loss, aux_loss, stacked,
            shardings if layout is None else None)
        del grads                   # the packed gradient, before the cut
        if shardings is not None and layout is not None:
            state = state._replace(params=shard_params(state.params,
                                                       shardings))
        if stats is not None:
            metrics["stats"] = stats
        return state, metrics

    def _reduce_grads(self, grads, layout):
        """The mean over the data ranks of their mean gradients, in one
        collective: packed, a reduce-scatter into this rank's row shard
        (ZeRO) or an all-reduce of the whole buffer; on a tree state one
        all-reduce of every leaf flattened into one f32 buffer."""
        mesh, ranks = self.mesh, self.mesh.shape["data"]
        if layout is not None:
            buf = grads.buf if isinstance(grads, PackedGrads) \
                else packing.pack(layout, grads)
            if self.zero:
                buf = collectives.reduce_scatter_rows(buf, mesh)
            else:
                buf = collectives.all_reduce_sum(buf, mesh)
            return PackedGrads(torch.div(buf, ranks))
        leaves, treedef = tree_flatten_with_path(grads)
        flat = collectives.all_reduce_sum(torch.cat(
            [g.float().reshape(-1) for _, g in leaves]), mesh)
        flat = torch.div(flat, ranks)
        out, at = [], 0
        for _, g in leaves:
            out.append(flat[at:at + g.numel()].view(g.shape))
            at += g.numel()
        return tree_unflatten(treedef, out)
