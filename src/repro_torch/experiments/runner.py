"""Grid execution: every cell through TrainPipeline, resumable mid-grid.
Port of ``repro/experiments/runner.py`` on one device. Two families run
through the same machinery (dispatch on ``grid.family``):

* ``cnn`` — the paper's LeNet/MNIST study: shuffled epoch-cycling
  minibatches from the procedural MNIST stand-in, metric = test
  accuracy;
* ``lm``  — token-LM cells on a ``reduced()`` smollm config: each cell
  streams seeded synthetic Markov-corpus batches
  (:func:`repro_torch.data.token_batches` — deterministic per cell,
  fast-forwardable), metric = eval perplexity on a fixed held-out token
  set; each step records its perplexity and tokens/s.

Layout of a run directory (the reference's)::

    out_dir/
      manifest.json              # grid fingerprint + completed-cell rows
      <cell_id>/trajectory.jsonl # one record per optimizer step
      <cell_id>/state.npz        # mid-cell checkpoint (deleted when done)

Resume contract (``run(resume=True)``):

* completed cells (present in the manifest) are skipped outright;
* a cell with a ``state.npz`` restores the full TrainState via
  :mod:`repro_torch.checkpoint.npz`, rewinds its JSONL to the
  checkpointed step, fast-forwards the seeded batch stream to that step
  — cnn cells replay the shuffle stream, lm cells rng-skip through
  ``token_batches(start=)`` — and continues; the completed trajectory is
  IDENTICAL to an uninterrupted run;
* the manifest's grid fingerprint must match the requested grid, so a
  stale directory cannot silently mix protocols.

Device: ``device`` (default ``"cuda"``; without CUDA the runner raises
rather than falling back). The runner switches TF32 off and cuDNN's
deterministic algorithms on for the process, so f32 means f32 on the
card and a resumed cell retraces the uninterrupted one bit for bit.

Init: :meth:`GridRunner.init_state` draws the model's init from a CPU
``torch.Generator`` seeded with the cell seed, so a cell starts from the
same parameters on the CPU and on the card. The reference draws
``jax.random.key(cell_seed)``, which torch cannot reproduce; the parity
tests override this one method to start from the reference's init.

Cells sharing a ``pipeline_key`` reuse one TrainPipeline. The cell
functions take a ``dir_name`` that overrides the cell's directory: a PBT
lineage (:mod:`repro_torch.experiments.controller`) keeps one directory
across generations. Not yet ported: mesh and ZeRO cells (they raise
``NotImplementedError``).
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.core import grad_stats
from repro_torch.data import (TokenTaskConfig, batch_iterator, place,
                              synthetic_mnist, token_batches,
                              token_eval_set)
from repro_torch.experiments.record import (TrajectoryRecorder,
                                            atomic_write_json, load_json,
                                            read_trajectory, to_jsonable,
                                            truncate_trajectory)
from repro_torch.experiments.spec import CellSpec, GridSpec
from repro_torch.models import build_model
from repro_torch.train import (TrainPipeline, TrainState,
                               generalization_error, make_eval_step)

# Test hook: abort the sweep (KeyboardInterrupt) after N recorded steps,
# as if the process had been killed mid-grid. Exercised by the resume
# tests both in-process and through the CLI.
ABORT_ENV = "REPRO_EXPERIMENT_ABORT_AFTER_STEPS"


def resolve_config(grid: GridSpec):
    """The model config a grid's cells train: the registered config for
    cnn grids, its ``reduced()`` CPU-scale variant (capped layers / width
    / vocab from the grid's model fields) for lm grids."""
    if grid.mesh or grid.zero:
        raise NotImplementedError(
            f"grid {grid.name!r}: mesh and zero cells are not yet ported "
            "to repro_torch.experiments")
    cfg = get_config(grid.arch)
    if grid.family == "cnn":
        if cfg.family != "cnn":
            raise ValueError(
                f"grid {grid.name!r}: family='cnn' needs a CNN arch "
                f"(got {grid.arch!r}, family {cfg.family!r})")
        return cfg
    if cfg.family == "cnn":
        raise ValueError(
            f"grid {grid.name!r}: family='lm' needs a token-LM arch "
            f"(got {grid.arch!r}, family {cfg.family!r})")
    if cfg.family in ("encdec", "vlm"):
        # the reference's runner feeds these too, and fails at the first
        # step: a forward of either family needs its stub input
        raise ValueError(
            f"grid {grid.name!r}: an lm grid feeds token batches only, and "
            f"the {cfg.family} family ({grid.arch!r}) also needs its stub "
            "frames or image embeddings, which the reference's runner "
            "does not feed either")
    return cfg.reduced(
        max_layers=grid.model_layers or 2,
        max_d_model=grid.model_d_model or 256,
        max_vocab=grid.vocab_size or 512)


class GridRunner:
    """Executes a :class:`GridSpec` cell by cell into ``out_dir``."""

    def __init__(self, grid: GridSpec, out_dir: str, *,
                 checkpoint_every: int = 25, collect_stats: bool = True,
                 record_memory: bool = True,
                 device: torch.device | str = "cuda",
                 log: Optional[Callable[[str], None]] = print):
        self.grid = grid
        self.out_dir = out_dir
        self.checkpoint_every = checkpoint_every
        self.collect_stats = collect_stats
        self.record_memory = record_memory
        self.log = log or (lambda _line: None)
        self.cfg = resolve_config(grid)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        self.model = build_model(self.cfg)
        self._eval_step = make_eval_step(self.model, self.cfg)
        self._pipelines: dict[tuple, TrainPipeline] = {}
        self._data = None
        self._eval_tokens = None
        self._steps_done = 0
        abort = os.environ.get(ABORT_ENV)
        self._abort_after = int(abort) if abort else None

    # ----------------------------------------------------------- pieces

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.out_dir, "manifest.json")

    def cell_dir(self, cell: CellSpec, dir_name: Optional[str] = None
                 ) -> str:
        """A cell's run directory. ``dir_name`` overrides the default
        cell_id key: a PBT lineage keeps ONE directory (its
        ``lineage_root``) across mutations even though its cell_id grows
        a generation suffix."""
        return os.path.join(self.out_dir, dir_name or cell.cell_id)

    def data(self):
        if self._data is None:
            self._data = synthetic_mnist(self.grid.n_train,
                                         self.grid.n_test,
                                         seed=self.grid.data_seed)
        return self._data

    def token_task(self) -> TokenTaskConfig:
        """The grid's shared Markov source (vocab matches the reduced
        model's; the transition table is a grid-level constant — only
        the per-cell sampling stream varies with the cell seed)."""
        return TokenTaskConfig(vocab_size=self.cfg.vocab_size,
                               seed=self.grid.data_seed)

    def eval_tokens(self) -> np.ndarray:
        if self._eval_tokens is None:
            self._eval_tokens = token_eval_set(
                self.token_task(), n=self.grid.n_test,
                seq_len=self.grid.seq_len, seed=self.grid.data_seed + 1)
        return self._eval_tokens

    def cell_batches(self, cell: CellSpec, *, start: int = 0):
        """The cell's deterministic batch stream, positioned at ``start``
        (mid-cell resume), each batch on the runner's device."""
        if self.grid.family == "cnn":
            x_tr, y_tr, _, _ = self.data()
            it = batch_iterator(x_tr, y_tr, batch=self.eff_batch(cell),
                                seed=cell.cell_seed())
            for _ in range(start):
                next(it)  # replay the shuffle stream
        else:
            it = ({"tokens": toks} for toks in token_batches(
                self.token_task(), batch=self.eff_batch(cell),
                seq_len=cell.seq_len, seed=cell.cell_seed(), start=start))
        for b in it:
            yield place(b, self.device)

    def eff_batch(self, cell: CellSpec) -> int:
        """cnn cells cap the batch at the dataset size; lm streams are
        synthetic and unbounded."""
        if self.grid.family == "cnn":
            return min(cell.batch, self.grid.n_train)
        return cell.batch

    def pipeline(self, cell: CellSpec) -> TrainPipeline:
        key = cell.pipeline_key()
        if key not in self._pipelines:
            stats_fn = None
            if self.collect_stats:
                stats_fn = grad_stats.stats_hook(
                    eta=cell.cell_trust_coef,
                    weight_decay=cell.weight_decay)
            self._pipelines[key] = TrainPipeline(
                self.model, cell.build_optimizer(), self.cfg,
                accum_steps=cell.accum_steps, precision=cell.precision,
                donate=False, stats_fn=stats_fn)
        return self._pipelines[key]

    def init_state(self, cell: CellSpec, pipe: TrainPipeline) -> TrainState:
        """A cell's initial TrainState on the runner's device."""
        return pipe.init_state(torch.Generator().manual_seed(
            cell.cell_seed()), self.device)

    def _load_manifest(self, resume: bool) -> dict:
        manifest = load_json(self.manifest_path)
        if manifest is None:
            return {"grid": self.grid.fingerprint(), "cells": {}}
        if manifest.get("grid") != self.grid.fingerprint():
            raise ValueError(
                f"{self.manifest_path} was written by a different grid "
                "definition; refusing to mix protocols (use a fresh "
                "--out-dir or delete the stale run)")
        if not resume:
            raise ValueError(
                f"{self.out_dir} already holds a run of this grid; pass "
                "resume=True (--resume) to continue it or use a fresh "
                "out_dir")
        return manifest

    def _tick(self) -> None:
        self._steps_done += 1
        if self._abort_after is not None \
                and self._steps_done >= self._abort_after:
            raise KeyboardInterrupt(
                f"{ABORT_ENV}={self._abort_after} reached")

    # ------------------------------------------------------------- cells

    def open_cell(self, cell: CellSpec, *, resume: bool = False,
                  dir_name: Optional[str] = None) -> tuple:
        """Initialize-or-restore a cell: returns ``(state, start)``.

        With ``resume`` and a ``state.npz`` present, the full TrainState
        is restored, the JSONL trajectory rewound to the checkpointed
        step (contiguity-validated), and ``start`` is that step — which
        may equal ``cell.steps`` when the kill landed between the final
        training step and the manifest row. Without a checkpoint a
        partial directory is wiped and the cell restarts."""
        eff_batch = self.eff_batch(cell)
        if eff_batch % cell.accum_steps:
            raise ValueError(
                f"cell {cell.cell_id}: effective batch {eff_batch} not "
                f"divisible by accum_steps={cell.accum_steps}")
        pipe = self.pipeline(cell)
        state = self.init_state(cell, pipe)
        cdir = self.cell_dir(cell, dir_name)
        traj_path = os.path.join(cdir, "trajectory.jsonl")
        ckpt_path = os.path.join(cdir, "state.npz")
        start = 0
        if resume and os.path.exists(ckpt_path):
            state = restore_train_state(ckpt_path, state)
            start = state.opt_state.step
            kept = truncate_trajectory(traj_path, keep_below_step=start)
            if kept != start:
                raise ValueError(
                    f"trajectory {traj_path} holds {kept} records below "
                    f"the checkpointed step {start} — corrupted run "
                    "directory")
            self.log(f"  resumed {cell.cell_id} at step "
                     f"{start}/{cell.steps}")
        elif os.path.isdir(cdir):
            shutil.rmtree(cdir)  # partial cell without checkpoint: redo
        return state, start

    def run_cell_segment(self, cell: CellSpec, state, *, start: int,
                         until_step: int,
                         dir_name: Optional[str] = None,
                         checkpoint_at_end: Optional[bool] = None
                         ) -> tuple:
        """Advance one cell from ``start`` to ``min(until_step, steps)``,
        streaming trajectory records; returns ``(state, metrics, batch)``
        (the last step's — both empty when no step ran, i.e.
        ``start >= until_step``). This is the engine under
        :meth:`run_cell` (one segment to completion) and the PBT
        controller (round-robin slices). A checkpoint is saved every
        ``checkpoint_every`` steps and at the segment's end
        (``checkpoint_at_end``, default on whenever periodic
        checkpointing is on), so a controller can clone the boundary
        state and a kill during finalization resumes at ``start ==
        steps`` instead of redoing the cell.

        Each step reads its loss, aux loss and (with stats) the trust
        summary on the host, as the reference's runner does."""
        steps = cell.steps
        until = min(until_step, steps)
        eff_batch = self.eff_batch(cell)
        lm = self.grid.family == "lm"
        if checkpoint_at_end is None:
            checkpoint_at_end = bool(self.checkpoint_every)
        pipe = self.pipeline(cell)
        cdir = self.cell_dir(cell, dir_name)
        traj_path = os.path.join(cdir, "trajectory.jsonl")
        ckpt_path = os.path.join(cdir, "state.npz")
        batch: dict = {}
        metrics: dict = {}
        if start >= until:
            return state, metrics, batch
        recorder = TrajectoryRecorder(traj_path, append=start > 0)
        it = self.cell_batches(cell, start=start)
        t0 = t_prev = time.perf_counter()
        try:
            for i in range(start, until):
                batch = next(it)
                state, metrics = pipe(state, batch)
                loss = float(metrics["loss"])
                entry = {"step": i, "loss": loss,
                         "aux_loss": float(metrics["aux_loss"])}
                if lm:
                    # a diverged loss propagates ppl=None (+ the
                    # recorder's diverged flag), not exp(NaN)
                    entry["ppl"] = (round(math.exp(min(loss, 30.0)), 4)
                                    if math.isfinite(loss) else loss)
                if "stats" in metrics:
                    entry["trust"] = grad_stats.summarize(metrics["stats"])
                t_now = time.perf_counter()
                if lm:
                    # throughput telemetry (a timing key: stripped when
                    # trajectories are compared for determinism)
                    entry["tokens_per_s"] = round(
                        eff_batch * cell.seq_len
                        / max(t_now - t_prev, 1e-9), 1)
                entry["wall_s"] = round(t_now - t0, 3)
                t_prev = t_now
                recorder.record(entry)
                done = i + 1
                if (self.checkpoint_every
                        and done % self.checkpoint_every == 0) \
                        or (checkpoint_at_end and done == until):
                    save_train_state(ckpt_path, state)
                self._tick()
        finally:
            recorder.close()
        return state, metrics, batch

    def finalize_cell(self, cell: CellSpec, state, metrics, batch, *,
                      dir_name: Optional[str] = None,
                      wall_s: float = 0.0,
                      keep_checkpoint: bool = False) -> dict:
        """Evaluate a completed cell and build its summary row.

        When the cell resumed AT its final step (a kill landed between
        the last training step and the manifest row), the training loop
        never re-executed and ``metrics``/``batch`` are empty — the row
        is recomputed from the restored state (evaluation) plus the last
        trajectory record (final loss / trust summary)."""
        pipe = self.pipeline(cell)
        cdir = self.cell_dir(cell, dir_name)
        ckpt_path = os.path.join(cdir, "state.npz")
        row = dict(cell.to_json())
        row["cell_id"] = cell.cell_id
        row.update(self._evaluate_cnn(state) if self.grid.family == "cnn"
                   else self._evaluate_lm(state))
        if metrics:
            loss = float(metrics["loss"])
        else:
            recs = [r for r in read_trajectory(
                os.path.join(cdir, "trajectory.jsonl")) if "event" not in r]
            if len(recs) != cell.steps:
                raise ValueError(
                    f"cell {cell.cell_id}: cannot finalize — trajectory "
                    f"holds {len(recs)} of {cell.steps} step records")
            loss = recs[-1]["loss"]  # None when the final step diverged
            if "trust" in recs[-1]:
                row["trust_final"] = recs[-1]["trust"]
        row.update(steps=cell.steps, loss=loss, wall_s=round(wall_s, 1))
        if loss is None or not math.isfinite(loss):
            row["diverged"] = True
        if "stats" in metrics:
            # full per-layer trust/norm table at the final step
            row["layer_stats"] = to_jsonable(metrics["stats"])
            row["trust_final"] = grad_stats.summarize(metrics["stats"])
        if self.record_memory:
            if not batch:
                # resumed-at-final-step path: the probe only needs the
                # step's batch SHAPES, any stream position serves
                batch = next(self.cell_batches(cell))
            row["peak_bytes"] = pipe.peak_bytes(batch)
        if not keep_checkpoint and os.path.exists(ckpt_path):
            os.remove(ckpt_path)  # completed cells resume via manifest
        return row

    def run_cell(self, cell: CellSpec, *, resume: bool = False) -> dict:
        """Train one cell to completion; returns its summary row."""
        t0 = time.perf_counter()
        state, start = self.open_cell(cell, resume=resume)
        state, metrics, batch = self.run_cell_segment(
            cell, state, start=start, until_step=cell.steps)
        return self.finalize_cell(cell, state, metrics, batch,
                                  wall_s=time.perf_counter() - t0)

    # --------------------------------------------------------- evaluation

    def _evaluate_cnn(self, state) -> dict:
        x_tr, y_tr, x_te, y_te = self.data()

        def acc_of(x: np.ndarray, y: np.ndarray, chunk: int = 1024
                   ) -> float:
            total = 0.0
            for i in range(0, len(x), chunk):
                part = place({"x": x[i:i + chunk], "y": y[i:i + chunk]},
                             self.device)
                m = self._eval_step(state.params, part)
                total += float(m["accuracy"]) * len(part["y"])
            return total / len(x)

        train_acc = acc_of(x_tr, y_tr)
        test_acc = acc_of(x_te, y_te)
        return {"train_acc": round(train_acc, 4),
                "test_acc": round(test_acc, 4),
                "gen_error": round(
                    generalization_error(train_acc, test_acc), 4)}

    def _evaluate_lm(self, state, chunk: int = 64) -> dict:
        """Held-out next-token loss -> eval perplexity (the LM study's
        metric column) + next-token accuracy, in chunks of ``chunk``
        sequences."""
        toks = self.eval_tokens()
        loss_sum = acc_sum = 0.0
        n = len(toks)
        for i in range(0, n, chunk):
            part = toks[i:i + chunk]
            m = self._eval_step(state.params,
                                place({"tokens": part}, self.device))
            loss_sum += float(m["loss"]) * len(part)
            acc_sum += float(m["accuracy"]) * len(part)
        eval_loss = loss_sum / n
        return {"eval_loss": round(eval_loss, 4),
                "eval_ppl": round(math.exp(min(eval_loss, 30.0)), 4),
                "eval_acc": round(acc_sum / n, 4)}

    # -------------------------------------------------------------- grid

    def run(self, *, resume: bool = False,
            cell_ids: Optional[list[str]] = None,
            on_row: Optional[Callable[[dict], None]] = None) -> dict:
        """Run (the selected subset of) the grid; returns the manifest.

        ``cell_ids`` restricts execution (``--cell``); completed cells
        are recorded in the manifest as they finish, so a kill at any
        point leaves a resumable directory.
        """
        manifest = self._load_manifest(resume)
        atomic_write_json(self.manifest_path, manifest)
        cells = self.grid.cells()
        if cell_ids is not None:
            wanted = set(cell_ids)
            unknown = wanted - {c.cell_id for c in cells}
            if unknown:
                raise KeyError(f"unknown cell ids {sorted(unknown)}")
            cells = [c for c in cells if c.cell_id in wanted]
        for cell in cells:
            if cell.cell_id in manifest["cells"]:
                self.log(f"  [done] {cell.cell_id}")
                continue
            self.log(f"  [run ] {cell.cell_id} ({cell.steps} steps)")
            row = self.run_cell(cell, resume=resume)
            manifest["cells"][cell.cell_id] = row
            atomic_write_json(self.manifest_path, manifest)
            if on_row is not None:
                on_row(row)
        return manifest
