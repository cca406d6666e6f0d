"""Population-based training (PBT): a self-driving LR/trust-coefficient
controller over :class:`~repro_torch.experiments.runner.GridRunner`
cells. Port of ``repro/experiments/controller.py``: the same decisions
from the same boundary trajectories.

The static grids answer the paper's large-batch question at full-sweep
cost: every (base_lr, trust_coef) cell trains to completion. Nado et
al. (2102.06356) argue the interesting question is what a *tuned*
generic optimizer does, which a static grid can only answer by sweeping
the tuning axis too. This controller answers it at a fraction of that
cost: the grid's cells become a POPULATION whose base LR and trust
coefficient are tuned mid-run.

Mechanics (one ``exploit_every``-step round at a time, round-robin over
the population — the cells are conceptually concurrent, executed as
step slices through ``GridRunner.run_cell_segment``):

* every member advances one slice, checkpointing at the boundary;
* **kill** — a member whose slice recorded a non-finite loss (the
  recorder's ``diverged`` flag) or a loss spike (last loss above
  ``spike_k`` x its own trailing median) is terminated;
* **early-stop** — a member whose slice-mean loss sits above its
  population group's median for ``patience`` consecutive rounds is
  retired (groups = cells sharing (optimizer, batch): LARS and SGD
  populations evolve independently);
* **exploit/explore** — each bottom-quartile member adopts a
  top-quartile member's boundary ``state.npz`` (weights + optimizer
  slots + step, cloned atomically) and that member's hyperparameters
  perturbed by x0.8 / x1.25, via the mutable-hyperparam coordinates on
  :class:`~repro_torch.experiments.spec.CellSpec` — the mutant's
  ``cell_id`` gains a generation suffix, its run directory stays the
  lineage root, and the mutation is recorded both in the controller
  manifest and as an event record in the lineage's trajectory.

Every decision is a pure function of the boundary trajectories plus a
statically-seeded numpy rng (keyed by controller seed / round / lineage
through ``zlib.crc32``), and the controller manifest (``pbt.json``) is
written atomically once per round with clone file-operations journaled
as ``pending_clones`` — so a kill at ANY point resumes to byte-identical
trajectories (timing keys aside) and identical decisions.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import statistics
import zlib

import numpy as np

from repro_torch.checkpoint import clone_checkpoint
from repro_torch.experiments.record import (TrajectoryRecorder,
                                            atomic_write_json, load_json,
                                            read_trajectory)
from repro_torch.experiments.runner import GridRunner
from repro_torch.experiments.spec import cell_from_json

# Exploit/explore perturbation factors (You et al. show trust_coef is
# the sensitive knob; the canonical PBT perturbation brackets it).
EXPLORE_FACTORS = (0.8, 1.25)
# Initial population jitter: members other than each group's anchor
# start with log-uniform hypers in [1/INIT_SPREAD, INIT_SPREAD] x the
# grid values, so generation 0 already spans a tuning range.
INIT_SPREAD = 2.0
# Optimizers whose trust coefficient is live (mutating it on sgd/adamw
# would only build a pointless new pipeline).
TRUST_OPTS = ("lars", "lamb")


def trailing_median_spike(losses: list, *, spike_k: float,
                          window: int = 5) -> bool:
    """True when the last loss spiked above ``spike_k`` x the median of
    the ``window`` losses before it (the HomebrewNLP wandblog recipe).
    Non-finite losses are a divergence, not a spike — handled upstream.
    Needs at least 2 trailing points to call a median."""
    finite = [v for v in losses if v is not None and math.isfinite(v)]
    if len(finite) < 3:
        return False
    prev = finite[max(0, len(finite) - 1 - window):-1]
    if len(prev) < 2:
        return False
    med = statistics.median(prev)
    return finite[-1] > spike_k * max(med, 1e-12)


def slice_mean_loss(records: list[dict], *, lo: int, hi: int) -> float:
    """Mean loss over step records in ``[lo, hi)``; ``inf`` when any of
    them diverged (a diverged member always ranks last)."""
    vals = []
    for rec in records:
        if "event" in rec or not (lo <= rec.get("step", -1) < hi):
            continue
        v = rec.get("loss")
        if v is None or not math.isfinite(v):
            return math.inf
        vals.append(v)
    return statistics.fmean(vals) if vals else math.inf


class PopulationController:
    """Round-robins a grid's cells as a PBT population (see module
    docstring). ``runner`` supplies the segment/checkpoint machinery;
    the population is ``runner.grid.cells()`` — the grid's seeds axis
    is the member axis, its (optimizer, batch) product the groups."""

    def __init__(self, runner: GridRunner, *, exploit_every: int = 4,
                 spike_k: float = 3.0, spike_window: int = 5,
                 patience: int = 2, seed: int = 0,
                 jitter_init: bool = True):
        if exploit_every < 1:
            raise ValueError(
                f"exploit_every must be >= 1, got {exploit_every}")
        self.runner = runner
        self.grid = runner.grid
        self.exploit_every = exploit_every
        self.spike_k = spike_k
        self.spike_window = spike_window
        self.patience = patience
        self.seed = seed
        self.jitter_init = jitter_init
        self.log = runner.log
        # transient per-round cache of each member's in-memory
        # (state, metrics, batch) so the final round's finalize doesn't
        # re-restore from disk; never consulted across process restarts
        self._live: dict[str, tuple] = {}

    # --------------------------------------------------------- manifest

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.runner.out_dir, "pbt.json")

    def _protocol(self) -> dict:
        return {"exploit_every": self.exploit_every,
                "spike_k": self.spike_k,
                "spike_window": self.spike_window,
                "patience": self.patience, "seed": self.seed,
                "jitter_init": self.jitter_init}

    def _rng(self, *parts) -> np.random.Generator:
        """Statically-seeded rng: CRC32 of (controller seed, *parts) —
        stable across processes, so resumed runs replay identical
        perturbations."""
        key = "/".join(str(p) for p in (self.seed,) + parts)
        return np.random.default_rng(zlib.crc32(key.encode()) & 0xFFFFFFFF)

    def _init_members(self) -> dict:
        """Generation-0 population: one member per grid cell, each
        group's first seed kept at the grid's static hypers (the
        anchor), the rest jittered log-uniformly so the population
        spans a tuning range from the start."""
        members: dict = {}
        events: list = []
        by_group: dict = {}
        for cell in self.grid.cells():
            by_group.setdefault((cell.optimizer, cell.batch),
                                []).append(cell)
        for (opt, batch), cells in by_group.items():
            for idx, cell in enumerate(cells):
                if self.jitter_init and idx > 0:
                    rng = self._rng("init", cell.lineage_root)
                    lo, hi = math.log(1.0 / INIT_SPREAD), \
                        math.log(INIT_SPREAD)
                    lr = cell.cell_base_lr * math.exp(
                        rng.uniform(lo, hi))
                    tc = None
                    if opt in TRUST_OPTS:
                        tc = cell.cell_trust_coef * math.exp(
                            rng.uniform(lo, hi))
                    cell = dataclasses.replace(
                        cell, mut_base_lr=float(lr),
                        mut_trust_coef=float(tc) if tc is not None
                        else 0.0)
                event = {"round": 0, "step": 0, "event": "init",
                         "lineage": cell.lineage_root,
                         "generation": 0,
                         "base_lr": cell.cell_base_lr,
                         "trust_coef": cell.cell_trust_coef}
                events.append(event)
                members[cell.lineage_root] = {
                    "lineage": cell.lineage_root,
                    "cell": cell.to_json(),
                    "status": "running", "step": 0,
                    "above_median": 0, "reason": None,
                    "events": [event]}
        return {"grid": self.grid.fingerprint(),
                "controller": self._protocol(),
                "round": 0, "members": members, "events": events,
                "pending_clones": []}

    def _load(self, resume: bool) -> dict:
        st = load_json(self.manifest_path)
        if st is None:
            st = self._init_members()
            atomic_write_json(self.manifest_path, st)
            return st
        if st.get("grid") != self.grid.fingerprint() \
                or st.get("controller") != self._protocol():
            raise ValueError(
                f"{self.manifest_path} was written by a different "
                "grid/controller protocol; refusing to mix (use a fresh "
                "--out-dir or delete the stale run)")
        if not resume:
            raise ValueError(
                f"{self.runner.out_dir} already holds a PBT run of this "
                "grid; pass resume=True (--resume) to continue it or "
                "use a fresh out_dir")
        # a kill between the decision journal and the clone file-ops:
        # re-apply the journaled clones (idempotent copies) first
        for pending in st.get("pending_clones", []):
            self._clone_files(pending)
        st["pending_clones"] = []
        atomic_write_json(self.manifest_path, st)
        return st

    # ----------------------------------------------------- trajectories

    def _traj_path(self, lineage: str) -> str:
        return os.path.join(self.runner.out_dir, lineage,
                            "trajectory.jsonl")

    def _records(self, lineage: str) -> list[dict]:
        path = self._traj_path(lineage)
        if not os.path.exists(path):
            return []
        return read_trajectory(path)

    @staticmethod
    def _losses(records: list[dict]) -> list:
        return [r.get("loss") for r in records if "event" not in r]

    # -------------------------------------------------------- decisions

    def _members(self, st: dict) -> list:
        """Members in a DETERMINISTIC order (sorted by lineage). The
        manifest round-trips through sort_keys JSON, so plain dict order
        differs between a fresh run and a resumed one — every loop that
        appends events or spends rng draws iterates this instead."""
        return [st["members"][lin] for lin in sorted(st["members"])]

    def _apply_kills(self, st: dict, rnd: int) -> None:
        for m in self._members(st):
            if m["status"] != "running":
                continue
            records = self._records(m["lineage"])
            losses = self._losses(records)
            if not losses:
                continue
            reason = None
            if any(r.get("diverged") for r in records) \
                    or losses[-1] is None \
                    or not math.isfinite(losses[-1]):
                reason = "diverged"
            elif trailing_median_spike(losses, spike_k=self.spike_k,
                                       window=self.spike_window):
                reason = "loss_spike"
            if reason:
                m["status"], m["reason"] = "killed", reason
                m["last_loss"] = losses[-1]
                event = {"round": rnd, "step": m["step"],
                         "event": "kill", "lineage": m["lineage"],
                         "reason": reason}
                m["events"].append(event)
                st["events"].append(event)
                self.log(f"  [pbt] kill {m['lineage']} ({reason})")

    def _groups(self, st: dict) -> dict:
        """(optimizer, batch) -> members, both levels deterministically
        ordered (see :meth:`_members`)."""
        groups: dict = {}
        for m in self._members(st):
            cell = m["cell"]
            groups.setdefault((cell["optimizer"], cell["batch"]),
                              []).append(m)
        return dict(sorted(groups.items()))

    def _recent(self, m: dict) -> float:
        hi = m["step"]
        lo = max(0, hi - self.exploit_every)
        return slice_mean_loss(self._records(m["lineage"]), lo=lo, hi=hi)

    def _apply_early_stops(self, st: dict, rnd: int) -> None:
        """Persistently-above-group-median members retire: a cell the
        population has already outrun at matched hypers budget won't
        win the study, and its step budget is better spent elsewhere.
        Groups keep >= 2 running members so exploit stays defined."""
        for (opt, batch), members in self._groups(st).items():
            running = [m for m in members if m["status"] == "running"
                       and m["step"] < cell_from_json(m["cell"]).steps]
            if len(running) < 3:
                continue
            recents = {m["lineage"]: self._recent(m) for m in running}
            med = statistics.median(recents.values())
            for m in sorted(running, key=lambda m: -recents[m["lineage"]]):
                if recents[m["lineage"]] > med:
                    m["above_median"] = m.get("above_median", 0) + 1
                else:
                    m["above_median"] = 0
                n_running = sum(1 for r in members
                                if r["status"] == "running")
                if m["above_median"] >= self.patience and n_running > 2:
                    m["status"] = "early_stopped"
                    m["reason"] = "above_median"
                    m["last_loss"] = recents[m["lineage"]] if \
                        math.isfinite(recents[m["lineage"]]) else None
                    event = {"round": rnd, "step": m["step"],
                             "event": "early_stop",
                             "lineage": m["lineage"],
                             "reason": f"above group median for "
                                       f"{m['above_median']} rounds"}
                    m["events"].append(event)
                    st["events"].append(event)
                    self.log(f"  [pbt] early-stop {m['lineage']}")

    def _plan_exploits(self, st: dict, rnd: int) -> None:
        """Bottom-quartile members adopt a top-quartile member's
        boundary checkpoint + perturbed hypers. The decision (and the
        journaled clone ops) mutate the manifest; the file copies run
        after the manifest is saved — see run()."""
        for (opt, batch), members in self._groups(st).items():
            running = [m for m in members if m["status"] == "running"
                       and m["step"] < cell_from_json(m["cell"]).steps]
            if len(running) < 2:
                continue
            ranked = sorted(running, key=self._recent)
            q = max(1, len(ranked) // 4)
            winners, losers = ranked[:q], ranked[-q:]
            for winner, loser in zip(winners, losers):
                if winner is loser:
                    continue
                wcell = cell_from_json(winner["cell"])
                lcell = cell_from_json(loser["cell"])
                rng = self._rng("explore", rnd, loser["lineage"])
                lr = wcell.cell_base_lr * float(
                    rng.choice(EXPLORE_FACTORS))
                tc = None
                if opt in TRUST_OPTS:
                    tc = wcell.cell_trust_coef * float(
                        rng.choice(EXPLORE_FACTORS))
                mutant = lcell.perturbed(base_lr=lr, trust_coef=tc)
                event = {"round": rnd, "step": loser["step"],
                         "event": "exploit", "lineage": loser["lineage"],
                         "from": winner["lineage"],
                         "from_cell_id": wcell.cell_id,
                         "generation": mutant.generation,
                         "base_lr": mutant.cell_base_lr,
                         "trust_coef": mutant.cell_trust_coef}
                loser["cell"] = mutant.to_json()
                loser["above_median"] = 0
                loser["events"].append(event)
                st["events"].append(event)
                st["pending_clones"].append(
                    {"winner": winner["lineage"],
                     "loser": loser["lineage"], "event": event})
                self.log(f"  [pbt] exploit {loser['lineage']} <- "
                         f"{winner['lineage']} (g{mutant.generation}: "
                         f"lr {mutant.cell_base_lr:.4g}, trust "
                         f"{mutant.cell_trust_coef:.4g})")

    def _clone_files(self, pending: dict) -> None:
        """Apply one journaled clone: donor state.npz + trajectory into
        the loser's lineage directory, then the exploit event record.
        Idempotent (the trajectory copy REPLACES the file, so replaying
        after a crash appends the event exactly once)."""
        wdir = os.path.join(self.runner.out_dir, pending["winner"])
        ldir = os.path.join(self.runner.out_dir, pending["loser"])
        os.makedirs(ldir, exist_ok=True)
        clone_checkpoint(os.path.join(wdir, "state.npz"),
                         os.path.join(ldir, "state.npz"))
        tmp = os.path.join(ldir, "trajectory.jsonl.tmp")
        shutil.copyfile(os.path.join(wdir, "trajectory.jsonl"), tmp)
        os.replace(tmp, os.path.join(ldir, "trajectory.jsonl"))
        with TrajectoryRecorder(os.path.join(ldir, "trajectory.jsonl"),
                                append=True) as rec:
            rec.record(dict(pending["event"]))
        self._live.pop(pending["loser"], None)

    # ------------------------------------------------------------- run

    def _segment(self, m: dict, until: int) -> None:
        cell = cell_from_json(m["cell"])
        until = min(until, cell.steps)
        state, start = self.runner.open_cell(cell, resume=True,
                                             dir_name=m["lineage"])
        state, metrics, batch = self.runner.run_cell_segment(
            cell, state, start=start, until_step=until,
            dir_name=m["lineage"], checkpoint_at_end=True)
        m["step"] = max(start, until)
        self._live[m["lineage"]] = (state, metrics, batch)

    def _finalize(self, st: dict) -> None:
        """Evaluate members that ran their full budget; manifest row is
        journaled BEFORE the boundary checkpoint is removed, so a kill
        mid-finalize resumes without redoing the cell."""
        for m in self._members(st):
            cell = cell_from_json(m["cell"])
            if m["status"] != "running" or m["step"] < cell.steps:
                continue
            state, metrics, batch = self._live.get(
                m["lineage"], (None, {}, {}))
            if state is None:
                state, start = self.runner.open_cell(
                    cell, resume=True, dir_name=m["lineage"])
                if start != cell.steps:
                    raise ValueError(
                        f"pbt member {m['lineage']}: checkpoint at step "
                        f"{start}, expected {cell.steps}")
            row = self.runner.finalize_cell(cell, state, metrics, batch,
                                            dir_name=m["lineage"],
                                            keep_checkpoint=True)
            m["row"] = {k: v for k, v in row.items()
                        if k != "layer_stats"}
            m["status"] = "done"
            m["last_loss"] = row.get("loss")
            atomic_write_json(self.manifest_path, st)
            ckpt = os.path.join(self.runner.out_dir, m["lineage"],
                                "state.npz")
            if os.path.exists(ckpt):
                os.remove(ckpt)
            self.log(f"  [pbt] done {m['lineage']} "
                     f"(g{cell.generation})")

    def run(self, *, resume: bool = False) -> dict:
        """Run the population to completion; returns the PBT manifest."""
        st = self._load(resume)
        while True:
            runnable = [
                m for m in self._members(st)
                if m["status"] == "running"
                and m["step"] < cell_from_json(m["cell"]).steps]
            if not runnable:
                break
            rnd = st["round"]
            until = (rnd + 1) * self.exploit_every
            self.log(f"  [pbt] round {rnd}: -> step {until} "
                     f"({len(runnable)} members)")
            for m in runnable:
                self._segment(m, until)
            self._apply_kills(st, rnd)
            self._apply_early_stops(st, rnd)
            more = any(
                m["status"] == "running"
                and m["step"] < cell_from_json(m["cell"]).steps
                for m in st["members"].values())
            if more:
                self._plan_exploits(st, rnd)
            st["round"] = rnd + 1
            # journal first (decisions + pending clone ops), then apply
            # the file copies, then clear the journal — a kill anywhere
            # in between replays idempotently
            atomic_write_json(self.manifest_path, st)
            for pending in st["pending_clones"]:
                self._clone_files(pending)
            st["pending_clones"] = []
            atomic_write_json(self.manifest_path, st)
        self._finalize(st)
        atomic_write_json(self.manifest_path, st)
        return st
