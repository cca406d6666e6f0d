"""The port's population-based training (``repro_torch.experiments.
controller``, the runner's lineage directories, ``pbt_section`` /
``write_pbt_report`` and ``launch.experiment --pbt``): the contracts of
the reference's tests/test_pbt.py, run on the port on the CPU, and one
parity test against the JAX package's controller in the same process.

Tolerances: the controller's decisions are pure functions of the
boundary trajectories and a crc32-keyed numpy rng, so the resume
contracts are exact (trajectories without their timing keys, and the
manifests, equal). The parity test starts the port's runner from the
reference's initial parameters (as tests/test_torch_experiments.py does)
and holds every decision equal: the kills, early-stops, exploit pairs,
perturbed hyperparameters and rounds. Those follow from the ranking of
slice-mean losses, which differ between the packages by ~1e-7 relative
(tests/test_torch_experiments.py), far below the gaps between members.
"""

import dataclasses
import json
import math
import os
import shutil

import jax
import numpy as np
import pytest

from repro.experiments import GridRunner as RefRunner
from repro.experiments import PopulationController as RefController
from repro.experiments import pbt_section as ref_pbt_section
from repro.experiments import spec as ref_spec
from repro_torch import bridge
from repro_torch.checkpoint import clone_checkpoint, restore_train_state
from repro_torch.experiments import (GridRunner, GridSpec,
                                     PopulationController, aggregate,
                                     cell_from_json, pbt_section,
                                     read_trajectory, write_pbt_report)
from repro_torch.experiments.controller import (slice_mean_loss,
                                                trailing_median_spike)
from repro_torch.experiments.record import TrajectoryRecorder, load_json
from repro_torch.experiments.runner import ABORT_ENV
from repro_torch.launch import experiment as cli
from repro_torch.train import train_state_from_params
from _torch_threads import one_torch_thread  # noqa: F401

# 3-step single-cell grid for the boundary sweep (1 epoch x 96 / b32).
BOUNDARY = GridSpec(name="boundary_grid", batches=(32,),
                    optimizers=("lars",), trust_coef=0.02,
                    epochs=1, n_train=96, n_test=64)

# 4-step grid the clone/perturb tests extend from.
CLONE = GridSpec(name="clone_grid", batches=(32,), optimizers=("lars",),
                 trust_coef=0.02, epochs=1, n_train=128, n_test=64)

# The population the controller tests drive: 2 optimizers x 2 member
# slots, 4 steps each, 2-step rounds.
POP = GridSpec(name="pbt_tiny", batches=(32,), optimizers=("sgd", "lars"),
               trust_coef=0.02, seeds=(0, 1),
               epochs=1, n_train=128, n_test=64)

# The parity population: 4 members a group over 3 rounds, patience 1.
# Its SGD members run at a base LR of 1e6 and go NaN in round 0 (4 kills
# for divergence); of the LARS group two are early-stopped and the rest
# exploit, so every kind of decision is held.
PARITY = dict(name="pbt_parity", batches=(32,), optimizers=("sgd", "lars"),
              trust_coef=0.02, seeds=(0, 1, 2, 3), epochs=1, n_train=192,
              n_test=64, base_lr_overrides=(("sgd", 1e6),))


def _strict_loads(text: str):
    def _reject(token):
        raise ValueError(f"non-strict JSON token {token!r}")
    return json.loads(text, parse_constant=_reject)


def _stripped(path: str) -> list:
    return read_trajectory(path, strip_timing=True)


def _runner(grid, out_dir, **kw):
    return GridRunner(grid, str(out_dir), log=None, record_memory=False,
                      device="cpu", **kw)


# ------------------------------------------- resume boundary regression

def test_kill_at_every_step_boundary_resume_sweep(tmp_path):
    """Kill a 3-step cell after EVERY recorded step — the final one too,
    where the kill lands between the last step and the manifest row —
    and resume: the trajectory equals the uninterrupted run's and the
    row is whole."""
    cell = BOUNDARY.cells()[0]
    assert cell.steps == 3
    ref_dir = tmp_path / "ref"
    ref_manifest = _runner(BOUNDARY, ref_dir, checkpoint_every=1).run()
    ref_traj = _stripped(os.path.join(str(ref_dir), cell.cell_id,
                                      "trajectory.jsonl"))
    ref_row = ref_manifest["cells"][cell.cell_id]

    for kill_after in (1, 2, 3):
        run_dir = tmp_path / f"kill{kill_after}"
        os.environ[ABORT_ENV] = str(kill_after)
        try:
            with pytest.raises(KeyboardInterrupt):
                _runner(BOUNDARY, run_dir, checkpoint_every=1).run()
        finally:
            os.environ.pop(ABORT_ENV, None)
        assert os.path.exists(os.path.join(str(run_dir), cell.cell_id,
                                           "state.npz"))
        assert load_json(os.path.join(str(run_dir),
                                      "manifest.json"))["cells"] == {}
        manifest = _runner(BOUNDARY, run_dir,
                           checkpoint_every=1).run(resume=True)
        got = _stripped(os.path.join(str(run_dir), cell.cell_id,
                                     "trajectory.jsonl"))
        assert got == ref_traj, f"kill_after={kill_after}"
        row = manifest["cells"][cell.cell_id]
        for key in ("cell_id", "steps", "loss", "test_acc", "train_acc",
                    "gen_error", "trust_final"):
            assert row[key] == ref_row[key], (kill_after, key)
        assert not os.path.exists(os.path.join(str(run_dir), cell.cell_id,
                                               "state.npz"))


# --------------------------------------------------------- clone/perturb

def _clone_into(runner, cell, dst_dir):
    os.makedirs(dst_dir, exist_ok=True)
    clone_checkpoint(os.path.join(runner.cell_dir(cell), "state.npz"),
                     os.path.join(dst_dir, "state.npz"))
    shutil.copyfile(os.path.join(runner.cell_dir(cell), "trajectory.jsonl"),
                    os.path.join(dst_dir, "trajectory.jsonl"))


def test_clone_perturb_restores_and_uses_new_hyperparams(tmp_path):
    """A checkpoint cloned into another lineage restores into a pipeline
    with other hyperparameters, the first step after the clone already
    uses them, and a fresh runner continuing the same clone reproduces
    the trajectory exactly."""
    cell = CLONE.cells()[0]
    runner = _runner(CLONE, tmp_path / "a", checkpoint_every=0)
    state, start = runner.open_cell(cell)
    runner.run_cell_segment(cell, state, start=start, until_step=2,
                            checkpoint_at_end=True)

    mutant = cell.perturbed(base_lr=0.05, trust_coef=0.08)
    assert mutant.generation == 1
    assert mutant.cell_id == cell.cell_id + "-g1"
    assert mutant.cell_seed() == cell.cell_seed()
    assert mutant.cell_base_lr == 0.05 and mutant.cell_trust_coef == 0.08

    trajs = {}
    for name, c in (("clone_m", mutant), ("clone_o", cell)):
        _clone_into(runner, cell, os.path.join(runner.out_dir, name))
        st, start_c = runner.open_cell(c, resume=True, dir_name=name)
        assert start_c == 2
        runner.run_cell_segment(c, st, start=2, until_step=4, dir_name=name)
        trajs[name] = _stripped(os.path.join(runner.out_dir, name,
                                             "trajectory.jsonl"))
    assert trajs["clone_m"][:2] == trajs["clone_o"][:2]
    assert [r["loss"] for r in trajs["clone_m"][2:]] != \
        [r["loss"] for r in trajs["clone_o"][2:]]

    fresh = _runner(CLONE, tmp_path / "b", checkpoint_every=0)
    _clone_into(runner, cell, os.path.join(fresh.out_dir, "clone_f"))
    st, _ = fresh.open_cell(mutant, resume=True, dir_name="clone_f")
    fresh.run_cell_segment(mutant, st, start=2, until_step=4,
                           dir_name="clone_f")
    assert _stripped(os.path.join(fresh.out_dir, "clone_f",
                                  "trajectory.jsonl")) == trajs["clone_m"]


def test_clone_restore_int8_scale_siblings_survive(tmp_path):
    """A quantized-slot checkpoint keeps its int8 codes and their f32
    scale siblings through a clone, and restores into a mutated
    pipeline."""
    grid = dataclasses.replace(CLONE, name="clone_int8",
                               opt_state_dtypes=("int8",))
    cell = grid.cells()[0]
    runner = _runner(grid, tmp_path, checkpoint_every=0)
    state, _ = runner.open_cell(cell)
    runner.run_cell_segment(cell, state, start=0, until_step=2,
                            checkpoint_at_end=True)
    _clone_into(runner, cell, os.path.join(str(tmp_path), "lineage2"))
    with np.load(os.path.join(str(tmp_path), "lineage2", "state.npz")) as a:
        assert any(a[k].dtype == np.int8 for k in a.files)
        assert any(k.endswith("momentum_scale") for k in a.files)
    mutant = cell.perturbed(base_lr=0.03, trust_coef=0.05)
    state_m, start_m = runner.open_cell(mutant, resume=True,
                                        dir_name="lineage2")
    assert start_m == 2
    _, metrics, _ = runner.run_cell_segment(
        mutant, state_m, start=start_m, until_step=3, dir_name="lineage2")
    assert math.isfinite(float(metrics["loss"]))


def test_restore_rejects_wrong_optimizer_slots(tmp_path):
    grid = dataclasses.replace(CLONE, name="clone_mix",
                               optimizers=("sgd", "adamw"))
    sgd_cell, adamw_cell = grid.cells()
    runner = _runner(grid, tmp_path, checkpoint_every=0)
    state, _ = runner.open_cell(sgd_cell)
    runner.run_cell_segment(sgd_cell, state, start=0, until_step=1,
                            checkpoint_at_end=True)
    ckpt = os.path.join(runner.cell_dir(sgd_cell), "state.npz")
    template = runner.init_state(adamw_cell, runner.pipeline(adamw_cell))
    with pytest.raises(ValueError, match="lacks|cannot hold"):
        restore_train_state(ckpt, template)


# ----------------------------------------------------------- controller

def test_spike_and_slice_helpers():
    assert trailing_median_spike([1.0, 1.1, 0.9, 1.0, 9.0], spike_k=3.0)
    assert not trailing_median_spike([1.0, 1.1, 0.9, 1.0, 1.2],
                                     spike_k=3.0)
    assert not trailing_median_spike([1.0, 9.0], spike_k=3.0)
    assert not trailing_median_spike([1.0, None, 1.1, 1.0], spike_k=3.0)
    assert slice_mean_loss([{"step": 0, "loss": 2.0},
                            {"step": 1, "loss": 4.0},
                            {"event": "exploit", "step": 1}],
                           lo=0, hi=2) == 3.0
    assert slice_mean_loss([{"step": 0, "loss": None}],
                           lo=0, hi=1) == math.inf
    assert slice_mean_loss([], lo=0, hi=4) == math.inf


@pytest.mark.parametrize("how", ["diverged", "loss_spike"])
def test_controller_kills(tmp_path, how):
    """The kill rule reads the recorder's diverged flag, and a loss
    spike over the trailing median."""
    ctl = PopulationController(_runner(POP, tmp_path),
                               exploit_every=2 if how == "diverged" else 6,
                               spike_k=3.0)
    st = ctl._init_members()
    lineage = next(iter(st["members"]))
    member = st["members"][lineage]
    losses = [2.0, float("nan")] if how == "diverged" \
        else [2.0, 1.8, 1.9, 1.7, 1.8, 40.0]
    member["step"] = len(losses)
    with TrajectoryRecorder(ctl._traj_path(lineage)) as rec:
        for i, loss in enumerate(losses):
            rec.record({"step": i, "loss": loss})
    ctl._apply_kills(st, 0)
    assert member["status"] == "killed" and member["reason"] == how
    assert st["events"][-1]["event"] == "kill"


def _controller(out_dir, grid=POP, **kw):
    return PopulationController(_runner(grid, out_dir, checkpoint_every=0),
                                exploit_every=2, seed=0, **kw)


def test_pbt_population_end_to_end(tmp_path):
    ctl = _controller(tmp_path / "run")
    st = ctl.run()
    members = st["members"]
    assert len(members) == 4
    assert all(m["status"] in ("done", "killed", "early_stopped")
               for m in members.values())
    exploits = [e for e in st["events"] if e["event"] == "exploit"]
    assert exploits
    mutated = [m for m in members.values() if m["cell"]["generation"] >= 1]
    assert mutated
    for m in mutated:
        cell = cell_from_json(m["cell"])
        assert cell.cell_id.endswith(f"-g{cell.generation}")
        events = [r for r in read_trajectory(ctl._traj_path(m["lineage"]))
                  if r.get("event") == "exploit"]
        assert events and events[0]["generation"] >= 1
        if m["status"] == "done":
            assert m["row"]["cell_id"] == cell.cell_id
    for m in members.values():
        if m["status"] == "done":
            steps = [r for r in read_trajectory(ctl._traj_path(
                m["lineage"])) if "event" not in r]
            assert len(steps) == cell_from_json(m["cell"]).steps
            assert not os.path.exists(os.path.join(
                ctl.runner.out_dir, m["lineage"], "state.npz"))
    disk = _strict_loads(open(ctl.manifest_path).read())
    assert disk == json.loads(json.dumps(st))

    report = str(tmp_path / "report.json")
    with open(report, "w") as f:
        json.dump({"claims": {"C3": True}}, f)
    payload = write_pbt_report(report, POP, st, out_dir=ctl.runner.out_dir,
                               backend="cpu")
    assert payload["claims"] == {"C3": True}
    section = payload["pbt"]
    assert section["backend"] == "cpu" and "device" not in section
    assert section["events"]["exploit"] == len(exploits)
    for g in section["groups"].values():
        if "best" in g:
            assert len(g["best"]["loss_curve"]) == 4
    assert "P1_tuned_sgd_closes_gap_b32" in section["claims"]
    _strict_loads(open(report).read())


def test_pbt_kill_resume_is_byte_identical(tmp_path):
    """Killed mid-round-0 and again mid-round-1 (after the first exploit
    clone), then resumed: trajectories and manifest equal to an
    uninterrupted run's."""
    ref = _controller(tmp_path / "ref").run()
    ref_traj = {lin: _stripped(os.path.join(str(tmp_path / "ref"), lin,
                                            "trajectory.jsonl"))
                for lin in ref["members"]}
    int_dir = tmp_path / "interrupted"
    for abort in ("5", "9"):
        os.environ[ABORT_ENV] = abort
        try:
            with pytest.raises(KeyboardInterrupt):
                _controller(int_dir).run(resume=True)
        finally:
            os.environ.pop(ABORT_ENV, None)
    got = _controller(int_dir).run(resume=True)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(ref))
    for lin, want in ref_traj.items():
        assert _stripped(os.path.join(str(int_dir), lin,
                                      "trajectory.jsonl")) == want, lin


def test_pbt_manifest_protocol_mismatch_rejected(tmp_path):
    runner = _runner(POP, tmp_path)
    PopulationController(runner, exploit_every=2)._load(resume=False)
    with pytest.raises(ValueError, match="resume"):
        PopulationController(runner, exploit_every=2)._load(resume=False)
    with pytest.raises(ValueError, match="different"):
        PopulationController(runner, exploit_every=3)._load(resume=True)
    with pytest.raises(ValueError, match="exploit_every"):
        PopulationController(runner, exploit_every=0)


# ----------------------------------------------------------------- parity

class _FromReferenceInit(GridRunner):
    """The port's runner started from the reference runner's initial
    parameters for each cell (torch cannot draw jax.random's)."""

    def __init__(self, ref_runner, *args, **kw):
        super().__init__(*args, **kw)
        self.ref_runner = ref_runner

    def init_state(self, cell, pipe):
        ref_state = self.ref_runner.pipeline(cell).init_state(
            jax.random.key(cell.cell_seed()))
        params = bridge.params_to_torch(
            jax.tree_util.tree_map(np.asarray, ref_state.params))
        return train_state_from_params(pipe.model, pipe.optimizer, params,
                                       precision=pipe.precision)


def _decisions(st: dict) -> dict:
    """What the controller decided, without the measured losses."""
    return {"round": st["round"], "events": st["events"],
            "members": {lin: {k: m[k] for k in ("status", "reason", "step",
                                                "cell", "events")}
                        for lin, m in st["members"].items()}}


def test_decisions_match_the_reference_controller(tmp_path,
                                                  one_torch_thread):
    grid, ref_grid = GridSpec(**PARITY), ref_spec.GridSpec(**PARITY)
    ref_runner = RefRunner(ref_grid, str(tmp_path / "ref"), log=None,
                           record_memory=False, checkpoint_every=0)
    ref = RefController(ref_runner, exploit_every=2, seed=3,
                        patience=1).run()
    runner = _FromReferenceInit(ref_runner, grid, str(tmp_path / "port"),
                                log=None, record_memory=False,
                                checkpoint_every=0, device="cpu")
    got = PopulationController(runner, exploit_every=2, seed=3,
                               patience=1).run()
    ref, got = json.loads(json.dumps(ref)), json.loads(json.dumps(got))
    kinds = {e["event"] for e in ref["events"]}
    assert kinds == {"init", "kill", "exploit", "early_stop"}, kinds
    assert _decisions(got) == _decisions(ref)
    assert got["grid"] == ref["grid"] and got["controller"] == \
        ref["controller"]
    # the report block from one manifest is the reference's
    out_dir = str(tmp_path / "ref")
    assert pbt_section(grid, ref, out_dir=out_dir) == \
        json.loads(json.dumps(ref_pbt_section(ref_grid, ref,
                                              out_dir=out_dir)))


# ------------------------------------------------------------------ CLI

PBT_ARGS = ["--grid", "pbt_smoke", "--pbt", "--population", "2",
            "--exploit-every", "1", "--epochs", "4", "--n-train", "512",
            "--checkpoint-every", "0", "--device", "cpu"]


def test_cli_pbt_interrupt_and_resume(tmp_path, capsys):
    """--pbt through the CLI: a mid-population kill returns 130, --resume
    completes the run, and the report carries the pbt block."""
    args = PBT_ARGS + ["--out-dir", str(tmp_path / "run"),
                       "--out", str(tmp_path / "report.json")]
    os.environ[ABORT_ENV] = "3"
    try:
        assert cli.main(args) == 130
    finally:
        os.environ.pop(ABORT_ENV, None)
    assert "--resume" in capsys.readouterr().out
    assert cli.main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    report = _strict_loads(open(tmp_path / "report.json").read())
    section = report["pbt"]
    assert section["backend"] == "cpu" and "device" not in section
    assert len(section["members"]) == 4
    assert all(m["status"] in ("done", "killed", "early_stopped")
               for m in section["members"].values())
    assert "P1_tuned_sgd_closes_gap_b1024" in section["claims"]
    assert "claim pbt.P1_tuned_sgd_closes_gap_b1024" in out


def test_cli_pbt_flags_need_pbt_and_a_fresh_or_resumed_dir(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--grid", "pbt_smoke", "--population", "2", "--device",
                  "cpu"])
    args = PBT_ARGS + ["--epochs", "1", "--out-dir", str(tmp_path / "r"),
                       "--out", str(tmp_path / "r.json")]
    assert cli.main(args) == 0
    with pytest.raises(ValueError, match="resume"):
        cli.main(args)
    assert cli.main(args + ["--resume"]) == 0


def test_pbt_block_merges_beside_the_static_grid_report(tmp_path):
    """A static grid's report and a PBT block share one file: each
    writer keeps the other's part."""
    from repro_torch.experiments import write_report
    report = str(tmp_path / "study.json")
    st = _controller(tmp_path / "run").run()
    write_pbt_report(report, POP, st, device="card line")
    grid = dataclasses.replace(POP, name="static", seeds=(0,))
    manifest = _runner(grid, tmp_path / "static").run()
    payload = write_report(report, grid, manifest, backend="cpu")
    assert payload["pbt"]["device"] == "card line"
    assert payload["completed_cells"] == 2
    assert aggregate(grid, manifest)["claims"] == payload["claims"]
    _strict_loads(open(report).read())
