"""The port's experiment harness (``repro_torch.experiments``,
``repro_torch.core.grad_stats``, ``repro_torch.launch.experiment``)
against the JAX package's, in one process on the same inputs.

Tolerances, each measured on the CPU:
  * spec: cell ids, cell seeds, step counts and fingerprints are equal.
    The LR schedules, at every step of every cell, are equal in the cnn
    grids; in the lm grids numpy's f32 ``power`` and XLA's differ by an
    ulp late in the polynomial decay: measured 1.9e-7 relative, held at
    two f32 ulps (2 * 2^-23).
  * report: the same manifest aggregates to the same payload, claims and
    table (pure Python on both sides): equal.
  * grad_stats on the same params and gradients: only f32 summation
    orders differ; measured <= 4e-7 relative in the table, held at 1e-6;
    ``summarize`` within 1e-6.
  * TrainPipeline(stats_fn=...) after one step: at accum_steps=1 in f32
    the table agrees within 7.0e-7 relative (held at 1e-6). At
    accum_steps=4 in bf16 the two frameworks reduce bf16 products in
    another order (tests/test_torch_pipeline.py): measured, per layer,
    w_norm 2.2e-6 (held at 1e-5), the weights' g_norm 1.2e-4 and every
    trust ratio 1.2e-4 (held at 1e-3), the biases' g_norm 4.0e-2 (held
    at 0.1); ``summarize`` 6.8e-6 in the trust ratios and w_norm_global
    (held at 1e-5), 6.2e-5 in g_norm_global (held at 1e-3).
  * runner: TINY (tests/test_experiments.py's grid: b32 and b128, 2
    epochs of 256) from the reference's initial parameters. Measured:
    losses <= 2.1e-7 relative over the b32 cells' 16 steps (held at
    1e-5), trust summaries <= 1.6e-6 (held at 1e-5), and train/test
    accuracies equal; accuracies are held within one example.
  * lm runner: ``lm_smoke`` cut to LM_TINY (lamb and lars at b16, one
    epoch of 64 sequences: 4 steps each) from the reference's initial
    parameters. Measured: losses <= 2.6e-7 relative (held at 1e-5),
    per-step perplexities <= 1.2e-6 (held at 1e-5), trust summaries
    <= 3.6e-6 (held at 1e-4, the bound the same grid needs with all four
    optimizers at b16 and b128: adamw's summaries drift 3.6e-5); eval
    loss and perplexity equal to their 4 rounded decimals but for one
    ulp of the rounding (held at 1e-4 absolute and 1e-5 relative), eval
    accuracies equal (held within one token).
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.configs import get_config as ref_get_config
from repro.core import grad_stats as ref_gs
from repro.experiments import GridRunner as RefRunner
from repro.experiments import aggregate as ref_aggregate
from repro.experiments import spec as ref_spec
from repro.experiments.record import TrajectoryRecorder as RefRecorder
from repro.experiments.report import format_table as ref_format_table
from repro.launch import experiment as ref_cli
from repro.models import build_model as ref_build_model
from repro.models.lenet import LeNet as RefLeNet
from repro.train import TrainPipeline as RefPipeline
from repro.train.pipeline import cast_floats as ref_cast_floats
from repro.train.state import TrainState as RefState
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import grad_stats, lars
from repro_torch.data import batch_iterator, synthetic_mnist
from repro_torch.experiments import (GRIDS, GridRunner, GridSpec,
                                     aggregate, format_table, get_grid,
                                     read_trajectory, write_report)
from repro_torch.experiments.record import (TrajectoryRecorder,
                                            truncate_trajectory)
from repro_torch.experiments.runner import ABORT_ENV
from repro_torch.launch import experiment as cli
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline, train_state_from_params
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEDULE_RTOL = {"cnn": 0.0, "lm": 2 * 2.0 ** -23}
STATS_RTOL = 1e-6
BF16_STATS_RTOL = {"w_norm": 1e-5, "trust_ratio": 1e-3, "ratio_wg": 1e-3,
                   "g_norm_w": 1e-3, "g_norm_b": 0.1}
BF16_SUMMARY_RTOL = {"trust_min": 1e-5, "trust_max": 1e-5,
                     "trust_mean": 1e-5, "w_norm_global": 1e-5,
                     "g_norm_global": 1e-3}
RUNNER_LOSS_RTOL = 1e-5
RUNNER_TRUST_RTOL = 1e-5
LM_TRUST_RTOL = 1e-4
LM_TINY = dict(epochs=1, n_train=64, n_test=32, batches=(16,),
               optimizers=("lamb", "lars"))

TINY = dict(name="tiny_test_grid", batches=(32, 128), epochs=2, n_train=256,
            n_test=64)
CFG = get_config("lenet-mnist")
MODEL = build_model(CFG)
REF_CFG = ref_get_config("lenet-mnist")
REF_MODEL = ref_build_model(REF_CFG)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


# ---------------------------------------------------------------- spec

@pytest.mark.parametrize("name", sorted(ref_spec.GRIDS))
def test_grid_cells_seeds_and_schedules_match_the_reference(name):
    ref, port = ref_spec.GRIDS[name], GRIDS[name]
    assert port.fingerprint() == ref.fingerprint()
    ref_cells, cells = ref.cells(), port.cells()
    assert [c.cell_id for c in cells] == [c.cell_id for c in ref_cells]
    assert [c.cell_seed() for c in cells] == \
        [c.cell_seed() for c in ref_cells]
    assert [c.steps for c in cells] == [c.steps for c in ref_cells]
    assert [c.to_json() for c in cells] == [c.to_json() for c in ref_cells]
    rtol = SCHEDULE_RTOL[ref.family]
    for cell, ref_cell in zip(cells, ref_cells):
        fn, ref_fn = cell.make_lr_schedule(), ref_cell.make_lr_schedule()
        steps = np.arange(cell.steps)
        want = np.asarray(jax.vmap(ref_fn)(jnp.asarray(steps, jnp.int32)),
                          np.float64)
        got = np.array([float(fn(int(s))) for s in steps])
        assert np.all(np.abs(got - want) <= rtol * np.abs(want)), cell.cell_id


def test_port_report_files_never_name_a_reference_report():
    ref_files = {g.report_file for g in ref_spec.GRIDS.values()}
    committed = {f for f in os.listdir(ROOT) if f.startswith("EXPERIMENTS_")
                 and not f.startswith("EXPERIMENTS_torch_")}
    for grid in GRIDS.values():
        assert grid.report_file.startswith("EXPERIMENTS_torch_")
        assert grid.report_file not in ref_files | committed
    assert get_grid("pbt_smoke").report_file == \
        "EXPERIMENTS_torch_lars_vs_sgd.json"


# -------------------------------------------------------------- report

def _committed_manifest():
    with open(os.path.join(ROOT, "EXPERIMENTS_lars_vs_sgd.json")) as f:
        report = json.load(f)
    return report["grid"]["name"], {
        "cells": {row["cell_id"]: row for row in report["rows"]}}


def _int8_manifest(int8_acc):
    rows = {}
    for c in get_grid("int8_parity_smoke").cells():
        r = dict(c.to_json())
        r.update(test_acc=0.97 if c.opt_state_dtype == "f32" else int8_acc,
                 train_acc=0.99, gen_error=0.02)
        rows[c.cell_id] = r
    return {"cells": rows}


@pytest.mark.parametrize("case", ["committed_smoke", "int8_pass",
                                  "int8_fail"])
def test_report_matches_the_reference(case):
    if case == "committed_smoke":
        name, manifest = _committed_manifest()
    else:
        name = "int8_parity_smoke"
        manifest = _int8_manifest(0.962 if case == "int8_pass" else 0.93)
    payload = aggregate(GRIDS[name], manifest)
    want = ref_aggregate(ref_spec.GRIDS[name], manifest)
    assert payload == want
    assert format_table(payload) == ref_format_table(want)
    if case == "committed_smoke":
        assert payload["claims"]["C3_lars_ge_sgd_at_largest_batch"] is True
        assert {"C1_comparable_at_small_batch",
                "C4_sgd_gen_error_grows_faster"} <= set(payload["claims"])
    else:
        assert payload["claims"]["P1_int8_matches_f32"] is \
            (case == "int8_pass")


@pytest.mark.parametrize("path", ["EXPERIMENTS_torch_lars_vs_sgd.json",
                                  "EXPERIMENTS_torch_lars_vs_sgd_smoke.json"])
def test_committed_port_reports_aggregate_from_their_rows(path):
    """The committed card reports are what ``aggregate`` makes of their own
    rows under the grid they name, and name the card they ran on. A PBT
    block beside them (``write_pbt_report``; the population's own
    manifest, not these rows) names its card too."""
    with open(os.path.join(ROOT, path)) as f:
        report = json.load(f)
    fp = report["grid"]
    grid = get_grid(fp["name"], **{k: tuple(map(tuple, v)) if
                                   k == "base_lr_overrides" else
                                   tuple(v) if isinstance(v, list) else v
                                   for k, v in fp.items() if k != "name"})
    assert grid.fingerprint() == fp and grid.report_file == path
    manifest = {"cells": {row["cell_id"]: row for row in report["rows"]}}
    want = {k: v for k, v in report.items() if k not in ("backend",
                                                         "device", "pbt")}
    assert aggregate(grid, manifest) == want
    assert report["completed_cells"] == report["total_cells"]
    assert report["backend"] == "cuda" and "H100" in report["device"]
    if "pbt" in report:
        pbt = report["pbt"]
        assert pbt["backend"] == "cuda" and "H100" in pbt["device"]
        assert get_grid("pbt_smoke").report_file == path
        assert all(m["status"] in ("done", "killed", "early_stopped")
                   for m in pbt["members"].values())


def test_write_report_keeps_pbt_and_records_the_device(tmp_path):
    name, manifest = _committed_manifest()
    path = str(tmp_path / "r.json")
    with open(path, "w") as f:
        json.dump({"pbt": {"rounds": 3}}, f)
    payload = write_report(path, GRIDS[name], manifest, backend="cuda",
                           device="NVIDIA H100 80GB HBM3, 700.00 W")
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == payload
    assert payload["pbt"] == {"rounds": 3}
    assert payload["backend"] == "cuda"
    assert payload["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


# -------------------------------------------------------------- record

def test_recorder_writes_the_reference_bytes(tmp_path):
    """Round trip, a torn tail truncated away, non-finite values nulled
    with ``diverged``; the port's file is the reference's, byte for byte,
    for the same records (tensors on one side, jax arrays on the other).
    """
    paths = {}
    for side, rec_cls, arr in (("port", TrajectoryRecorder, torch.tensor),
                               ("ref", RefRecorder, jnp.asarray)):
        paths[side] = str(tmp_path / side / "t.jsonl")
        with rec_cls(paths[side]) as rec:
            for i in range(5):
                rec.record({"step": i, "loss": arr(1.0 / (i + 1)),
                            "trust": {"v": arr([0.5, float(i)])},
                            "wall_s": 0.1 * i})
            rec.record({"step": 5, "loss": float("nan"),
                        "trust": {"v": [float("inf"), 1.0]}})
    with open(paths["port"]) as a, open(paths["ref"]) as b:
        assert a.read() == b.read()
    records = read_trajectory(paths["port"])
    assert [r["step"] for r in records] == list(range(6))
    assert records[5]["loss"] is None and records[5]["diverged"] is True
    assert records[5]["trust"]["v"] == [None, 1.0]
    assert "diverged" not in records[4]
    assert "wall_s" not in read_trajectory(paths["port"],
                                           strip_timing=True)[0]
    with open(paths["port"], "a") as f:
        f.write('{"step": 6, "lo')              # a torn tail from a kill
    assert truncate_trajectory(paths["port"], keep_below_step=3) == 3
    assert [r["step"] for r in read_trajectory(paths["port"])] == [0, 1, 2]


# ---------------------------------------------------------- grad_stats

def test_layer_stats_and_summary_match_the_reference():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray,
                                    RefLeNet().init(jax.random.key(3)))
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32),
        params)                             # nonzero biases too
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(0, 1e-2, p.shape).astype(np.float32), params)
    grads["fc2"]["b"] = np.zeros_like(grads["fc2"]["b"])  # guarded ratio
    kw = dict(eta=0.02, weight_decay=1e-4)
    got = grad_stats.layer_stats(bridge.params_to_torch(params),
                                 bridge.params_to_torch(grads), **kw)
    want = ref_gs.layer_stats(params, grads, **kw)
    assert set(got) == set(want)
    for layer, table in want.items():
        assert set(got[layer]) == set(grad_stats.STATS) == set(table)
        for key, v in table.items():
            assert _rel(got[layer][key], v) <= STATS_RTOL, (layer, key)
    assert float(got["fc2/b"]["trust_ratio"]) == 1.0
    summary, ref_summary = grad_stats.summarize(got), ref_gs.summarize(want)
    assert set(summary) == set(ref_summary)
    for key, v in ref_summary.items():
        assert abs(summary[key] - v) <= STATS_RTOL * abs(v), key


@pytest.mark.parametrize("accum,precision", [(1, "f32"), (4, "bf16")])
def test_pipeline_stats_match_the_reference(accum, precision):
    init = jax.tree_util.tree_map(np.asarray,
                                  RefLeNet().init(jax.random.key(7)))
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    batch = next(batch_iterator(x, y, batch=64, seed=0))
    hook = dict(eta=0.02, weight_decay=1e-4)
    ref = RefPipeline(REF_MODEL, ref_core.get_optimizer(
        "lars", learning_rate=0.05, trust_coefficient=0.02), REF_CFG,
        accum_steps=accum, precision=precision, donate=False,
        stats_fn=ref_gs.stats_hook(**hook))
    ref_params = ref_cast_floats(jax.tree_util.tree_map(jnp.asarray, init),
                                 ref.precision.compute_dtype)
    ref_state = RefState(ref_params, ref.optimizer.init(
        ref_params, stacked=ref._stacked,
        master=ref.precision.master_weights))
    _, ref_m = ref(ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = lars(0.05, trust_coefficient=0.02)
    pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=accum,
                         precision=precision,
                         stats_fn=grad_stats.stats_hook(**hook))
    state = train_state_from_params(MODEL, opt,
                                    bridge.params_to_torch(init),
                                    precision=precision)
    _, m = pipe(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert pipe.peak_bytes(batch={"x": torch.zeros(1)}) is None  # CPU
    for layer, table in ref_m["stats"].items():
        for key, v in table.items():
            rel = _rel(m["stats"][layer][key].float(), v)
            if precision == "f32":
                tol = STATS_RTOL
            elif key == "g_norm":
                tol = BF16_STATS_RTOL["g_norm_b" if layer.endswith("/b")
                                      else "g_norm_w"]
            else:
                tol = BF16_STATS_RTOL[key]
            assert rel <= tol, (layer, key, rel)
    summary = grad_stats.summarize(m["stats"])
    for key, v in ref_gs.summarize(ref_m["stats"]).items():
        tol = STATS_RTOL if precision == "f32" else BF16_SUMMARY_RTOL[key]
        assert abs(summary[key] - v) <= tol * abs(v), key


# -------------------------------------------------------------- runner

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


def _trajectories(out_dir, grid, read=read_trajectory):
    return {c.cell_id: read(os.path.join(str(out_dir), c.cell_id,
                                         "trajectory.jsonl"),
                            strip_timing=True) for c in grid.cells()}


def test_runner_matches_the_reference_runner(tmp_path):
    from repro.experiments import read_trajectory as ref_read
    grid, ref_grid = GridSpec(**TINY), ref_spec.GridSpec(**TINY)
    ref_runner = RefRunner(ref_grid, str(tmp_path / "ref"), log=None,
                           record_memory=False)
    ref_manifest = ref_runner.run()
    runner = _FromReferenceInit(ref_runner, grid, str(tmp_path / "port"),
                                log=None, device="cpu")
    manifest = runner.run()
    ref_traj = _trajectories(tmp_path / "ref", ref_grid, ref_read)
    traj = _trajectories(tmp_path / "port", grid)
    for cell in grid.cells():
        cid = cell.cell_id
        assert len(traj[cid]) == len(ref_traj[cid]) == cell.steps
        for got, want in zip(traj[cid], ref_traj[cid]):
            assert set(got) == set(want) == {"step", "loss", "aux_loss",
                                             "trust"}
            assert got["step"] == want["step"]
            assert abs(got["loss"] - want["loss"]) <= \
                RUNNER_LOSS_RTOL * abs(want["loss"])
            for key, v in want["trust"].items():
                assert abs(got["trust"][key] - v) <= \
                    RUNNER_TRUST_RTOL * abs(v), (cid, got["step"], key)
        row, ref_row = manifest["cells"][cid], ref_manifest["cells"][cid]
        assert set(row) == set(ref_row) | {"peak_bytes"}
        assert row["peak_bytes"] is None                 # the CPU
        same = set(ref_row) - {"wall_s", "loss", "train_acc", "test_acc",
                               "gen_error", "trust_final", "layer_stats"}
        assert {k: row[k] for k in same} == {k: ref_row[k] for k in same}
        assert abs(row["loss"] - ref_row["loss"]) <= \
            RUNNER_LOSS_RTOL * abs(ref_row["loss"])
        assert abs(row["test_acc"] - ref_row["test_acc"]) <= \
            1 / grid.n_test + 1e-4
        assert abs(row["train_acc"] - ref_row["train_acc"]) <= \
            1 / grid.n_train + 1e-4
        assert set(row["layer_stats"]) == set(ref_row["layer_stats"])
        for key, v in ref_row["trust_final"].items():
            assert abs(row["trust_final"][key] - v) <= \
                RUNNER_TRUST_RTOL * abs(v)
    claims = aggregate(grid, manifest)["claims"]
    assert set(claims) == set(ref_aggregate(ref_grid, ref_manifest)
                              ["claims"])


def test_lm_runner_matches_the_reference_runner(tmp_path,
                                                one_torch_thread):
    from repro.experiments import read_trajectory as ref_read
    grid = get_grid("lm_smoke", **LM_TINY)
    ref_grid = ref_spec.get_grid("lm_smoke", **LM_TINY)
    ref_runner = RefRunner(ref_grid, str(tmp_path / "ref"), log=None,
                           record_memory=False)
    ref_manifest = ref_runner.run()
    runner = _FromReferenceInit(ref_runner, grid, str(tmp_path / "port"),
                                log=None, device="cpu")
    assert runner.cfg == get_config("smollm-135m").reduced(
        max_layers=2, max_d_model=128, max_vocab=256)
    manifest = runner.run()
    ref_traj = _trajectories(tmp_path / "ref", ref_grid, ref_read)
    traj = _trajectories(tmp_path / "port", grid)
    assert len(grid.cells()) == 2
    for cell in grid.cells():
        cid = cell.cell_id
        assert len(traj[cid]) == len(ref_traj[cid]) == cell.steps == 4
        for got, want in zip(traj[cid], ref_traj[cid]):
            assert set(got) == set(want) == {"step", "loss", "aux_loss",
                                             "ppl", "trust"}
            for key in ("loss", "ppl"):
                assert abs(got[key] - want[key]) <= \
                    RUNNER_LOSS_RTOL * abs(want[key]), (cid, key)
            for key, v in want["trust"].items():
                assert abs(got["trust"][key] - v) <= \
                    LM_TRUST_RTOL * abs(v), (cid, got["step"], key)
        row, ref_row = manifest["cells"][cid], ref_manifest["cells"][cid]
        assert set(row) == set(ref_row) | {"peak_bytes"}
        same = set(ref_row) - {"wall_s", "loss", "eval_loss", "eval_ppl",
                               "eval_acc", "trust_final", "layer_stats"}
        assert {k: row[k] for k in same} == {k: ref_row[k] for k in same}
        assert abs(row["eval_loss"] - ref_row["eval_loss"]) <= 1e-4
        assert abs(row["eval_ppl"] - ref_row["eval_ppl"]) <= \
            1e-5 * ref_row["eval_ppl"]
        assert abs(row["eval_acc"] - ref_row["eval_acc"]) <= \
            1 / (grid.n_test * grid.seq_len) + 1e-4
    claims = aggregate(grid, manifest)["claims"]
    assert set(claims) == set(ref_aggregate(ref_grid, ref_manifest)
                              ["claims"])


def test_interrupted_lm_run_resumes_byte_identical(tmp_path,
                                                   one_torch_thread):
    grid = get_grid("lm_smoke", **dict(LM_TINY, batches=(16, 32)))
    ref_manifest = _run(tmp_path / "ref", grid)
    os.environ[ABORT_ENV] = "7"        # lamb-b16's 4 steps, then lars's 3
    try:
        with pytest.raises(KeyboardInterrupt):
            _run(tmp_path / "int", grid, checkpoint_every=2)
    finally:
        os.environ.pop(ABORT_ENV, None)
    assert (tmp_path / "int" / grid.cells()[1].cell_id / "state.npz").exists()
    manifest = _run(tmp_path / "int", grid, resume=True, checkpoint_every=2)
    assert _trajectories(tmp_path / "int", grid) == \
        _trajectories(tmp_path / "ref", grid)
    for cid, row in manifest["cells"].items():
        assert {k: v for k, v in row.items() if k != "wall_s"} == \
            {k: v for k, v in ref_manifest["cells"][cid].items()
             if k != "wall_s"}
        assert math.isfinite(row["eval_ppl"])


def _run(out_dir, grid, resume=False, **kw):
    return GridRunner(grid, str(out_dir), log=None, device="cpu",
                      **kw).run(resume=resume)


@pytest.mark.parametrize("variant", ["f32", "int8_bf16_accum4"])
def test_interrupted_run_resumes_byte_identical(tmp_path, variant):
    grid = GridSpec(**TINY)
    kill = "22"     # 16 steps in b32's first cell: mid-cell 1, past step 4
    if variant != "f32":
        grid = dataclasses.replace(grid, name="tiny_int8_grid",
                                   batches=(32,), precisions=("bf16",),
                                   accum_steps=(4,),
                                   opt_state_dtypes=("int8",))
    ref_manifest = _run(tmp_path / "ref", grid)
    os.environ[ABORT_ENV] = kill
    try:
        with pytest.raises(KeyboardInterrupt):
            _run(tmp_path / "int", grid, checkpoint_every=4)
    finally:
        os.environ.pop(ABORT_ENV, None)
    ckpt = tmp_path / "int" / grid.cells()[1].cell_id / "state.npz"
    assert ckpt.exists()
    if variant != "f32":
        with np.load(ckpt) as arrs:
            assert any(arrs[k].dtype == np.int8 for k in arrs.files)
    with pytest.raises(ValueError, match="resume"):
        _run(tmp_path / "int", grid)
    with pytest.raises(ValueError, match="different grid"):
        _run(tmp_path / "int", dataclasses.replace(grid, epochs=3),
             resume=True)
    manifest = _run(tmp_path / "int", grid, resume=True, checkpoint_every=4)
    assert _trajectories(tmp_path / "int", grid) == \
        _trajectories(tmp_path / "ref", grid)
    assert set(manifest["cells"]) == {c.cell_id for c in grid.cells()}
    for cid, row in manifest["cells"].items():
        assert {k: v for k, v in row.items() if k != "wall_s"} == \
            {k: v for k, v in ref_manifest["cells"][cid].items()
             if k != "wall_s"}
        assert math.isfinite(row["loss"]) and "layer_stats" in row


@pytest.mark.parametrize("name,changes", [
    ("lm_smoke", {"arch": "paligemma-3b"}),
    ("lm_lars_vs_lamb", {"mesh": "1x1"}),
    ("zero_smoke", {})])
def test_unported_grids_raise(tmp_path, name, changes):
    """Mesh and zero cells are not yet ported. An lm grid over paligemma
    is refused with the reason the reference's runner fails at its first
    step: it feeds token batches, with no image stub."""
    if changes.get("arch") == "paligemma-3b":
        with pytest.raises(ValueError, match="token batches only"):
            GridRunner(get_grid(name, **changes), str(tmp_path), log=None,
                       device="cpu")
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        GridRunner(get_grid(name, **changes), str(tmp_path), log=None,
                   device="cpu")


def test_runner_runs_on_cuda_unless_asked_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GridRunner(GridSpec(**TINY), str(tmp_path), log=None)


# ----------------------------------------------------------------- CLI

def test_cli_lists_the_reference_grids(capsys):
    assert cli.main(["--list-grids"]) == 0
    port = capsys.readouterr().out
    assert ref_cli.main(["--list-grids"]) == 0
    assert port == capsys.readouterr().out
    assert cli.main(["--grid", "lars_vs_sgd", "--list-cells"]) == 0
    port = capsys.readouterr().out
    assert ref_cli.main(["--grid", "lars_vs_sgd", "--list-cells"]) == 0
    assert port == capsys.readouterr().out


CLI_TINY = ["--grid", "lars_vs_sgd_smoke", "--epochs", "1", "--n-train",
            "256", "--device", "cpu"]


def test_cli_runs_interrupts_and_resumes_on_the_cpu(tmp_path, capsys):
    out_dir, out = str(tmp_path / "run"), str(tmp_path / "report.json")
    flags = CLI_TINY + ["--out-dir", out_dir, "--out", out,
                        "--checkpoint-every", "2"]
    os.environ[ABORT_ENV] = "6"         # 4 steps in the first cell
    try:
        assert cli.main(flags) == 130
    finally:
        os.environ.pop(ABORT_ENV, None)
    with open(out) as f:
        assert json.load(f)["completed_cells"] == 1
    assert cli.main(flags + ["--resume"]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["completed_cells"] == report["total_cells"] == 4
    assert report["backend"] == "cpu" and "device" not in report
    assert "C3_lars_ge_sgd_at_largest_batch" in report["claims"]
    assert "claim C3_lars_ge_sgd_at_largest_batch" in capsys.readouterr().out


def test_cli_runs_on_cuda_unless_asked_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--grid", "lars_vs_sgd_smoke", "--out-dir",
                  str(tmp_path / "r"), "--out", str(tmp_path / "r.json")])


# the PBT flags are ported (tests/test_torch_pbt.py); mesh/zero grids
# are not
@pytest.mark.parametrize("extra", [["--grid", "zero_smoke"]])
def test_cli_refuses_unported_options(extra):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(CLI_TINY + extra)
