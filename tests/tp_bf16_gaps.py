"""Reduced deepseek-v2-236b's tensor-parallel runs on a 1x2 mesh against
their runs alone, on the CPU (two gloo ranks), made as
``tests/test_torch_tensor_parallel.py`` makes them (the reference's
init, its tokens, its steps and microbatches): for each run the largest
relative gap of a loss and of a trust ratio of the last update, the
largest gap of a final param, and, for each MoE routing of the run (each
layer of each forward, in call order), the share of the run alone's kept
(token, expert) slots that the mesh's routing differs in.

The runs: a query rank of 48 with granite's drop settings in f32 and in
bf16, the same without drops in bf16, and the reduced preset (no query
rank, no drops) in bf16. Where the mesh's routing keeps other slots than
the run alone's, the two runs train different functions from there on:
the gap is the flip's, not bf16's rounding of the split sums.

A script beside the tests, not a test (it imports the JAX package, as
the tests do). Run from the repo's root (a minute or two):
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/tp_bf16_gaps.py
"""

import json
import tempfile

import jax
import numpy as np

import _torch_dist_worker as worker
import test_torch_tensor_parallel as tp

RUNS = [tp._moe("q48-drops-f32", "deepseek-q48", "1x2"),
        tp._moe("q48-drops-bf16", "deepseek-q48", "1x2", precision="bf16"),
        tp._moe("q48-nodrop-bf16", "deepseek-q48-nodrop", "1x2",
                precision="bf16"),
        tp._moe("nolora-nodrop-bf16", "deepseek", "1x2", precision="bf16")]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def main():
    models = sorted({r["model"] for r in RUNS})
    inits, toks = {}, None
    for m in models:
        _, state, toks = tp._reference_init(m)
        inits[m] = jax.tree_util.tree_map(np.asarray, state.params)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = worker.spawn("tensor_parallel", 2, tmp, runs=RUNS,
                             inits=inits, tokens=toks)
    for run in RUNS:
        alone = worker.tp_run(run, inits[run["model"]], toks)
        mesh = ranks[0][run["tag"]]
        want, got = tp._leaves(alone["params"]), tp._leaves(mesh["params"])
        flips = [float((a ^ b).sum() / b.sum())
                 for a, b in zip(mesh["routes"], alone["routes"])]
        print(json.dumps({
            "run": run["tag"],
            "loss_rel": _rel(mesh["losses"], alone["losses"]),
            "param_abs": max(float(np.max(np.abs(got[k] - want[k])))
                             for k in want),
            "trust_rel": max(_rel(a, b) for a, b in
                             zip(mesh["ratios"], alone["ratios"])),
            "routings": len(flips),
            "routings_that_differ": sum(f > 0 for f in flips),
            "kept_slots_differ_max": max(flips),
            "kept_slots_differ_by_routing": flips}))


if __name__ == "__main__":
    main()
