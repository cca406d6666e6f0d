"""Experiment CLI of the port: run a declarative grid end to end,
resumably. Port of ``repro/launch/experiment.py`` for the cnn and lm
grids.

Examples (on the card; ``--device cpu`` runs them on the CPU)::

  # the CI smoke study (2x2: sgd/lars x small/large batch)
  PYTHONPATH=src python -m repro_torch.launch.experiment \\
      --grid lars_vs_sgd_smoke

  # the full paper sweep, interruptible and resumable mid-grid
  PYTHONPATH=src python -m repro_torch.launch.experiment --grid lars_vs_sgd
  PYTHONPATH=src python -m repro_torch.launch.experiment --grid lars_vs_sgd \\
      --resume

  # one cell only
  PYTHONPATH=src python -m repro_torch.launch.experiment --grid lars_vs_sgd \\
      --cell lars-b8192-f32-a1-linear-s0

  # the LM study (LARS/LAMB vs SGD/AdamW on reduced smollm), and its
  # smoke grid with its report beside the full grid's
  PYTHONPATH=src python -m repro_torch.launch.experiment \\
      --grid lm_lars_vs_lamb
  PYTHONPATH=src python -m repro_torch.launch.experiment --grid lm_smoke \\
      --out EXPERIMENTS_torch_lm_lars_vs_lamb_smoke.json

  # the grid as a PBT population (experiments/controller): the seeds
  # axis becomes member slots, base_lr/trust_coef are tuned mid-run by
  # exploit/explore; the pbt block merges into the study's report file
  PYTHONPATH=src python -m repro_torch.launch.experiment --grid pbt_smoke \\
      --pbt --population 4 --exploit-every 4

  # a grid of mesh / ZeRO cells (zero_smoke: 8x1, zero=True) on 8 ranks,
  # one card each (NCCL); on the CPU add --device cpu (gloo)
  PYTHONPATH=src torchrun --nproc-per-node 8 -m \\
      repro_torch.launch.experiment --grid zero_smoke

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank runs the grid and
joins the default process group (NCCL for ``cuda``, each rank on
``cuda:<LOCAL_RANK>``; gloo for ``--device cpu``); only rank 0 prints
the report and writes it.

The run directory (``--out-dir``, default ``runs/torch/<grid>``, apart
from the reference's ``runs/<grid>`` so neither resumes the other's
manifest) holds the manifest and one JSONL trajectory per cell; the
aggregated report (accuracy-vs-batch table + claim checks, with the
backend and, on the card, nvidia-smi's name and power limit) is written
to ``--out`` (default: the grid's ``report_file``,
``EXPERIMENTS_torch_<study>.json``) after every invocation, from
whatever cells have completed so far; under ``--pbt`` the population's
block goes under the report's ``pbt`` key (with the card's line in its
``device`` field) and its claims print as ``claim pbt.<name>`` lines.
The reference's ``EXPERIMENTS_<study>.json`` files are never written.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from repro_torch.experiments import (GRIDS, GridRunner,
                                     PopulationController, format_table,
                                     get_grid, write_pbt_report,
                                     write_report)
from repro_torch.experiments.record import load_json
from repro_torch.launch.mesh import init_distributed, world


def device_line(index: int) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.experiment")
    ap.add_argument("--grid", choices=sorted(GRIDS),
                    help="named grid from the registry")
    ap.add_argument("--list-grids", action="store_true",
                    help="print the registry (name, cells, axes) and exit")
    ap.add_argument("--list-cells", action="store_true",
                    help="print the grid's cell ids and exit")
    ap.add_argument("--out-dir", default=None,
                    help="run directory (default runs/torch/<grid>)")
    ap.add_argument("--out", default=None,
                    help="aggregated report path (default "
                    "EXPERIMENTS_torch_<grid>.json)")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted run of this grid "
                    "(skips completed cells, restores mid-cell "
                    "checkpoints)")
    ap.add_argument("--cell", action="append", default=None,
                    metavar="CELL_ID", help="run only this cell "
                    "(repeatable)")
    ap.add_argument("--checkpoint-every", type=int, default=25,
                    help="steps between mid-cell TrainState checkpoints "
                    "(0 disables; resume then restarts the cell)")
    ap.add_argument("--no-stats", action="store_true",
                    help="skip the per-layer trust-ratio telemetry")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the grid's epoch budget")
    ap.add_argument("--n-train", type=int, default=None,
                    help="override the grid's train-set size")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="override the grid's replicate seeds")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override an LM grid's training sequence length")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    ap.add_argument("--pbt", action="store_true",
                    help="run the grid as a PBT population: the seeds "
                    "axis becomes member slots and the controller tunes "
                    "base_lr/trust_coef mid-run via exploit/explore")
    ap.add_argument("--population", type=int, default=None,
                    help="PBT members per (optimizer, batch) group "
                    "(sets the grid's seeds axis to 0..N-1)")
    ap.add_argument("--exploit-every", type=int, default=4,
                    help="PBT round length in optimizer steps")
    ap.add_argument("--pbt-seed", type=int, default=0,
                    help="controller rng seed (init jitter + "
                    "exploit/explore perturbations)")
    args = ap.parse_args(argv)

    if args.list_grids:
        for name in sorted(GRIDS):
            g = GRIDS[name]
            print(f"{name}: {len(g.cells())} cells  family={g.family} "
                  f"optimizers={list(g.optimizers)} "
                  f"batches={list(g.batches)} epochs={g.epochs}")
        return 0
    if not args.grid:
        ap.error("--grid is required (or --list-grids)")

    overrides = {}
    if args.population is not None:
        if not args.pbt:
            ap.error("--population requires --pbt")
        overrides["seeds"] = tuple(range(args.population))
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.n_train is not None:
        overrides["n_train"] = args.n_train
    if args.seeds is not None:
        overrides["seeds"] = tuple(args.seeds)
    if args.seq_len is not None:
        overrides["seq_len"] = args.seq_len
    grid = get_grid(args.grid, **overrides)

    if args.list_cells:
        for cell in grid.cells():
            print(f"{cell.cell_id}  ({cell.steps} steps)")
        return 0

    out_dir = args.out_dir or os.path.join("runs", "torch", grid.name)
    out = args.out or grid.report_file
    runner = GridRunner(grid, out_dir,
                        checkpoint_every=args.checkpoint_every,
                        collect_stats=not args.no_stats,
                        device=init_distributed(args.device))
    backend = runner.device.type
    device = device_line(runner.device.index or 0) \
        if backend == "cuda" else None
    on = f"(backend={backend}" + (f"; {device}" if device else "") + ")"
    if args.pbt:
        return _run_pbt(runner, args, grid, out_dir, out, backend, device,
                        on)
    print(f"# grid {grid.name}: {len(grid.cells())} cells -> {out_dir} {on}",
          flush=True)
    interrupted = False
    try:
        manifest = runner.run(resume=args.resume, cell_ids=args.cell)
    except KeyboardInterrupt:
        manifest = load_json(runner.manifest_path)
        interrupted = True
        print("interrupted — rerun with --resume to continue", flush=True)
    if world()[0] != 0:
        return 130 if interrupted else 0
    payload = write_report(out, grid, manifest, backend=backend,
                           device=device)
    print(f"# report ({payload['completed_cells']}/"
          f"{payload['total_cells']} cells) -> {out}")
    print(format_table(payload))
    for key, val in payload["claims"].items():
        print(f"claim {key}: {val}")
    return 130 if interrupted else 0


def _run_pbt(runner, args, grid, out_dir: str, out: str, backend: str,
             device, on: str) -> int:
    """``--pbt``: the grid's cells as a population through
    :class:`PopulationController`; the block merges into ``out``."""
    ctl = PopulationController(runner, exploit_every=args.exploit_every,
                               seed=args.pbt_seed)
    print(f"# pbt {grid.name}: {len(grid.cells())} members -> {out_dir} "
          f"{on}", flush=True)
    interrupted = False
    try:
        pbt = ctl.run(resume=args.resume)
    except KeyboardInterrupt:
        pbt = load_json(ctl.manifest_path)
        interrupted = True
        print("interrupted — rerun with --resume to continue", flush=True)
    payload = write_pbt_report(out, grid, pbt, out_dir=out_dir,
                               backend=backend, device=device)
    section = payload["pbt"]
    done = sum(m["status"] == "done" for m in section["members"].values())
    print(f"# pbt report ({done}/{len(section['members'])} members "
          f"finished, {section['events']['exploit']} exploits, "
          f"{section['events']['kill']} kills, "
          f"{section['events']['early_stop']} early-stops) -> {out}")
    for name, g in section["groups"].items():
        best = g.get("best")
        if best:
            metric = next(v for k, v in best.items()
                          if k.endswith(("test_acc", "eval_ppl")))
            print(f"  {name}: best {best['cell_id']} "
                  f"(lr {best['base_lr']:.4g}, trust "
                  f"{best['trust_coef']:.4g}) -> {metric}")
    for key, val in section["claims"].items():
        print(f"claim pbt.{key}: {val}")
    return 130 if interrupted else 0


if __name__ == "__main__":
    sys.exit(main())
