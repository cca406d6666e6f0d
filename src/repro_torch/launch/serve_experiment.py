"""Serve-SLO experiment CLI of the port: run a scenario x scheduler x
slots x sampler sweep and write ``EXPERIMENTS_torch_serve.json`` with
claim checks. Port of ``repro/launch/serve_experiment.py`` on one device.

Examples (on the card; ``--device cpu`` runs them on the CPU)::

  # the smoke sweep behind the committed EXPERIMENTS_torch_serve.json
  PYTHONPATH=src python -m repro_torch.launch.serve_experiment \\
      --grid serve_slo_smoke

  # pin the traffic window instead of the grid's (comparing machines)
  PYTHONPATH=src python -m repro_torch.launch.serve_experiment \\
      --grid serve_slo_smoke --time-scale 2.0 --out /tmp/serve.json

Every cell replays its scenario's arrival schedule under ONE shared
``time_scale``, so FIFO and priority cells see identical traffic and
the A1/A2 claims compare policy, not timing luck. The report carries the
backend and, on the card, nvidia-smi's name and power limit. The exit
code is 0 when the decode contract held in every cell
(``contract_one_decode_trace_per_cell``: see
:mod:`repro_torch.experiments.serve_grid`); A1–A3 are printed as they
come out — the experiment's outcome on this hardware, not a gate (the
reference's CLI fails on any false claim). The reference's
``EXPERIMENTS_serve.json`` is never written.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.experiments.serve_grid import (SERVE_GRIDS,
                                                format_serve_grid,
                                                get_serve_grid,
                                                run_serve_grid,
                                                write_serve_experiments)
from repro_torch.launch.experiment import device_line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve_experiment")
    ap.add_argument("--grid", choices=sorted(SERVE_GRIDS),
                    default="serve_slo_smoke",
                    help="named serve grid from the registry")
    ap.add_argument("--list-grids", action="store_true",
                    help="print the registry (name, cells) and exit")
    ap.add_argument("--list-cells", action="store_true",
                    help="print the grid's cell ids and exit")
    ap.add_argument("--out", default=None,
                    help="report path (default: the grid's registered "
                    "file, EXPERIMENTS_torch_serve.json for the smoke "
                    "grid)")
    ap.add_argument("--time-scale", type=float, default=None,
                    help="traffic window in seconds (default: the grid's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)

    if args.list_grids:
        for name, grid in sorted(SERVE_GRIDS.items()):
            print(f"{name}: {len(grid.cells)} cells on {grid.arch} "
                  f"-> {grid.report_file}")
        return 0
    grid = get_serve_grid(args.grid)
    if args.list_cells:
        for cell in grid.cells:
            print(cell.cell_id)
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the serve grid on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    print(f"running serve grid {grid.name} ({len(grid.cells)} cells) on "
          f"{device}", flush=True)
    payload = run_serve_grid(grid, time_scale=args.time_scale,
                             device=device)
    if device.type == "cuda":
        payload["device"] = device_line(device.index or 0)
    out = args.out or grid.report_file
    write_serve_experiments(out, payload)
    print(format_serve_grid(payload))
    print(f"report -> {out}")
    return 0 if payload["claims"]["contract_one_decode_trace_per_cell"] \
        else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
