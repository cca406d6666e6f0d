#!/usr/bin/env python3
"""Where qwen3-14b's stock LM training path fits on one CUDA card, beside
the memory-lean path: each run's peak memory, step time and losses.

    python3 tools/lean_probe.py [--steps 3] [--out chiprun_out/lean_probe.json]

qwen3-14b at full width and 2 layers (``num_layers=2``: 2,216,453,632
parameters, bf16, random weights from seed 0, drawn once and shared by
every run), trained with f32 LARS through ``TrainPipeline`` on the
Markov token source, at:

- batch 1 and sequence 4096, 2048, 1024: the stock path (no lean knob)
  and the lean path (``flash_vjp``, ``attn_q_chunk=2048``,
  ``loss_chunk=1024``, the reference's hillclimb settings), the same
  batches: peaks, and the two loss trajectories' relative difference;
- batch 4 and sequence 4096: the stock path, then the lean path.

Each run is ``chip_smoke.lm_run`` (phase 13 runs the same at batch 1 x
4096): its peak is ``max_memory_allocated`` after
``reset_peak_memory_stats``, less what was allocated before the run (the
shared params). A run that exhausts the card's memory is recorded as not
fitting (its ``torch.cuda.OutOfMemoryError`` is caught here: this is
what the probe measures) and the next run starts on a cleared
allocator. It imports no JAX. Without a card it exits with 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAN = dict(flash_vjp=True, attn_q_chunk=2048, loss_chunk=1024)
SHAPES = [(1, 4096), (1, 2048), (1, 1024), (4, 4096)]


def run(cfg, params, batch: int, seq: int, steps: int) -> dict:
    """``chip_smoke.lm_run``, or the error of a run that does not fit."""
    import gc
    import torch
    import chip_smoke
    try:
        return dict(chip_smoke.lm_run(cfg, params, batch, seq, steps),
                    fits=True)
    except torch.cuda.OutOfMemoryError as e:
        out = {"batch": batch, "seq": seq, "fits": False,
               "error": str(e).splitlines()[0][:200]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lean_probe: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__}; {smi}", flush=True)
    stock = dataclasses.replace(get_config("qwen3-14b"), num_layers=2)
    lean = dataclasses.replace(stock, **LEAN)
    t0 = time.perf_counter()
    params = build_model(stock).init(torch.Generator().manual_seed(0),
                                     "cuda")
    print(f"init {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for batch, seq in SHAPES:
        pair = {}
        for tag, cfg in (("stock", stock), ("lean", lean)):
            r = run(cfg, params, batch, seq, args.steps)
            pair[tag] = r
            rows.append(dict(r, path=tag))
            print(f"b{batch} x {seq} {tag}: fits {r['fits']}"
                  + (f"  peak {r['peak_bytes'] / 2**30:.2f} GiB  step ms "
                     f"{[round(x, 1) for x in r['step_ms']]}  losses "
                     f"{r['losses']}" if r["fits"] else
                     f"  ({r['error']})"), flush=True)
        if pair["stock"]["fits"] and pair["lean"]["fits"]:
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(pair["lean"]["losses"], pair["stock"]["losses"])]
            rows[-1]["rel_to_stock"] = rel
            print(f"  lean vs stock loss rel diff by step {rel}", flush=True)
    line = json.dumps({"device": smi, "rows": rows})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
