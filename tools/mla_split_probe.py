#!/usr/bin/env python3
"""Which way MLA's replicated down projections should enter the ranks'
split computation on a tensor-parallel mesh: one MLA block at
deepseek-v2-236b's full width, forward and backward, on the two ranks of
a ``1x2`` mesh, each way.

    python3 tools/mla_split_probe.py [--tokens 4096] [--reps 3] \\
        [--out build/mla_split_probe.json]

deepseek-v2-236b's attention (d_model 5120, 128 heads, q_lora_rank
1536, kv_lora_rank 512 + rope 64, bf16, random weights from seed 0, the
lean knobs of ``chip_smoke.DEEPSEEK_LEAN``), each rank holding its 64
heads' blocks, on two ranks of one card over gloo (this file run as
``--rank R 2 DIR``, a file store), one batch row of ``--tokens``:

- ``activations`` (``models.mla.mla_block``'s way): the down
  projections and their norms run on the whole x; rmsnorm(x @ q_down),
  c_kv and the rope key, (B, S, 1536 + 576), enter the split through
  ONE ``copy_to_model`` (its backward: one all-reduce of their
  gradient);
- ``weights``: x, (B, S, 5120), enters through ``copy_to_model``, and
  ``q_down``, ``q_norm``, ``kv_down`` and ``kv_norm`` each through their
  own (their gradients all-reduced).

For each way: the forward + backward ms (host clock between syncs,
median of ``--reps`` after one warmup), the bytes each rank handed to
all-reduces (``collectives.MOVED``), whether the replicated leaves'
gradients are bit-identical across the ranks, and the output's and
every gradient's largest gap to the other way's. It imports no JAX.
Without a card it exits with 1.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLICATED = ("q_down", "q_norm", "kv_down", "kv_norm")


def weights_way(cfg, p: dict, x, positions, tp):
    """The block with x and the replicated leaves each passed through
    ``copy_to_model``: the plain block on this rank's heads (its rows of
    ``wo`` give its share), the shares summed."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import mla
    w = dict(p)
    for name in REPLICATED:
        w[name] = C.copy_to_model(p[name], tp)
    return C.reduce_from_model(
        mla.mla_block(cfg, w, C.copy_to_model(x, tp), positions), tp)


def rank_main(rank: int, world: int, workdir: str, tokens: int,
              reps: int) -> None:
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (param_shardings,
                                                  shard_params)
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models import mla
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    out = {}
    try:
        tp = mesh_from_spec(f"1x{world}", device="cuda:0")
        cfg = chip_smoke.deepseek_cfg()
        dtype = getattr(torch, cfg.dtype)
        whole = mla.init_mla(torch.Generator().manual_seed(0), cfg,
                             cfg.d_model, dtype, "cpu")
        p = {k: v.cuda() for k, v in shard_params(
            whole, param_shardings(cfg, whole, tp)).items()}
        g = torch.Generator().manual_seed(1)
        x = torch.randn(1, tokens, cfg.d_model, generator=g).to(
            "cuda", dtype)
        cot = torch.randn(1, tokens, cfg.d_model, generator=g).to(
            "cuda", dtype)
        positions = torch.arange(tokens, device="cuda")
        ways = {"activations": lambda pw, xw: mla.mla_block(
                    cfg, pw, xw, positions, tp=tp),
                "weights": lambda pw, xw: weights_way(cfg, pw, xw,
                                                      positions, tp)}
        grads = {}
        for name, block in ways.items():
            times = []
            for i in range(reps + 1):
                pw = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
                xw = x.detach().requires_grad_(True)
                C.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = block(pw, xw)
                (y.float() * cot.float()).sum().backward()
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            grads[name] = dict({k: v.grad for k, v in pw.items()},
                               x=xw.grad, out=y.detach())
            out[name] = {
                "ms": times, "ms_median": statistics.median(times),
                "all_reduce_bytes": C.MOVED["all_reduce"],
                "all_gather_bytes": C.MOVED["all_gather"],
                "replicated_grad_digests": {
                    k: hashlib.sha256(grads[name][k].float().cpu().numpy()
                                      .tobytes()).hexdigest()
                    for k in REPLICATED}}
        out["gap"] = {k: float((grads["activations"][k].float()
                                - grads["weights"][k].float()).abs().max())
                      for k in grads["weights"]}
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--rank", nargs=3, metavar=("R", "W", "DIR"))
    args = ap.parse_args()
    if args.rank:
        rank_main(int(args.rank[0]), int(args.rank[1]), args.rank[2],
                  args.tokens, args.reps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("mla_split_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    workdir = os.path.join(ROOT, "build", "mla_split_probe")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tokens",
         str(args.tokens), "--reps", str(args.reps), "--rank", str(r), "2",
         workdir]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        print(f"mla_split_probe: ranks exited {rcs}", file=sys.stderr)
        return 1
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    rep = {"card": smi, "tokens": args.tokens, "ranks": ranks}
    for way in ("activations", "weights"):
        same = all(r[way]["replicated_grad_digests"]
                   == ranks[0][way]["replicated_grad_digests"] for r in ranks)
        rep[way] = {"ms_median": [r[way]["ms_median"] for r in ranks],
                    "all_reduce_bytes": ranks[0][way]["all_reduce_bytes"],
                    "replicated_grads_identical": same}
        print(f"{way}: fwd+bwd ms a rank "
              + ", ".join(f"{r[way]['ms_median']:.2f}" for r in ranks)
              + f"; all-reduce bytes a rank "
              f"{ranks[0][way]['all_reduce_bytes']:,}; replicated "
              f"gradients bit-identical across the ranks: {same}")
    print(f"largest gap between the ways (rank 0): {ranks[0]['gap']}")
    print(f"peak a rank: {[r['peak_bytes'] for r in ranks]} B; {smi}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
