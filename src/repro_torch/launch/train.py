"""Training entry point of the port (cnn family, one device): port of
``repro/launch/train.py`` without the TrainPipeline layer.

Example (on the card; ``--device cpu`` runs it on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch lenet-mnist \
      --optimizer lars --batch 8192 --steps 20 --lr 0.01 \
      --lr-policy linear --base-batch 32 --warmup 5

TF32 is switched off for matrix products and cuDNN convolutions, so f32
means f32 on the card and a card run is comparable with a CPU run.
Options of the JAX entry point that the port does not cover yet
(gradient accumulation, bf16, meshes, int8 slots, checkpoints, config
overrides) raise rather than being ignored.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import get_optimizer, schedules
from repro_torch.core.scaling import scaled_lr
from repro_torch.data import batch_iterator, synthetic_mnist
from repro_torch.models import build_model
from repro_torch.train import (create_train_state, make_eval_step,
                               make_train_step, train_loop)
from repro_torch.treepath import tree_leaves


def make_lr_schedule(args) -> schedules.Schedule:
    """Batch-size scaling of (--lr, --base-batch), then either warmup +
    polynomial decay (--warmup > 0) or a flat scaled LR."""
    if args.warmup > 0:
        return schedules.large_batch_lr(
            args.lr, args.base_batch, args.batch, total_steps=args.steps,
            warmup_steps=args.warmup, policy=args.lr_policy)
    return schedules.constant(
        scaled_lr(args.lr, args.base_batch, args.batch, args.lr_policy))


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimizer", default="lars",
                    choices=("lars", "lamb", "sgd", "adamw"))
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--lr-policy", default="none",
                    choices=("none", "linear", "sqrt"),
                    help="batch-size LR scaling from (--lr, --base-batch)")
    ap.add_argument("--base-batch", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=0,
                    help="warmup steps; >0 switches to the You et al. "
                    "warmup + polynomial-decay schedule")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--opt-state-dtype", default="f32")
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    return ap.parse_args(argv)


def _check_ported(args) -> None:
    unported = {
        "--reduced": args.reduced,
        f"--accum-steps {args.accum_steps}": args.accum_steps != 1,
        f"--precision {args.precision}": args.precision != "f32",
        f"--opt-state-dtype {args.opt_state_dtype}":
            args.opt_state_dtype != "f32",
        f"--mesh {args.mesh}": args.mesh is not None,
        "--checkpoint": args.checkpoint is not None,
        "--resume": args.resume is not None,
        "--set": bool(args.set),
    }
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch.launch.train")


def main(argv=None) -> dict:
    """Train; returns a summary (losses, timings, eval accuracy)."""
    args = parse_args(argv)
    _check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    model = build_model(cfg)
    opt = get_optimizer(args.optimizer, learning_rate=make_lr_schedule(args))
    state = create_train_state(
        model, opt, torch.Generator().manual_seed(args.seed), device=device)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    print(f"arch={cfg.name} family={cfg.family} params={n_params:,} "
          f"opt={opt.name} lr={args.lr} device={device} "
          f"global_batch={args.batch}")

    # size the procedural dataset to the global batch: batch_iterator's
    # epoch wrap can only cover a shortfall of one dataset
    x_tr, y_tr, x_te, y_te = synthetic_mnist(max(8192, args.batch))
    batches = (to_device(b, device) for b in batch_iterator(
        x_tr, y_tr, batch=args.batch, seed=args.seed))
    eval_batches = [to_device({"x": x_te[i:i + 256], "y": y_te[i:i + 256]},
                              device) for i in range(0, len(x_te), 256)]

    state, hist = train_loop(make_train_step(model, opt, cfg), state,
                             batches, args.steps, log_every=args.log_every,
                             eval_fn=make_eval_step(model, cfg),
                             eval_batches=eval_batches)
    run, ev = hist[-2], hist[-1]
    dt = run["train_s"]
    summary = {"arch": cfg.name, "optimizer": opt.name,
               "device": str(device), "params": n_params,
               "batch": args.batch, "steps": args.steps,
               "losses": run["losses"], "train_s": dt,
               "steps_per_s": args.steps / dt,
               "examples_per_s": args.steps * args.batch / dt,
               "eval_accuracy": ev["eval_accuracy"]}
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({summary['steps_per_s']:.2f} steps/s, "
          f"{summary['examples_per_s']:.0f} examples/s)")
    print(f"eval accuracy: {ev['eval_accuracy']:.4f}")
    return summary


if __name__ == "__main__":
    main()
