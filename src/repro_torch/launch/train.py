"""Training entry point of the port: port of ``repro/launch/train.py``. ``--arch`` selects lenet-mnist (the paper's
cnn), a dense LM — smollm-135m, qwen3-14b, qwen2-72b, minitron-8b —,
an MoE LM — granite-moe-3b-a800m, deepseek-v2-236b (MLA) —, the SSM LM
falcon-mamba-7b, the hybrid zamba2-7b, the encoder-decoder whisper-base
or the vlm paligemma-3b (``--reduced``: the CPU-scale variant; the last
two train on zero stub frames or image embeddings, as the reference),
and ``--set FIELD=VALUE`` overrides config fields after ``--reduced``,
as the reference does: the memory-lean LM path (``flash_vjp=true``,
``attn_q_chunk``, ``loss_chunk``, ``remat_block``) and a cut depth
(``num_layers=2``) are set so. It runs through the large-batch
:class:`~repro_torch.train.pipeline.TrainPipeline` — microbatched
gradient accumulation, the bf16/f32 precision policy — with f32 or int8
optimizer slots, fed by :class:`~repro_torch.data.ShardedLoader` (host
batches placed on the device two steps ahead), and saves or resumes the
full TrainState as npz.

Examples (on the card; ``--device cpu`` runs them on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch lenet-mnist \
      --optimizer lars --batch 8192 --steps 20 --lr 0.01 \
      --lr-policy linear --base-batch 32 --warmup 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch lenet-mnist \
      --optimizer lars --opt-state-dtype int8 --accum-steps 8 \
      --precision bf16 --batch 8192 --steps 20 --lr 0.01 \
      --lr-policy linear --base-batch 32 --warmup 5 --checkpoint ckpt/s.npz
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --optimizer lamb --batch 16 --seq 1024 --steps 10 --lr 0.001
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --steps 10 --batch 8 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
      --set num_layers=2 --set flash_vjp=true --set attn_q_chunk=2048 \
      --set loss_chunk=1024 --batch 4 --seq 4096 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-3b-a800m --reduced --steps 5 --batch 8 --seq 32 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
      --set num_layers=24 --batch 4 --seq 4096 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
      --set flash_vjp=true --batch 64 --seq 448 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \
      --reduced --steps 5 --batch 4 --seq 32 --device cpu

Data parallelism and ZeRO, under ``torchrun`` (one process per rank,
one card each, NCCL; ``--device cpu`` takes gloo and CPU ranks):
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch smollm-135m --mesh 8x1 --zero --batch 64 --seq 1024 --steps 10

``--mesh auto|DATAxMODEL`` builds the mesh over the default process
group (``auto``: every rank on ``data``); without ``--mesh`` the run is
one device and no process group, as before (the reference defaults to
``auto`` over the local devices). ``--zero`` row-shards the packed
optimizer slots over the mesh's data axis (the reference's
``TrainPipeline(zero=True)``, which its launcher does not expose). Each
rank takes its rows of every global batch (the ranks of one ``data`` row
the same rows; for the moe family under ``--accum-steps``, its block of
each microbatch), and the moe family routes each global microbatch
together, as the reference. A ``model`` axis above 1 is tensor
parallelism for the dense family (Megatron splits) and the moe family
(expert parallelism: the experts split over ``model``, or each expert's
ff where ``model`` does not divide the experts), with GQA or MLA
attention (deepseek's heads split); the ssm, hybrid, encdec and vlm
families raise, naming queue 1 item 4b-ii; LeNet runs replicated. E.g.
on two CPU ranks:
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
      repro_torch.launch.train --arch smollm-135m --reduced --device cpu \
      --mesh 1x2 --batch 8 --seq 32 --steps 5
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
      repro_torch.launch.train --arch granite-moe-3b-a800m --reduced \
      --device cpu --mesh 2x1 --batch 8 --seq 32 --steps 5 \
      --accum-steps 2 --set num_experts=8 --set experts_per_token=2 \
      --set capacity_factor=0.5
Only rank 0 prints the steps and writes the checkpoint (a ZeRO state's
rows and a tensor-parallel state's blocks are gathered from every rank
first: the file is the one-device run's).

TF32 is switched off for matrix products and cuDNN convolutions, so f32
means f32 on the card and a card run is comparable with a CPU run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import get_optimizer, schedules
from repro_torch.core.scaling import scaled_lr
from repro_torch.data import (ShardedLoader, TokenTaskConfig,
                              batch_iterator, place, synthetic_mnist,
                              token_batches)
from repro_torch.launch.mesh import init_distributed, mesh_from_spec, world
from repro_torch.launch.overrides import apply_overrides
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline, make_eval_step, train_loop
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


def lm_batches(cfg, batch: int, seq: int, seed: int = 0):
    """Host-side numpy token batches (device placement is the loader's
    job): the Markov source over ``min(V, 512)`` tokens; with zero f32
    stub ``frames`` (B, encoder_seq, d) for the encdec family and zero
    ``image_embeddings`` (B, num_image_tokens, d) for vlm, as the
    reference."""
    task = TokenTaskConfig(vocab_size=min(cfg.vocab_size, 512), seed=seed)
    for toks in token_batches(task, batch=batch, seq_len=seq, seed=seed):
        b = {"tokens": np.asarray(toks[:, :seq], np.int32)}
        if cfg.family == "encdec":
            b["frames"] = np.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
        if cfg.family == "vlm":
            b["image_embeddings"] = np.zeros(
                (batch, cfg.num_image_tokens, cfg.d_model), np.float32)
        yield b


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
    ap.add_argument("--batch", type=int, default=32,
                    help="GLOBAL batch size (split into --accum-steps "
                    "microbatches)")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches accumulated per optimizer update")
    ap.add_argument("--opt-state-dtype", default="f32",
                    choices=("f32", "int8"),
                    help="optimizer slot storage: int8 codes + per-block "
                    "f32 scales (weights stay f32)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="bf16: bf16 compute + f32 master weights")
    ap.add_argument("--mesh", default=None,
                    help="auto or DATAxMODEL: a (data, model) mesh over "
                    "the ranks of the process group (torchrun); MODEL > 1 "
                    "is tensor parallelism (heads, GQA or MLA; MLPs) and "
                    "expert parallelism (moe family); default none, one "
                    "device")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO: row-shard the packed optimizer slots over "
                    "the mesh's data axis (needs --mesh)")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM training sequence length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None,
                    help="save the FULL TrainState here when done")
    ap.add_argument("--resume", default=None,
                    help="restore a TrainState checkpoint before training")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="config override, e.g. --set remat_block=8")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns a summary (losses, timings, eval accuracy)."""
    args = parse_args(argv)
    if args.batch % args.accum_steps:
        raise SystemExit(f"--batch {args.batch} must be divisible by "
                         f"--accum-steps {args.accum_steps}")
    if args.zero and args.mesh is None:
        raise SystemExit("--zero needs --mesh (the slots shard across its "
                         "data axis)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    mesh = None
    if args.mesh is not None:
        device = init_distributed(device)
        mesh = mesh_from_spec(args.mesh, device=device)
        if mesh is None:
            print(f"rank {world()[0]} lies past --mesh {args.mesh}: idle")
            return {"rank": world()[0], "mesh": None}
    lead = world()[0] == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = apply_overrides(cfg, args.set)
    model = build_model(cfg)
    opt = get_optimizer(args.optimizer, learning_rate=make_lr_schedule(args),
                        slot_dtype=args.opt_state_dtype)
    pipeline = TrainPipeline(model, opt, cfg, accum_steps=args.accum_steps,
                             precision=args.precision, mesh=mesh,
                             zero=args.zero)
    state = pipeline.init_state(torch.Generator().manual_seed(args.seed),
                                device)
    if args.resume:
        state = pipeline.restore(args.resume, state)
        if lead:
            print(f"resumed from {args.resume} at step "
                  f"{state.opt_state.step}")
    resumed_from = state.opt_state.step
    # the whole model's count (a tensor-parallel rank holds blocks)
    n_params = sum(x.numel() for x in tree_leaves(
        pipeline.whole_params or state.params))
    if lead:
        print(f"arch={cfg.name} family={cfg.family} params={n_params:,} "
              f"opt={opt.name} lr={args.lr} device={device} "
              f"global_batch={args.batch} "
              f"micro_batch={args.batch // args.accum_steps} "
              f"accum={args.accum_steps} precision={args.precision} "
              f"opt_state_dtype={args.opt_state_dtype}"
              + (f" mesh={dict(mesh.shape)} zero={args.zero}" if mesh
                 else ""))

    if cfg.family == "cnn":
        # size the procedural dataset to the global batch: batch_iterator's
        # epoch wrap can only cover a shortfall of one dataset
        x_tr, y_tr, x_te, y_te = synthetic_mnist(max(8192, args.batch))
        host_batches = batch_iterator(x_tr, y_tr, batch=args.batch,
                                      seed=args.seed)
        eval_batches = [place({"x": x_te[i:i + 256], "y": y_te[i:i + 256]},
                              device) for i in range(0, len(x_te), 256)]
    else:
        host_batches = lm_batches(cfg, args.batch, args.seq, args.seed)
        eval_batches = None
    batches = ShardedLoader(host_batches, device, mesh=mesh, spec=(
        pipeline.batch_specs(args.batch) if mesh is not None else None),
        blocks=pipeline.row_blocks)
    # hand train_loop the only reference to the first state: it drops
    # each state once the next exists, and a name held here would keep
    # the first alive through the run (22 GB of weights and slots at
    # qwen3-14b's full width)
    first = [state]
    del state
    try:
        state, hist = train_loop(pipeline, first.pop(), batches, args.steps,
                                 log_every=args.log_every if lead else 0,
                                 eval_fn=make_eval_step(model, cfg)
                                 if eval_batches else None,
                                 eval_batches=eval_batches)
    finally:
        batches.close()
    run = next(h for h in hist if "losses" in h)
    eval_acc = hist[-1].get("eval_accuracy")
    dt = run["train_s"]
    summary = {"arch": cfg.name, "optimizer": opt.name,
               "device": str(device), "params": n_params,
               "batch": args.batch, "steps": args.steps,
               "accum_steps": args.accum_steps,
               "precision": args.precision,
               "opt_state_dtype": args.opt_state_dtype,
               "resumed_from_step": resumed_from,
               "mesh": dict(mesh.shape) if mesh is not None else None,
               "zero": args.zero, "rank": world()[0],
               "losses": run["losses"], "aux_losses": run["aux_losses"],
               "train_s": dt,
               "steps_per_s": args.steps / dt,
               "examples_per_s": args.steps * args.batch / dt,
               "eval_accuracy": eval_acc}
    if cfg.family != "cnn":
        summary["seq"] = args.seq
        summary["tokens_per_s"] = args.steps * args.batch * args.seq / dt
    if lead:
        print(f"done: {args.steps} steps in {dt:.1f}s "
              f"({summary['steps_per_s']:.2f} steps/s, "
              f"{summary['examples_per_s']:.0f} examples/s"
              + (f", {summary['tokens_per_s']:.0f} tokens/s"
                 if "tokens_per_s" in summary else "") + ")")
        if eval_acc is not None:
            print(f"eval accuracy: {eval_acc:.4f}")
    if args.checkpoint:
        # gathers a ZeRO state's rows and a tensor-parallel state's blocks
        pipeline.save(args.checkpoint, state)
        if lead:
            print(f"full TrainState checkpoint -> {args.checkpoint}")
    return summary


if __name__ == "__main__":
    main()
