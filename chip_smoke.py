#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — the CUDA kernels, from the sources in the repository, one
             ``nvcc`` per source, all started together;
3. kernels — first the launch floor (a one-element ``zero_()`` timed as
             the kernels are), then every kernel of the main paths against
             its plain PyTorch version on the card, with the kernel's, the
             plain version's and a library call's device time (calls
             replayed from a CUDA graph between CUDA events) beside the
             least time the card could take (its HBM bound), and the kernel
             wrapper's per-call dispatch time: ``norms_flat`` (per row,
             beside the device time of ``packing.fold_rows``, which folds
             its 272 row sums into LeNet's 10 layer slices),
             ``apply_flat``,
             ``apply_flat_q8`` at LeNet's packed shape (272, 512) and at
             (65536, 512); ``flash_decode`` in bf16 at the serve path's
             shape (B 32, S 4096, Hkv 3, G 3, D 64, lengths drawn in
             1..S) and at a D = 128 GQA shape (B 8, S 32768, Hkv 8, G 5,
             every length 32768), with each shape's split count and CTA
             count (the kernel splits the keys), its library call one
             ``F.scaled_dot_product_attention(..., enable_gqa=True)`` with
             the length mask; and ``flash_decode`` in f32 and bf16 at D 64
             and 128 with a zero-length row (which must give zeros);
4. main    — ``repro_torch.launch.train``'s ``main`` on the card,
             lenet-mnist at batch 8192 for 20 steps: with LARS (exactly
             one ``norms_flat`` and one ``apply_flat`` launch per step),
             with SGD (none), with LARS again, warm, and the large-batch
             path — LARS with int8 momentum, 8 accumulated microbatches
             and bf16 compute (exactly one ``norms_flat`` and one
             ``apply_flat_q8`` launch per step, no ``apply_flat``);
5. card vs CPU — 5 LARS steps at batch 32 from one seeded init, on the CPU
             with the plain versions and on the card with the kernels,
             with f32 and with int8 momentum: the loss trajectories must
             agree (TF32 off);
6. checkpoint — the large-batch path for 10 steps, saved, restored into a
             fresh state and run 10 more steps, against 20 uninterrupted
             steps: bit for bit, with cuDNN's deterministic algorithms;
7. profile — a short ``torch.profiler`` window over main-path steps (f32
             LARS and the large-batch path) fed by the loader: the
             device's busy share, time by kernel, the loader's H2D copies
             and the hand kernels' own device time in a step;
8. serve   — ``repro_torch.launch.serve``'s ``main`` on the card:
             smollm-135m at full width (30 layers, bf16, random weights
             from seed 0), 32 slots of capacity 4096 (a 3.0 GB KV cache),
             64 requests with prompts of 256-2048 tokens and 32-256 new
             tokens, a Poisson arrival every tick: exactly 30
             ``flash_decode`` launches per decode tick and no LARS kernel,
             every request finished with finite logits;
9. serve card vs CPU — reduced smollm in f32: 16 teacher-forced decode
             steps, card (kernel) against CPU (plain version), logits
             within 1e-4; the engine's greedy tokens identical on both;
             no ``flash_decode`` launch during prefill;
10. serve profile — full-width smollm, 32 busy slots: admission launches
             no ``flash_decode``; a ``torch.profiler`` window over 5
             decode ticks: busy share, top device ops, ``flash_decode``'s
             time and launches in a tick;
11. experiments — the paper's experiment harness
             (``repro_torch.experiments.GridRunner``) on the card, into
             fresh directories under ``build/``: the registered
             ``lars_vs_sgd_smoke`` grid (4 cells, 544 steps) and
             ``int8_parity_smoke`` (8 cells, 1,088 bf16 steps of 4
             microbatches): every cell finishes with finite losses, each
             LARS cell launches exactly one ``norms_flat`` and one
             ``apply_flat`` (f32 momentum) or ``apply_flat_q8`` (int8) per
             step and each SGD cell none, and the report carries C1, C3,
             C4 (and P1); the smoke grid killed mid-cell past a checkpoint
             and resumed gives trajectories and rows equal to the
             uninterrupted run's; steps/s of the b64 LARS cell with and
             without the per-step statistics and with cuDNN's
             deterministic algorithms on and off; a profile of 50 of its
             steps (the device's busy share, time by kernel);
12. LM training — ``norms_flat``, ``apply_flat`` and ``apply_flat_q8``
             at smollm-135m's packed shape (263144, 512), timed and held
             against their plain versions as in phase 3;
             ``repro_torch.launch.train``'s ``main`` with smollm-135m at
             full width (30 layers, bf16 parameters), 16 x 1024 tokens,
             for 4 steps each of LARS (one ``norms_flat`` and one
             ``apply_flat`` launch per step), LAMB (none) and the
             large-batch LARS path (bf16, int8 momentum, 4 microbatches
             of 16: one ``norms_flat`` and one ``apply_flat_q8`` per
             step): steps/s, tokens/s, the allocator's peak, finite
             losses; a profile of one full-width step of each LARS path
             fed by the loader (busy share, time by kernel, the H2D
             copies); reduced smollm in f32, 20 steps of LARS and of LAMB
             on the card against the CPU; LeNet (LARS, batch 8192) and the
             reduced LM (LAMB) for 5 steps through ``ShardedLoader`` with
             prefetch and without, bit-identical; the registered
             ``lm_smoke`` grid through ``GridRunner`` (8 cells, 1,152
             steps) with its launches per cell, then killed mid-cell and
             resumed to equal trajectories and rows;
13. lean LM — the memory-lean path (``flash_vjp``, ``attn_q_chunk``,
             ``loss_chunk``, ``remat_block``, set through ``--set``):
             first ``norms_flat``, ``apply_flat`` and ``apply_flat_q8``
             at qwen3-14b's packed shape (4329072, 512), on fresh buffers,
             timed beside their HBM bound and held against their plain
             versions (run on row chunks) on every row, the rows past
             element 2^31 reported apart; ``launch.train.main`` with
             smollm-135m at phase 12's 16 x 1024 and LARS, each knob alone
             and all four together (one ``norms_flat`` and one
             ``apply_flat`` per step; steps/s, tokens/s, the allocator's
             peak), and a profile of one step with all four;
             qwen3-14b at full width and 2 layers (``--set
             num_layers=2``), 4 x 4096 tokens through ``flash_vjp``,
             ``attn_q_chunk=2048`` and ``loss_chunk=1024``: 3 steps of f32
             LARS (one ``norms_flat`` and one ``apply_flat`` per step) and
             3 of the large-batch path (bf16, int8 momentum, 2
             microbatches: one ``norms_flat`` and one ``apply_flat_q8``),
             finite losses, tokens/s and the peak; from one shared init, a
             profiled step of each and the stock path against the lean
             path at batch 1 (loss trajectories within STOCK_LEAN_RTOL,
             both peaks); reduced qwen3 in f32 with all four knobs, 20
             LARS steps on the card against the CPU, and its decode, 16
             teacher-forced steps, card against CPU;
14. MoE   — granite-moe-3b-a800m (40 experts, top-8): ``norms_flat``,
             ``apply_flat`` and ``apply_flat_q8`` at the packed shape of
             its 8-layer superbuffer (rows from the layout), timed and
             held on every row as in phase 13, and ``flash_decode`` at its
             decode shape (B 32, S 4096, Hkv 8, G 3, D 64, bf16) timed as
             in phase 3; ``launch.train.main`` at full width, 8 of its 32
             layers (``--set num_layers=8``), 4 x 4096 tokens through
             phase 13's lean knobs, 3 steps each of f32 LARS and the
             large-batch path (one ``norms_flat`` and one ``apply_flat``
             or ``apply_flat_q8`` per step; finite losses, aux losses
             finite and nonzero; steps/s, tokens/s, the peak); from the
             same seed-0 init, the share of dropped slots at layer 0 for
             the first batch and a profiled f32 LARS step;
             ``launch.serve.main`` at full width and the same 8 layers
             (bf16), phase 8's 64 requests over 32 slots of capacity 4096:
             8 ``flash_decode`` launches per decode tick, none in
             admission, finite logits; reduced granite that drops slots
             (8 experts, top-2, capacity factor 0.5) in f32: 20 LARS
             steps card against CPU within 1e-5, 16 teacher-forced decode
             steps within 1e-4, greedy tokens identical;
15. MLA and masks — deepseek-v2-236b at every published width, 2 of its
             60 layers and 16 of its 160 routed experts (``--set
             num_layers=2 --set num_experts=16``), 4 x 4096 tokens
             through ``flash_vjp``, ``attn_q_chunk=512``,
             ``loss_chunk=1024`` and remat: 3 steps each of f32 LARS and
             the large-batch path (one ``norms_flat`` and one
             ``apply_flat`` or ``apply_flat_q8`` per step; finite losses,
             aux losses finite and nonzero; tokens/s, the peak); from the
             same seed-0 init, layer 0's dropped share, its MLA attention
             and MoE block timed apart (forward and backward, CUDA
             events) and a profiled f32 LARS step; ``launch.serve.main``
             with all 160 experts at 1 layer (bf16), phase 8's traffic:
             no ``flash_decode`` launch (the absorbed decode is torch
             ops), every request finished, finite logits, the decode
             ticks' dropped share and the latent cache's bytes beside an
             expanded K/V cache's; reduced deepseek with a nonzero query
             rank in f32: 20 LARS steps card against CPU within 1e-5, 16
             teacher-forced decode steps within 1e-4, greedy tokens
             identical; smollm-135m at full width, 16 x 1024, with
             ``sliding_window=256`` and ``attn_logit_softcap=50.0``: 4
             LARS steps through the stock core and 4 through
             ``flash_vjp`` (launches gated, tokens/s beside phase 12's),
             and reduced qwen3 with both, 20 LARS steps card against CPU
             within 1e-5;
16. SSM and hybrid — ``norms_flat``, ``apply_flat`` and
             ``apply_flat_q8`` at the packed shapes of falcon-mamba-7b's
             8-layer and zamba2-7b's 12-layer superbuffers, on fresh
             buffers, held on every row and timed
             as in phase 13, and ``flash_decode`` at zamba2's decode shape
             (B 32, S 4096, Hkv 32, G 1, D 112, bf16) timed as in phase 3;
             then for each model at full width and that depth (``--set
             num_layers=8`` / ``12``), 4 x 4096 tokens through phase 13's
             lean knobs: 3 steps each of f32 LARS and the large-batch path
             through ``launch.train.main`` (one ``norms_flat`` and one
             ``apply_flat`` or ``apply_flat_q8`` per step; finite losses;
             tokens/s, the peak); on the f32 run's state after its steps
             (one init shared), layer 0's Mamba block (and zamba2's shared
             block) timed apart, forward and backward, and one more f32
             LARS step profiled; ``launch.serve.main``
             at the same depth with phase 8's traffic (falcon-mamba: no
             ``flash_decode`` launch; zamba2: 2 a tick, one per
             application of its shared block, none in admission; every
             request finished, finite logits), the recurrent cache's bytes
             beside a K/V cache's of the same depth; the reduced configs in
             f32 (zamba2 at 3 layers): 20 LARS steps card against CPU
             within 1e-5, 16 teacher-forced decode steps within 1e-4,
             greedy tokens identical;
17. encdec and vlm — ``norms_flat``, ``apply_flat`` and ``apply_flat_q8``
             at paligemma-3b's packed shape (4899880, 512), past element
             2^31, held on every row and timed as in phase 13;
             ``flash_decode``'s wide kernel (bf16 past D 128:
             paligemma's MQA, G 8, D 256) at its serve shape (B 32, S
             448) and at decode_32k's length (B 8, S 32768), lengths 0,
             1, S and past S among the rows, and at whisper's
             cross-attention decode (B 32, S 1500, Hkv 8, G 1, D 64),
             timed as in phase 3, the D 256 instance in f32 held too,
             NaN rows past each length kept out of every bf16 instance's
             output (D 64, 128, 256: the same bits as finite rows), and
             ptxas's registers and spills of the D 256 instances (the
             wide kernel's spill-free, or the phase fails); then
             whisper-base whole (64 clips of 1,500 stub
             frames and 448 decoder tokens, ``flash_vjp``) and
             paligemma-3b at full width and all 18 layers (4 x 4096 text
             tokens behind 256 seeded normal image embeddings, where the
             reference's zero stub overflows the gradient at this depth,
             through ``flash_vjp``,
             ``attn_q_chunk=1088`` and ``loss_chunk=1024``): 3 steps each
             of f32 LARS and the large-batch path through
             ``launch.train.main`` (one ``norms_flat`` and one
             ``apply_flat`` or ``apply_flat_q8`` per step; tokens/s,
             whisper's frames/s, the peak) and a profiled f32 step;
             ``DecodeEngine`` at the same width and depth (bf16): 32
             requests (whisper: 4 prompt tokens over 1,500 seeded frames;
             paligemma: 64 behind 256 seeded image embeddings), 128 new
             tokens: 12 (whisper: self- and cross-attention) or 18
             ``flash_decode`` launches a tick, none in prefill, tick ms,
             tokens/s; reduced whisper, reduced paligemma and reduced
             paligemma at 8 heads on 1 kv head of 256 (the D 256 instance)
             in f32: 20 LARS steps card against CPU within 1e-5, 16
             teacher-forced decode steps within 1e-4, ``DecodeEngine``'s
             greedy tokens identical;
18. tree engine and PBT — ``launch.train.main`` on markerless (tree)
             optimizer states, LeNet at phase 4's batch 8192 and 20 steps:
             f32 LARS, SGD, LAMB, AdamW and the large-batch LARS path
             (bf16, f32 master tree, int8 momentum, 8 microbatches
             unfused): no ``norms_flat``/``apply_flat``/``apply_flat_q8``
             launch, finite losses, steps/s beside phase 4's; 20 f32 LARS
             steps from one init on a tree and a packed state at a flat
             LR of 0.01 (params within 2e-5 / 1e-5, losses within 1e-5;
             the packed run one ``norms_flat`` and one ``apply_flat`` a
             step) and on phase 4's schedule (logged), each pair timed;
             smollm-135m whole at 16 x 1024 on tree states (f32 LARS and
             the large-batch path at 4 microbatches of 4: tokens/s and
             peak beside a packed run of each in turn and phase 12's), a
             profiled f32
             step on each engine with its optimizer update's kernels
             (count, device ms) and host ms; reduced smollm in f32, 20 tree-state LARS steps card
             against CPU within 1e-5; ``launch.experiment --grid pbt_smoke
             --pbt --population 4 --exploit-every 4`` into ``build/pbt/``:
             every member finished, killed or early-stopped, finished
             members with finite losses, one ``norms_flat`` and one
             ``apply_flat`` per LARS step of every segment and none per
             SGD step, the report's ``pbt`` block (claims logged); the
             same run killed mid-round and resumed: ``pbt.json`` and every
             trajectory identical. The phases' wall times are printed at
             the end.

From phase 13 on, a model's seeded init is drawn on the host once per
phase and shared by its training runs, sessions and serving
(``shared_inits``: the same values as a fresh init).

It then prints nvidia-smi's line, a ``{"kernels": [...]}`` line (all four
kernels, each with the launch floor as ``floor_ms``) and, last,
``{"ok": true, "device": {...}}``. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SHAPES = [(272, 512), (65536, 512)]   # LeNet's packed buffer; HBM-sized
GRAPH_CALLS = {272: 100, 65536: 10, 263144: 5}  # calls per timed graph
MAIN_ROWS = 272
MAIN_STEPS = 20
MAIN_ARGS = ["--arch", "lenet-mnist", "--batch", "8192",
             "--steps", str(MAIN_STEPS), "--lr", "0.01",
             "--lr-policy", "linear", "--base-batch", "32", "--warmup", "5",
             "--log-every", "0"]
# the large-batch path: int8 LARS momentum, 8 microbatches, bf16 compute
LARGE_BATCH = ["--optimizer", "lars", "--opt-state-dtype", "int8",
               "--accum-steps", "8", "--precision", "bf16"]
KERNELS = ("norms_flat", "apply_flat", "apply_flat_q8")
# norms_flat sums the 512 squares of a row in another order than torch.sum:
# f32 relative error ~ sqrt(512) * 2^-24 ~ 1.3e-6 for such sums.
NORMS_RTOL = 1e-5
# apply_flat is built with -fmad=false and does the plain version's
# operations in its order: the two must agree bit for bit.
APPLY_ATOL = 0.0
# apply_flat_q8 likewise, and quantizes with IEEE division and round half
# to even as its plain version does: bit for bit in w', q' and scale'.
APPLY_Q8_ATOL = 0.0
# 5 LARS steps at b32, card (cuDNN convs, kernels) vs CPU (plain): only
# f32 summation orders differ; the golden b32 pin holds 1e-4 over 20 steps.
# With int8 momentum such a difference can round a code the other way,
# which moves its value by a whole step of the block scale: 1e-3.
CARD_CPU_RTOL = {"f32": 1e-4, "int8": 1e-3}
CKPT_STEPS = 10

# flash_decode: (B, S, Hkv, G, D, lengths) timed in bf16 — the serve
# path's shape (lengths drawn in 1..S) and decode_32k's D = 128 GQA shape
FD_SHAPES = [(32, 4096, 3, 3, 64, "drawn"), (8, 32768, 8, 5, 128, "full")]
FD_CALLS = {448: 50, 1500: 20, 4096: 20, 32768: 5}   # calls per timed graph
# the kernel sums in another order than its plain version (an online
# rescale per tile of keys, a merge of warps and of splits): f32 agrees to a few ulp of values of order
# one; bf16 outputs round the same f32 result, so one bf16 ulp (2^-7
# relative) may separate them
FD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-6)}
SERVE_ARGS = ["--arch", "smollm-135m", "--slots", "32", "--capacity", "4096",
              "--requests", "64", "--prompt-min", "256", "--prompt-max",
              "2048", "--new-min", "32", "--new-max", "256",
              "--arrival-every", "1", "--seed", "0"]
# reduced smollm, card vs CPU: only f32 summation orders differ
SERVE_CARD_CPU_ATOL = 1e-4

# phase 11: the registered grids it runs; the kill lands in the smoke
# grid's second cell (lars-b64, 256 steps, after sgd-b64's 256) at its
# step 110, past its step-100 checkpoint
EXP_GRIDS = ("lars_vs_sgd_smoke", "int8_parity_smoke")
EXP_KILL_AFTER = 256 + 110
EXP_PROFILE_STEPS = 50

# phase 12: smollm-135m at full width (a (263144, 512) superbuffer of
# 272 layer slices) through launch.train, batch 16 x 1024 tokens
LM_ROWS, LM_SLICES = 263144, 272
LM_STEPS = 4
LM_ARGS = ["--arch", "smollm-135m", "--batch", "16", "--seq", "1024",
           "--steps", str(LM_STEPS), "--lr", "0.01", "--log-every", "0"]
LM_RUNS = {"lars": ["--optimizer", "lars"],
           "lamb": ["--optimizer", "lamb"],
           # the large-batch LARS path: int8 momentum, 4 microbatches of
           # 16, bf16 compute
           "lars_int8_bf16_accum4": ["--optimizer", "lars", "--precision",
                                     "bf16", "--opt-state-dtype", "int8",
                                     "--accum-steps", "4", "--batch", "64"]}
# reduced smollm in f32, card against CPU, 20 steps
LM_CARD_CPU_ARGS = ["--arch", "smollm-135m", "--reduced", "--batch", "8",
                    "--seq", "64", "--steps", "20", "--lr", "0.01",
                    "--log-every", "0"]
# only f32 summation orders differ (cuBLAS against the CPU's GEMMs):
# measured 2.3e-7 (LARS) and 1.6e-7 (LAMB) relative over the 20 steps on
# an H100 80GB HBM3 at 700 W; held at 1e-5
LM_CARD_CPU_RTOL = {"lars": 1e-5, "lamb": 1e-5}
LOADER_STEPS = 5
# the registered lm_smoke grid: the kill lands in its second cell
# (adamw-b16, 256 steps, after lamb-b16's 256) at its step 110, past its
# step-100 checkpoint
LM_GRID = "lm_smoke"
LM_KILL_AFTER = 256 + 110

# phase 13: the memory-lean LM path. smollm-135m at phase 12's 16 x 1024
# with LARS, each knob alone and then all four, through --set
LEAN_RUNS = {
    "flash_vjp": ["flash_vjp=true"],
    "flash_vjp_q512": ["flash_vjp=true", "attn_q_chunk=512"],
    "loss_chunk": ["loss_chunk=1024"],
    "remat_block": ["remat_block=5"],
    "all_four": ["flash_vjp=true", "attn_q_chunk=512", "loss_chunk=1024",
                 "remat_block=5"]}
# qwen3-14b at full width, depth cut to 2 layers (2,216,453,632
# parameters; a (4329072, 512) superbuffer of 25 slices), train_4k's
# sequence length, through the reference's hillclimb settings
QWEN = ["--arch", "qwen3-14b", "--set", "num_layers=2"]
QWEN_LEAN = ["flash_vjp=true", "attn_q_chunk=2048", "loss_chunk=1024"]
QWEN_ROWS, QWEN_SLICES = 4329072, 25
QWEN_STEPS = 3
QWEN_ARGS = QWEN + [a for v in QWEN_LEAN for a in ("--set", v)] + [
    "--batch", "4", "--seq", "4096", "--steps", str(QWEN_STEPS),
    "--lr", "0.01", "--log-every", "0"]
QWEN_RUNS = {"lars": ["--optimizer", "lars"],
             # the large-batch LARS path: int8 momentum, bf16 compute,
             # 2 microbatches of 2
             "lars_int8_bf16_accum2": ["--optimizer", "lars", "--precision",
                                       "bf16", "--opt-state-dtype", "int8",
                                       "--accum-steps", "2"]}
# the first superbuffer row past element 2^31, and the rows of a chunk
# the plain versions run on (their temporaries would not fit at full size)
PAST_2_31 = 2 ** 31 // 512
PLAIN_CHUNK = 1 << 20
# stock against lean, batch 1 at the longest of 4096/2048/1024 that the
# stock path fits (tools/lean_probe.py: 4096, at a 64.85 GiB peak). The
# same function in bf16 activations, the score products summed in
# another order: tools/lean_probe.py measured the 3-step loss
# trajectories within 1.2e-5 relative at b1 x 4096 (2.3e-5 at 1024) on
# an H100 80GB HBM3 at 700 W; held at 1e-4
STOCK_LEAN = (1, 4096)
STOCK_LEAN_RTOL = 1e-4
# reduced qwen3-14b in f32 with the four knobs: 20 LARS steps, card
# against CPU, at phase 12's gate
QWEN_CARD_CPU_ARGS = ["--arch", "qwen3-14b", "--reduced", "--batch", "8",
                      "--seq", "64", "--steps", "20", "--lr", "0.01",
                      "--log-every", "0", "--optimizer", "lars",
                      "--set", "flash_vjp=true", "--set", "attn_q_chunk=16",
                      "--set", "loss_chunk=16", "--set", "remat_block=2"]

# phase 14: the MoE family. granite-moe-3b-a800m (the reference's config
# verbatim) at full width, depth cut to 8 of its 32 layers (881,299,968
# parameters; f32 LARS at 32 would not fit the card, and 16 ran until the
# script needed the time for phase 16), 4 x 4096 tokens a step through
# phase 13's lean knobs: f32 LARS and the large-batch path, as qwen3's
# runs
GRANITE = "granite-moe-3b-a800m"
GRANITE_LAYERS = 8
GRANITE_STEPS = 3
GRANITE_ARGS = ["--arch", GRANITE, "--set", f"num_layers={GRANITE_LAYERS}"] \
    + [a for v in QWEN_LEAN for a in ("--set", v)] + [
    "--batch", "4", "--seq", "4096", "--steps", str(GRANITE_STEPS),
    "--lr", "0.01", "--log-every", "0"]
# served at the same cut (bf16; full depth until the script needed the
# time for phase 16): 32 slots of capacity 4096 (a 2.1 GB KV cache),
# phase 8's traffic
GRANITE_SERVE_ARGS = ["--arch", GRANITE, "--set",
                      f"num_layers={GRANITE_LAYERS}"] + SERVE_ARGS[2:]
# flash_decode at granite's decode shape
GRANITE_FD = (32, 4096, 8, 3, 64, "drawn")
# reduced granite that drops slots (8 experts, top-2, capacity factor
# 0.5; the reduced config routes top-4 of 4 and never drops), f32: 20
# LARS steps card against CPU at phase 12's gate, its decode at phase 9's
GRANITE_DROP = {"num_experts": 8, "experts_per_token": 2,
                "capacity_factor": 0.5}
GRANITE_CARD_CPU_ARGS = [
    "--arch", GRANITE, "--reduced", "--batch", "8", "--seq", "64",
    "--steps", "20", "--lr", "0.01", "--log-every", "0", "--optimizer",
    "lars"] + [a for k, v in GRANITE_DROP.items()
               for a in ("--set", f"{k}={v}")]

# phase 15: multi-head latent attention, and the training side of sliding
# windows and the logit softcap. deepseek-v2-236b (the reference's config
# verbatim) at every published width, trained at 2 of its 60 layers and
# 16 of its 160 routed experts (2,196,537,344 parameters; one layer's 160
# experts are 3.77 B parameters, which f32 LARS could not hold on the
# card beside the rest), 4 x 4096 tokens a step through flash_vjp,
# attn_q_chunk=512, loss_chunk=1024 and remat: f32 LARS and the
# large-batch path, as qwen3's runs
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_CUT = ["num_layers=2", "num_experts=16"]
DEEPSEEK_LEAN = ["flash_vjp=true", "attn_q_chunk=512", "loss_chunk=1024"]
DEEPSEEK_STEPS = 3
DEEPSEEK_BATCH = 4
DEEPSEEK_ARGS = ["--arch", DEEPSEEK] + [
    a for v in DEEPSEEK_CUT + DEEPSEEK_LEAN for a in ("--set", v)] + [
    "--batch", str(DEEPSEEK_BATCH), "--seq", "4096", "--steps",
    str(DEEPSEEK_STEPS), "--lr", "0.01", "--log-every", "0"]
# served at every width with all 160 experts, 1 of 60 layers
# (5,020,680,192 parameters, bf16; cut from 2 to keep the script within its
# time limit), phase 8's traffic over a latent cache
DEEPSEEK_SERVE_LAYERS = 1
DEEPSEEK_SERVE_ARGS = ["--arch", DEEPSEEK, "--set",
                       f"num_layers={DEEPSEEK_SERVE_LAYERS}"] + SERVE_ARGS[2:]
# reduced deepseek in f32 with a nonzero query rank (the full width's
# q_down / q_norm / q_up path; the reduced preset sets 0): 20 LARS steps
# card against CPU at phase 12's gate, its decode at phase 9's
DEEPSEEK_Q_LORA = {"q_lora_rank": 48}
DEEPSEEK_CARD_CPU_ARGS = [
    "--arch", DEEPSEEK, "--reduced", "--batch", "8", "--seq", "64",
    "--steps", "20", "--lr", "0.01", "--log-every", "0", "--optimizer",
    "lars"] + [a for k, v in DEEPSEEK_Q_LORA.items()
               for a in ("--set", f"{k}={v}")]
# smollm-135m at phase 12's full width and 16 x 1024 with a window and
# the softcap, 4 LARS steps through the stock core and through flash_vjp
MASKS = ["sliding_window=256", "attn_logit_softcap=50.0"]
MASK_ARGS = LM_ARGS + ["--optimizer", "lars"] + [
    a for v in MASKS for a in ("--set", v)]
MASK_RUNS = {"stock": [], "flash_vjp": ["--set", "flash_vjp=true"]}
# reduced qwen3-14b in f32 with both: 20 LARS steps card against CPU
MASK_CARD_CPU_ARGS = [
    "--arch", "qwen3-14b", "--reduced", "--batch", "8", "--seq", "64",
    "--steps", "20", "--lr", "0.01", "--log-every", "0", "--optimizer",
    "lars", "--set", "sliding_window=16", "--set", "attn_logit_softcap=50.0"]

# phase 16: the SSM and hybrid families (the reference's configs verbatim)
# at full width, trained at a cut depth, 4 x 4096 tokens a step through
# phase 13's lean knobs (the loss chunked; in zamba2's shared block
# flash_vjp and query chunks): f32 LARS and the large-batch path, as
# qwen3's runs. falcon-mamba-7b at 8 of its 64 layers (1,375,010,816
# parameters), zamba2-7b at 12 of its 81 (1,370,415,744; the shared block
# after layers 0 and 6). Both are served at the same cut with phase 8's
# traffic. Both trained at 16 and 24 layers too (PERF.md); the cut keeps
# the script within its time limit beside phase 17.
FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
SSM_LAYERS = {FALCON: 8, ZAMBA: 12}
SSM_STEPS = 3


def ssm_args(arch: str) -> list:
    return ["--arch", arch, "--set", f"num_layers={SSM_LAYERS[arch]}"] + [
        a for v in QWEN_LEAN for a in ("--set", v)] + [
        "--batch", "4", "--seq", "4096", "--steps", str(SSM_STEPS),
        "--lr", "0.01", "--log-every", "0"]


def ssm_serve_args(arch: str) -> list:
    return ["--arch", arch, "--set", f"num_layers={SSM_LAYERS[arch]}"] \
        + SERVE_ARGS[2:]


# flash_decode at zamba2's shared block's decode shape: MHA (G = 1) at
# head dim 112, 32 slots of capacity 4096
ZAMBA_FD = (32, 4096, 32, 1, 112, "drawn")
# the reduced configs in f32 (zamba2 at 3 layers: its shared block runs
# after layers 0 and 2, each with its own K/V cache): 20 LARS steps card
# against CPU at phase 12's gate, the decode at phase 9's
SSM_REDUCED = {FALCON: {}, ZAMBA: {"num_layers": 3}}


def ssm_card_cpu_args(arch: str) -> list:
    return ["--arch", arch, "--reduced", "--batch", "8", "--seq", "64",
            "--steps", "20", "--lr", "0.01", "--log-every", "0",
            "--optimizer", "lars"] + [
        a for k, v in SSM_REDUCED[arch].items()
        for a in ("--set", f"{k}={v}")]


# phase 17: the encdec and vlm families (the reference's configs verbatim).
# whisper-base whole (70,595,072 parameters): 64 clips a batch, each 1,500
# stub frames and 448 decoder tokens (Whisper's text context), through
# flash_vjp; f32 LARS and the large-batch path, as qwen3's runs
WHISPER, PALIGEMMA = "whisper-base", "paligemma-3b"
FAMILY_STEPS = 3
WHISPER_ARGS = ["--arch", WHISPER, "--set", "flash_vjp=true", "--batch",
                "64", "--seq", "448", "--steps", str(FAMILY_STEPS), "--lr",
                "0.01", "--log-every", "0"]
# paligemma-3b at full width and all 18 layers (2,508,587,008
# parameters), 4 x 4,096 text tokens behind its 256 image tokens (4,352
# positions a row) through flash_vjp, query chunks of 1,088 (a divisor of
# 4,352) and loss_chunk=1024; f32 LARS and the large-batch path. Its image
# stub is seeded unit normals where launch.train feeds the reference's
# zeros: a zero prefix stays zero through every layer, rmsnorm's gradient
# there is 1 / sqrt(eps), and it compounds through the prefix's
# attention until the gradient overflows from 16 layers on, in the
# reference as in the port (tests/test_torch_vlm.py)
PALI_LAYERS = 18
PALI_LEAN = ["flash_vjp=true", "attn_q_chunk=1088", "loss_chunk=1024"]
PALI_ARGS = ["--arch", PALIGEMMA, "--set", f"num_layers={PALI_LAYERS}"] + [
    a for v in PALI_LEAN for a in ("--set", v)] + [
    "--batch", "4", "--seq", "4096", "--steps", str(FAMILY_STEPS),
    "--lr", "0.01", "--log-every", "0"]
# served by DecodeEngine at the same depth (bf16, the same seed-0 init):
# (requests, prompt tokens, new tokens); whisper's clips carry 1,500 stub
# frames, paligemma's prompts 256 image tokens (so its cache holds 448)
WHISPER_SERVE = (32, 4, 128)
PALI_SERVE = (32, 64, 128)
# flash_decode at paligemma's decode (MQA, G 8, D 256: the wide kernel)
# at its serve shape and at decode_32k's length, lengths 0, 1, S and past
# S among the rows; at whisper's cross-attention decode (G 1, D 64, every
# one of the 1,500 encoder rows)
PALI_FD = [(32, 448, 1, 8, 256, "edges"), (8, 32768, 1, 8, 256, "edges")]
WHISPER_FD = (32, 1500, 8, 1, 64, "full")
# the reduced configs in f32, and reduced paligemma at the full width's
# attention (8 heads on 1 kv head of 256: the D 256 instance against the
# CPU): 20 LARS steps card against CPU at phase 12's gate, the decode at
# phase 9's
FAMILY_REDUCED = {"whisper": (WHISPER, {}), "paligemma": (PALIGEMMA, {}),
                  "paligemma_d256": (PALIGEMMA, {"num_heads": 8,
                                                 "num_kv_heads": 1,
                                                 "head_dim": 256})}


def family_card_cpu_args(arch: str, changes: dict) -> list:
    return ["--arch", arch, "--reduced", "--batch", "8", "--seq", "64",
            "--steps", "20", "--lr", "0.01", "--log-every", "0",
            "--optimizer", "lars"] + [
        a for k, v in changes.items() for a in ("--set", f"{k}={v}")]


# phase 18: the per-leaf tree engine (markerless optimizer states) and
# the PBT controller. LeNet at phase 4's batch, steps and schedule through
# launch.train on tree states; the Adam family at its own flat LR (phase
# 4's linear scaling to batch 8192 would take AdamW's to 2.56)
TREE_RUNS = {"lars": ["--optimizer", "lars"],
             "sgd": ["--optimizer", "sgd"],
             "lamb": ["--optimizer", "lamb", "--lr", "0.001",
                      "--lr-policy", "none"],
             "adamw": ["--optimizer", "adamw", "--lr", "0.001",
                       "--lr-policy", "none"],
             "lars_int8_bf16_accum8": LARGE_BATCH}
# each tree run beside phase 4's packed run of the same path
TREE_PACKED_TWIN = {"lars": "lars_warm", "sgd": "sgd",
                    "lars_int8_bf16_accum8": "lars_int8_bf16_accum8"}
# tree against packed from one init, 20 f32 LARS steps at a flat LR of
# 0.01: the reference's packed-against-tree class for the params
# (tests/test_core_optim.py); the losses see the same forward on params
# that differ by the per-layer norms' summation order only. On phase 4's
# schedule (warmup to 2.56) the trajectory amplifies any such difference
# (phase 4's two identical packed LARS runs, nondeterministic cuDNN, end
# 7.8e-4 apart in the loss): that run is logged, not gated
TREE_PACKED_RTOL, TREE_PACKED_ATOL = 2e-5, 1e-5
TREE_LOSS_RTOL = 1e-5
TREE_PACKED_LR = 0.01
# smollm-135m on tree states: phase 12's f32 LARS run, and its
# large-batch path at 4 microbatches of 4 (phase 12 runs 4 of 16), each
# beside a packed run of the same in turn
TREE_LM_RUNS = {"lars": LM_RUNS["lars"],
                "lars_int8_bf16_accum4": ["--optimizer", "lars",
                                          "--precision", "bf16",
                                          "--opt-state-dtype", "int8",
                                          "--accum-steps", "4",
                                          "--batch", "16"]}
# the record_function range phase 18's profiles put around the update
UPDATE_RANGE = "optimizer.update"
# launch.experiment --pbt on the registered pbt_smoke grid (8 members of
# 16 LeNet steps at b1024, rounds of 4 steps); the kill lands in round 1
# (32 steps in round 0), in its fourth member's second step
PBT_ARGS = ["--grid", "pbt_smoke", "--pbt", "--population", "4",
            "--exploit-every", "4"]
PBT_KILL_AFTER = 32 + 3 * 4 + 2


# Published HBM bandwidth (B/s) and f32 non-tensor-core peak (FLOP/s), by
# the name nvidia-smi reports (NVIDIA data sheets).
CARDS = [("H100 NVL", 3.9e12, 60e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(smi_name: str) -> tuple[float, float]:
    for key, bw, flops in CARDS:
        if key in smi_name:
            return bw, flops
    raise RuntimeError(f"no bandwidth/peak figures for card {smi_name!r}")


def dispatch_ms(fn, *, warmup: int = 5, reps: int = 50) -> float:
    """Median over ``reps`` of one call's CUDA-event time, after warm-up.
    At small shapes this is the host's dispatch of the call, not the
    device's work."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, *, calls: int, warmup: int = 3, reps: int = 20) -> float:
    """Device time of one call: ``calls`` back-to-back calls captured in
    one CUDA graph, the graph replayed between one pair of CUDA events,
    the time divided by ``calls``; the median over ``reps`` replays. The
    host's dispatch stays out of it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def floor_ms(calls: int) -> float:
    """The launch floor: device time of a one-element ``zero_()`` through
    the same CUDA-graph replay as the kernels. No kernel timed that way
    takes less."""
    import torch
    x = torch.empty(1, device="cuda")
    return device_ms(x.zero_, calls=calls)


def timings(fn, calls: int) -> tuple[float, float]:
    """(device ms per call from a CUDA graph, dispatch ms per call)."""
    return device_ms(fn, calls=calls), dispatch_ms(fn)


@contextlib.contextmanager
def shared_inits():
    """Within the block, each model's seeded init is drawn on the host
    once: a later init for the card of the same param shapes from a
    generator in the same state moves the kept host copy there. The
    values are those of a fresh init (the init draws on the host, and the
    card's casts round as the host's do), so a phase's training runs,
    sessions and serving of one model share one draw of its normals
    (16-19 s per 2.2 B parameters). Inits for the CPU or the meta device
    draw as before."""
    import torch
    from repro_torch.models import EncDecModel, LanguageModel
    from repro_torch.treepath import tree_flatten_with_path, tree_map
    memo: dict = {}
    saved = {cls: cls.init for cls in (LanguageModel, EncDecModel)}

    def wrap(inner):
        def init(self, generator, device):
            if torch.device(device).type != "cuda":
                return inner(self, generator, device)
            shapes = tuple((path, tuple(t.shape), t.dtype) for path, t in
                           tree_flatten_with_path(inner(
                               self, torch.Generator(), "meta"))[0])
            key = (shapes, generator.get_state().numpy().tobytes())
            if key not in memo:
                memo[key] = inner(self, generator, "cpu")
            return tree_map(lambda t: t.to(device), memo[key])
        return init

    for cls, fn in saved.items():
        cls.init = wrap(fn)
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.init = fn
        memo.clear()


def lenet_layout():
    """LeNet's packed layout: (272, 512), 10 layer slices."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import packing
    from repro_torch.models import build_model
    from repro_torch.treepath import tree_map
    params = build_model(get_config("lenet-mnist")).init(
        torch.Generator().manual_seed(0), "cpu")
    return packing.build_layout(params, tree_map(lambda _: False, params))


def kernel_phase(lk, bw: float, flops: float) -> tuple[dict, float]:
    """Phase 3: the launch floor, then each kernel against its plain
    version at SHAPES. Returns (rows by kernel, floor ms)."""
    import torch
    layout = lenet_layout()
    if layout.buffer_shape != (MAIN_ROWS, 512):
        raise AssertionError(f"LeNet's layout is {layout.buffer_shape}")
    floor = floor_ms(GRAPH_CALLS[MAIN_ROWS])
    log(f"  launch floor (one-element zero_(), {GRAPH_CALLS[MAIN_ROWS]} "
        f"calls per graph): {floor:.5f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {k: [] for k in KERNELS}
    for rows, lane in SHAPES:
        for name, row in kernel_rows(lk, rows, lane, gen, bw, flops,
                                     layout if rows == MAIN_ROWS else None
                                     ).items():
            out[name].append(row)
    log_kernel_rows(out, floor)
    return out, floor


def kernel_rows(lk, rows: int, lane: int, gen, bw: float, flops: float,
                fold_layout=None) -> dict:
    """norms_flat, apply_flat and apply_flat_q8 at (rows, lane) against
    their plain versions on seeded buffers, timed; with ``fold_layout``,
    also the device time of folding norms_flat's row sums into its
    slices (``fold_ms``). Returns a row by kernel."""
    import torch
    from repro_torch.core import packing
    dev = torch.device("cuda")
    out = {}
    n = rows * lane
    w = torch.randn(rows, lane, generator=gen, device=dev)
    g = torch.randn(rows, lane, generator=gen, device=dev) * 1e-2
    m = torch.randn(rows, lane, generator=gen, device=dev) * 1e-3
    lr = torch.rand(rows // 8, 1, generator=gen, device=dev) * 1e-2

    wsq, gsq = lk.norms_flat(w, g, block_rows=1)
    pw, pg = lk.norms_flat_plain(w, g, block_rows=1)
    torch.cuda.synchronize()
    err = max((wsq - pw).abs().max().item(), (gsq - pg).abs().max().item())
    rel = max(((wsq - pw).abs() / pw).max().item(),
              ((gsq - pg).abs() / pg).max().item())
    if not rel <= NORMS_RTOL:
        raise AssertionError(f"norms_flat {rows}x{lane}: rel err {rel} "
                             f"> {NORMS_RTOL}")
    nbytes = 2 * n * 4 + 2 * rows * 4
    nops = 4 * n
    calls = GRAPH_CALLS[rows]
    vn = lambda x: torch.linalg.vector_norm(x, dim=1)  # noqa: E731
    out["norms_flat"] = _row(
        rows, lane, err, rel,
        timings(lambda: lk.norms_flat(w, g, block_rows=1), calls),
        device_ms(lambda: lk.norms_flat_plain(w, g, block_rows=1),
                  calls=calls),
        device_ms(lambda: (vn(w), vn(g)), calls=calls),
        nbytes, nops, bw, flops)
    if fold_layout is not None:
        # what a LARS step adds to the kernel: the fold of its row sums
        # into layer slices (one for sum w^2, one for sum g^2)
        out["norms_flat"]["fold_ms"] = device_ms(
            lambda: packing.fold_rows(fold_layout, wsq), calls=calls)
    del wsq, gsq, pw, pg

    w2, m2 = lk.apply_flat(w, g, m, lr, momentum=0.9, weight_decay=1e-4)
    pw2, pm2 = lk.apply_flat_plain(w, g, m, lr, momentum=0.9,
                                   weight_decay=1e-4)
    torch.cuda.synchronize()
    err = max((w2 - pw2).abs().max().item(), (m2 - pm2).abs().max().item())
    if not err <= APPLY_ATOL:
        raise AssertionError(f"apply_flat {rows}x{lane}: abs err {err} "
                             f"> {APPLY_ATOL}")
    del w2, m2, pw2, pm2
    nbytes = 3 * n * 4 + (rows // 8) * 4 + 2 * n * 4
    nops = 6 * n
    out["apply_flat"] = _row(
        rows, lane, err, 0.0,
        timings(lambda: lk.apply_flat(w, g, m, lr, momentum=0.9,
                                      weight_decay=1e-4), calls),
        device_ms(lambda: lk.apply_flat_plain(w, g, m, lr, momentum=0.9,
                                              weight_decay=1e-4),
                  calls=calls),
        None, nbytes, nops, bw, flops)
    out["apply_flat_q8"] = q8_row(lk, w, g, m, lr, bw, flops)
    del w, g, m, lr
    torch.cuda.empty_cache()
    return out


def log_kernel_rows(out: dict, floor: float) -> None:
    for name, rows in out.items():
        for r in rows:
            log(f"  {name:10s} {r['rows']:6d}x{r['lane']}  kernel "
                f"{r['ms']:.5f} ms (floor {floor:.5f}; dispatch "
                f"{r['dispatch_ms']:.4f})  "
                f"plain {r['plain_ms']:.5f} ms  library "
                f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
                f"max abs err {r['max_abs_err']:.3g}  rel {r['max_rel_err']:.3g}"
                + (f"  fold_rows {r['fold_ms']:.5f} ms" if "fold_ms" in r
                   else ""))


def q8_row(lk, w, g, m, lr, bw: float, flops: float) -> dict:
    """apply_flat_q8 against its plain version on (w, g, int8 m, lr)."""
    import torch
    from repro_torch.core.packing import quantize_blocks_q8
    rows, lane = w.shape
    n = rows * lane
    q, s = quantize_blocks_q8(m.view(rows // 8, -1))
    q = q.view(rows, lane)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    got = lk.apply_flat_q8(w, g, q, s, lr, **kw)
    want = lk.apply_flat_q8_plain(w, g, q, s, lr, **kw)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    if not err <= APPLY_Q8_ATOL:
        raise AssertionError(f"apply_flat_q8 {rows}x{lane}: abs err {err} "
                             f"> {APPLY_Q8_ATOL} (w', q', scale')")
    # w, g read as f32 and q as int8, w' and q' written: 14 B per value;
    # the block's scale and lr read and its new scale written: 12 B per
    # block. 12 operations per value (dequantize, the 6 of apply_flat,
    # |m'| and its max, the division, the rounding, the clip).
    nbytes = 14 * n + 12 * (rows // 8)
    nops = 12 * n
    calls = GRAPH_CALLS[rows]
    return _row(rows, lane, err, 0.0,
                timings(lambda: lk.apply_flat_q8(w, g, q, s, lr, **kw),
                        calls),
                device_ms(lambda: lk.apply_flat_q8_plain(w, g, q, s, lr,
                                                         **kw),
                          calls=calls),
                None, nbytes, nops, bw, flops)


def _row(rows, lane, err, rel, kernel_times, plain_ms, library_ms, nbytes,
         nops, bw, flops) -> dict:
    ms, dispatch = kernel_times
    t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return {"rows": rows, "lane": lane, "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "dispatch_ms": dispatch,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": nops}


def main_phase(train, lk, fdk) -> dict:
    """Phase 4: the port's entry point at batch 8192: LARS (the counted
    f32 run, first in the process, so it pays cuDNN's and cuBLAS's
    warm-up), SGD, LARS again for a warm timing, and the large-batch
    path (int8 momentum, 8 microbatches, bf16). Each run's launch counts
    are set to 0 just before it and read just after."""
    runs = {}
    for tag, extra in (("lars", ["--optimizer", "lars"]),
                       ("sgd", ["--optimizer", "sgd"]),
                       ("lars_warm", ["--optimizer", "lars"]),
                       ("lars_int8_bf16_accum8", LARGE_BATCH)):
        lk.reset_launch_counts()
        fdk.reset_launch_counts()
        summary = train.main(MAIN_ARGS + extra)
        counts = dict(lk.LAUNCHES)
        if fdk.LAUNCHES["flash_decode"]:
            raise AssertionError(f"{tag}: training launched flash_decode")
        losses = summary["losses"]
        if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{tag}: losses {losses}")
        lars_steps = MAIN_STEPS if "lars" in tag else 0
        int8 = tag.startswith("lars_int8")
        want = {"norms_flat": lars_steps,
                "apply_flat": 0 if int8 else lars_steps,
                "apply_flat_q8": lars_steps if int8 else 0}
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, want {want}")
        runs[tag] = dict(summary, launches=counts)
        log(f"  {tag}: {summary['steps_per_s']:.3f} steps/s  "
            f"{summary['examples_per_s']:.1f} examples/s  eval accuracy "
            f"{summary['eval_accuracy']:.4f}  launches {counts}  "
            f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    return runs


def card_vs_cpu_phase(train) -> dict:
    """Phase 5: the same 5 LARS steps on the CPU (plain) and the card,
    with f32 and with int8 momentum."""
    out = {}
    for slots, rtol in CARD_CPU_RTOL.items():
        args = ["--arch", "lenet-mnist", "--optimizer", "lars", "--batch",
                "32", "--steps", "5", "--lr", "0.05", "--log-every", "0",
                "--opt-state-dtype", slots]
        cpu = train.main(args + ["--device", "cpu"])["losses"]
        card = train.main(args + ["--device", "cuda"])["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        log(f"  {slots}: cpu  {cpu}\n  {slots}: card {card}\n  max rel "
            f"diff {rel:.3g} (tolerance {rtol})")
        if not rel <= rtol:
            raise AssertionError(f"{slots}: card vs CPU loss rel diff {rel}")
        out[slots] = rel
    return out


def _large_batch_pipeline(device):
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.models import build_model
    from repro_torch.train import TrainPipeline
    cfg = get_config("lenet-mnist")
    return TrainPipeline(build_model(cfg), lars(0.01, slot_dtype="int8"),
                         cfg, accum_steps=8, precision="bf16")


def _batches(device, batch: int, n: int) -> list:
    from repro_torch.data import batch_iterator, synthetic_mnist
    from repro_torch.data import place
    x, y, _, _ = synthetic_mnist(batch, 8)
    it = batch_iterator(x, y, batch=batch, seed=0)
    return [place(next(it), device) for _ in range(n)]


def checkpoint_phase(workdir: str) -> dict:
    """Phase 6: 10 steps, save, restore into a fresh state, 10 more,
    against 20 uninterrupted steps of the large-batch path; bit for bit
    under cuDNN's deterministic algorithms."""
    import torch
    from repro_torch.checkpoint import restore_train_state, save_train_state
    from repro_torch.treepath import tree_leaves
    dev = torch.device("cuda")
    pipe = _large_batch_pipeline(dev)
    batches = _batches(dev, 8192, 2 * CKPT_STEPS)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def run(state, bs):
            losses = []
            for b in bs:
                state, m = pipe(state, b)
                losses.append(m["loss"])
            return state, [float(x) for x in losses]

        def fresh(seed):
            return pipe.init_state(torch.Generator().manual_seed(seed), dev)

        whole, whole_losses = run(fresh(0), batches)
        half, first = run(fresh(0), batches[:CKPT_STEPS])
        path = os.path.join(workdir, "state.npz")
        save_train_state(path, half)
        resumed = restore_train_state(path, fresh(1))
        if resumed.opt_state.step != CKPT_STEPS:
            raise AssertionError(f"resumed at step {resumed.opt_state.step}")
        resumed, second = run(resumed, batches[CKPT_STEPS:])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = (first + second == whole_losses and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(resumed.params) + tree_leaves(
                resumed.opt_state.slots),
            tree_leaves(whole.params) + tree_leaves(whole.opt_state.slots))))
    slots = resumed.opt_state.slots
    slot_bytes = {k: v.numel() * v.element_size() for k, v in slots.items()}
    log(f"  20 uninterrupted vs 10 + save/restore + 10: "
        f"{'bit-identical' if same else 'DIFFERENT'}; losses "
        f"{whole_losses[0]:.4f} -> {whole_losses[-1]:.4f}; slot bytes "
        f"{slot_bytes} (an f32 momentum: {slots['master'].numel() * 4})")
    if not same:
        raise AssertionError("resumed run differs from the uninterrupted "
                             "one")
    return {"bit_identical": same, "losses": whole_losses,
            "slot_bytes": slot_bytes,
            "f32_momentum_bytes": slots["master"].numel() * 4}


def device_ms_by_kernel(prof) -> dict:
    """Device ms by kernel name over a ``torch.profiler`` window."""
    import torch
    kernels: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    return kernels


def profile_phase(path: str, batch: int = 8192, steps: int = 5) -> dict:
    """Phase 7: device busy share and time by kernel over main-path steps
    at batch 8192 (``path``: "f32" LARS or the "large_batch" path) fed by
    the loader, as ``launch.train`` feeds them, after two warm-up steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.models import build_model
    from repro_torch.train import TrainPipeline

    dev = torch.device("cuda")
    if path == "f32":
        cfg = get_config("lenet-mnist")
        pipe = TrainPipeline(build_model(cfg), lars(0.01), cfg)
    else:
        pipe = _large_batch_pipeline(dev)
    state = pipe.init_state(torch.Generator().manual_seed(0), dev)
    from repro_torch.data import ShardedLoader, batch_iterator, synthetic_mnist
    x, y, _, _ = synthetic_mnist(batch, 8)
    loader = ShardedLoader(batch_iterator(x, y, batch=batch, seed=0), dev)
    try:
        for _ in range(2):
            state, _ = pipe(state, next(loader))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = pipe(state, next(loader))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        loader.close()
    kernels = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    ours = {k: sum(ms for n, ms in kernels.items() if f"{k}_kernel" in n)
            / steps for k in KERNELS}
    h2d = sum(ms for n, ms in kernels.items() if "HtoD" in n) / steps
    log(f"  {path}, {steps} steps: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%; the loader's H2D "
        f"copies {h2d:.4f} ms/step on their side stream)" if busy else
        f"  {path}: device time not measured (the profiler recorded no "
        "CUDA events)")
    for name, ms in top:
        log(f"    {ms / steps:9.4f} ms/step  {name[:90]}")
    log(f"  hand kernels, device ms/step: {ours}")
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps if busy else None,
            "h2d_ms_per_step": h2d if busy else None,
            "hand_kernel_device_ms_per_step": ours,
            "top_kernels_ms_per_step": [[n[:90], ms / steps] for n, ms in top]}


def fd_inputs(B, S, Hkv, G, D, lengths, dtype, gen):
    """q, k, v and lengths on the card for flash_decode, drawn from
    ``gen``; ``lengths`` is "drawn" (1..S), "full" (S), "edges" (0, 1, S
    and S + 7 in the first rows, the rest drawn) or a list."""
    import torch
    dev = torch.device("cuda")
    q = torch.randn(B, Hkv, G, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
    if lengths in ("drawn", "edges"):
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        if lengths == "edges":
            lens[:4] = torch.tensor([0, 1, S, S + 7], device=dev)
    elif lengths == "full":
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, lens


def _fd_err(fdk, q, k, v, lens, dtype_name) -> tuple[float, float]:
    """(max abs err, max rel err) of the kernel against its plain
    version; raises beyond FD_TOL."""
    import torch
    scale = q.shape[-1] ** -0.5
    got = fdk.flash_decode(q, k, v, lens, scale=scale).float()
    want = fdk.flash_decode_plain(q, k, v, lens, scale=scale).float()
    torch.cuda.synchronize()
    rtol, atol = FD_TOL[dtype_name]
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"flash_decode {tuple(q.shape)} S "
                             f"{k.shape[1]} {dtype_name}: max abs err "
                             f"{err.max().item()} beyond rtol {rtol} atol "
                             f"{atol}")
    zero = (lens == 0).nonzero().flatten()
    if len(zero) and not bool((got[zero] == 0).all()):
        raise AssertionError("flash_decode: a zero-length row is not zero")
    return err.max().item(), (err / want.abs().clamp(min=1e-6)).max().item()


def flash_decode_phase(fdk, bw: float, flops: float) -> list[dict]:
    """Phase 3, flash_decode: f32 and bf16 at D 64 and 128 with zero-length
    rows, then the timed bf16 rows at FD_SHAPES."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for D, Hkv, G in ((64, 3, 3), (128, 8, 5)):
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v, lens = fd_inputs(8, 4096, Hkv, G, D, "drawn", dt, gen)
            lens[0], lens[1], lens[2] = 0, 1, 4096 + 7
            err, rel = _fd_err(fdk, q, k, v, lens, name)
            log(f"  flash_decode {name} D={D} G={G}: max abs err {err:.3g} "
                f"(rel {rel:.3g}); lengths 0, 1, S+7 included")
    return [fd_timed_row(fdk, shape, gen, bw, flops) for shape in FD_SHAPES]


def fd_timed_row(fdk, shape: tuple, gen, bw: float, flops: float) -> dict:
    """flash_decode in bf16 at ``shape`` (B, S, Hkv, G, D, lengths):
    held against its plain version, then timed beside the plain version,
    masked SDPA and its bound."""
    import torch
    import torch.nn.functional as F
    B, S, Hkv, G, D, lengths = shape
    q, k, v, lens = fd_inputs(B, S, Hkv, G, D, lengths, torch.bfloat16, gen)
    err, rel = _fd_err(fdk, q, k, v, lens, "bfloat16")
    scale = D ** -0.5
    valid = int(lens.clamp(max=S).sum())
    # K and V over the valid rows, q read and out written once, lengths
    nbytes = valid * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + B * 4
    # per valid key and query head: D multiply-adds for the score and
    # D for the value product, plus the exp
    nops = valid * Hkv * G * (4 * D + 1)
    calls = FD_CALLS[S]
    qs = q.reshape(B, Hkv * G, 1, D)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    plan = fdk.plan(q, k)
    row = _row(B, S, err, rel, timings(
        lambda: fdk.flash_decode(q, k, v, lens, scale=scale), calls),
        device_ms(lambda: fdk.flash_decode_plain(q, k, v, lens, scale=scale),
                  calls=max(1, calls // 5)),
        device_ms(sdpa, calls=calls), nbytes, nops, bw, flops)
    del row["rows"], row["lane"]
    row.update(shape={"B": B, "S": S, "Hkv": Hkv, "G": G, "D": D,
                      "dtype": "bfloat16", "lengths": lengths,
                      "valid_rows": valid},
               splits=plan.splits, keys_per_split=plan.keys_per_split,
               ctas=B * Hkv * plan.splits)
    log(f"  flash_decode B={B} S={S} Hkv={Hkv} G={G} D={D} bf16 "
        f"({lengths} lengths, {valid} valid rows; {plan.splits} splits "
        f"of {plan.keys_per_split} keys, {row['ctas']} CTAs): kernel "
        f"{row['ms']:.5f} ms (dispatch {row['dispatch_ms']:.4f})  plain "
        f"{row['plain_ms']:.5f} ms  SDPA {row['library_ms']:.5f} ms  "
        f"bound {row['bound_ms']:.5f} ms ({row['bound_by']})  max abs "
        f"err {err:.3g}")
    del q, k, v, lens, kt, vt, mask, qs
    torch.cuda.empty_cache()
    return row


def serve_phase(serve, fdk, lk, args=SERVE_ARGS) -> dict:
    """Phase 8 (and 14, for granite; 15, for deepseek, whose absorbed MLA
    decode launches no ``flash_decode``; 16, for falcon-mamba, which
    launches none, and zamba2, one per application of its shared block):
    the serve entry point at full width. Every launch count is set to 0
    just before it and read just after."""
    import torch
    lk.reset_launch_counts()
    fdk.reset_launch_counts()
    rep = serve.main(args)
    torch.cuda.synchronize()
    launches = dict(fdk.LAUNCHES)
    lars = dict(lk.LAUNCHES)
    ticks = rep["decode_steps"]
    want = rep["flash_decode_per_tick"] * ticks
    log(f"  {rep['requests']} requests, {rep['tokens']} tokens, "
        f"{rep['tok_per_s']:.1f} tok/s, {ticks} decode ticks "
        f"({1e3 * rep['wall_s'] / max(ticks, 1):.2f} ms of wall time per "
        f"tick, admissions included), {rep['admit_calls']} admissions; "
        f"TTFT p50/p99 {1e3 * rep['ttft_p50_s']:.1f}/"
        f"{1e3 * rep['ttft_p99_s']:.1f} ms, latency p50/p99 "
        f"{1e3 * rep['latency_p50_s']:.1f}/{1e3 * rep['latency_p99_s']:.1f}"
        f" ms; flash_decode launches "
        f"{launches['flash_decode']} (want {want}); LARS kernels {lars}; "
        f"logits finite {rep['logits_finite']}")
    if launches["flash_decode"] != want or ticks == 0:
        raise AssertionError(f"serve: {launches} flash_decode launches for "
                             f"{ticks} ticks of {rep['num_layers']} layers, "
                             f"want {want}")
    if any(lars.values()):
        raise AssertionError(f"serve launched LARS kernels: {lars}")
    if rep["requests"] != 64 or not rep["logits_finite"]:
        raise AssertionError(f"serve: {rep['requests']} of 64 requests "
                             f"finished, logits finite "
                             f"{rep['logits_finite']}")
    keys = ("requests", "tokens", "wall_s", "tok_per_s", "occupancy",
            "latency_mean_s", "latency_p50_s", "latency_p90_s",
            "latency_p99_s", "ttft_mean_s", "ttft_p50_s", "ttft_p90_s",
            "ttft_p99_s", "decode_steps", "admit_calls", "logits_finite")
    return dict({k: rep[k] for k in keys}, launches=launches,
                tick_wall_ms=1e3 * rep["wall_s"] / ticks)


def _reduced_lm(device, arch: str = "smollm-135m", changes=()):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), device)


def serve_card_vs_cpu_phase(fdk, arch: str = "smollm-135m",
                            changes=()) -> dict:
    """Phase 9 (and 13, for qwen3-14b; 14, for granite with ``changes``;
    15, for deepseek, whose decode launches no ``flash_decode``; 16, for
    falcon-mamba and zamba2): a reduced LM (f32) on the CPU (plain) and
    the card."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.treepath import tree_map
    cfg, model, params = _reduced_lm("cpu", arch, changes)
    card = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 24)))
    lens = torch.tensor([24, 5, 17, 1], dtype=torch.int32)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (16, 4, 1)))
    logits = {}
    for dev, p in (("cpu", params), ("cuda", card)):
        fdk.reset_launch_counts()
        _, cache = model.prefill(p, toks.to(dev), cache_len=48,
                                 lengths=lens.to(dev))
        if fdk.LAUNCHES["flash_decode"]:
            raise AssertionError("prefill launched flash_decode")
        logits[dev] = torch.stack([model.decode_step(p, cache, t.to(dev))[0]
                                   .cpu() for t in feed])
        want = model.flash_decode_per_step() * len(feed) \
            if dev == "cuda" else 0
        if fdk.LAUNCHES["flash_decode"] != want:
            raise AssertionError(f"{dev}: {fdk.LAUNCHES} launches, want "
                                 f"{want}")
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 9, 30, 14,
                                                              6)]
    greedy = {dev: [t.tolist() for t in ServeEngine(
        model, p, cfg, slots=2, capacity=64).generate(prompts, 12)]
        for dev, p in (("cpu", params), ("cuda", card))}
    same = greedy["cpu"] == greedy["cuda"]
    log(f"  16 teacher-forced decode steps: max abs logits diff {diff:.3g} "
        f"(tolerance {SERVE_CARD_CPU_ATOL}); greedy tokens of 5 requests "
        f"{'identical' if same else 'DIFFERENT'}")
    if not diff <= SERVE_CARD_CPU_ATOL or not same:
        raise AssertionError(f"serve card vs CPU: diff {diff}, greedy "
                             f"{greedy}")
    return {"max_abs_logits_diff": diff, "greedy_identical": same}


def serve_profile_phase(fdk, ticks: int = 5) -> dict:
    """Phase 10: full-width smollm, 32 busy slots: admission launches no
    flash_decode; then the profiler over ``ticks`` decode ticks."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    engine = ServeEngine(model, params, cfg, slots=32, capacity=4096,
                         prefill_bucket=16)
    rng = np.random.default_rng(1)
    for _ in range(32):
        engine.submit(rng.integers(0, cfg.vocab_size,
                                   (int(rng.integers(256, 2049)),)), 1000)
    fdk.reset_launch_counts()
    engine._admit_pending()
    torch.cuda.synchronize()
    if fdk.LAUNCHES["flash_decode"] or len(engine.scheduler.active) != 32:
        raise AssertionError(f"admission: {fdk.LAUNCHES}, "
                             f"{len(engine.scheduler.active)} active")
    for _ in range(3):                              # warm-up ticks
        engine.step()
    torch.cuda.synchronize()
    fdk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = fdk.LAUNCHES["flash_decode"]
    if launches != cfg.num_layers * ticks:
        raise AssertionError(f"profile: {launches} launches in {ticks} "
                             "ticks")
    kernels = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    fd_ms = sum(ms for n, ms in kernels.items() if "flash_decode" in n)
    log(f"  {ticks} decode ticks, 32 slots: wall {wall_ms / ticks:.3f} "
        f"ms/tick, device busy {busy / ticks:.3f} ms/tick "
        f"({100 * busy / wall_ms:.1f}%); flash_decode {fd_ms / ticks:.4f} "
        f"ms/tick in {launches // ticks} launches" if busy else
        "  device time not measured (the profiler recorded no CUDA events)")
    for name, ms in top:
        log(f"    {ms / ticks:9.4f} ms/tick  {name[:90]}")
    del engine, params
    torch.cuda.empty_cache()
    return {"wall_ms_per_tick": wall_ms / ticks,
            "device_busy_ms_per_tick": busy / ticks if busy else None,
            "flash_decode_ms_per_tick": fd_ms / ticks if busy else None,
            "flash_decode_launches_per_tick": launches / ticks,
            "top_kernels_ms_per_tick": [[n[:90], ms / ticks]
                                        for n, ms in top]}


def _want_launches(cell) -> dict:
    """Kernel launches a cell must make: one norms_flat and one apply per
    LARS step (apply_flat_q8 with int8 momentum), none for SGD."""
    lars_steps = cell.steps if cell.optimizer == "lars" else 0
    int8 = cell.opt_state_dtype == "int8"
    return {"norms_flat": lars_steps,
            "apply_flat": 0 if int8 else lars_steps,
            "apply_flat_q8": lars_steps if int8 else 0}


def _grid_outputs(out_dir: str, grid) -> tuple[dict, dict]:
    """(trajectories without timing keys, manifest rows without wall_s)."""
    from repro_torch.experiments import read_trajectory
    from repro_torch.experiments.record import load_json
    traj = {c.cell_id: read_trajectory(
        os.path.join(out_dir, c.cell_id, "trajectory.jsonl"),
        strip_timing=True) for c in grid.cells()}
    rows = {cid: {k: v for k, v in row.items() if k != "wall_s"}
            for cid, row in load_json(os.path.join(
                out_dir, "manifest.json"))["cells"].items()}
    return traj, rows


ROW_METRICS = ("test_acc", "train_acc", "eval_loss", "eval_ppl", "eval_acc")


def run_grid_checked(name: str, root: str, lk, need_claims: set) -> dict:
    """Run a registered grid on the card into ``root/name``: every cell
    finishes with finite losses and a positive peak, and launches exactly
    ``_want_launches``; the report carries ``need_claims``. Launch counts
    are set to 0 just before the grid and read, then set to 0 again, as
    each of its cells finishes."""
    from repro_torch.experiments import (GridRunner, aggregate,
                                         format_table, get_grid,
                                         read_trajectory)
    grid = get_grid(name)
    launches = {}

    def on_row(row):
        launches[row["cell_id"]] = dict(lk.LAUNCHES)
        lk.reset_launch_counts()

    lk.reset_launch_counts()
    t0 = time.perf_counter()
    manifest = GridRunner(grid, os.path.join(root, name), device="cuda",
                          log=log).run(on_row=on_row)
    wall = time.perf_counter() - t0
    if set(manifest["cells"]) != {c.cell_id for c in grid.cells()}:
        raise AssertionError(f"{name}: cells {sorted(manifest['cells'])}")
    cells = {}
    for c in grid.cells():
        row = manifest["cells"][c.cell_id]
        recs = read_trajectory(os.path.join(root, name, c.cell_id,
                                            "trajectory.jsonl"))
        losses = [r["loss"] for r in recs]
        if len(losses) != c.steps or row.get("diverged") or not all(
                x is not None and math.isfinite(x) for x in losses):
            raise AssertionError(f"{c.cell_id}: {len(losses)} of "
                                 f"{c.steps} steps, losses {losses}")
        if not isinstance(row["peak_bytes"], int) or row["peak_bytes"] <= 0:
            raise AssertionError(f"{c.cell_id}: peak bytes "
                                 f"{row['peak_bytes']}")
        if launches[c.cell_id] != _want_launches(c):
            raise AssertionError(
                f"{c.cell_id}: launches {launches[c.cell_id]}, want "
                f"{_want_launches(c)}")
        train_s = recs[-1]["wall_s"]    # the cell's training loop
        cells[c.cell_id] = dict(
            {k: row[k] for k in ROW_METRICS if k in row},
            steps=c.steps, train_s=train_s, steps_per_s=c.steps / train_s,
            cell_wall_s=row["wall_s"], loss=row["loss"],
            peak_bytes=row["peak_bytes"], launches=launches[c.cell_id])
        log(f"  {c.cell_id}: {c.steps} steps in {train_s:.3f} s "
            f"({c.steps / train_s:.1f} steps/s), "
            + ", ".join(f"{k} {row[k]}" for k in ROW_METRICS if k in row)
            + f", loss {row['loss']:.4f}, peak {row['peak_bytes']} B, "
            f"launches {launches[c.cell_id]}")
    payload = aggregate(grid, manifest)
    claims = payload["claims"]
    if not need_claims <= set(claims):
        raise AssertionError(f"{name}: claims {sorted(claims)}")
    log(f"  {name}: {len(cells)} cells in {wall:.2f} s\n" +
        format_table(payload))
    for key, val in claims.items():
        log(f"  claim {key}: {val}")
    return {"wall_s": wall, "cells": cells, "claims": claims}


def kill_and_resume(name: str, root: str, kill_after: int) -> bool:
    """Run grid ``name`` into ``root/killed_<name>``, killed after
    ``kill_after`` steps (mid-cell, past a checkpoint), resume it, and
    hold its trajectories and rows (without ``wall_s``) equal to the
    uninterrupted run's in ``root/name``."""
    from repro_torch.experiments import GridRunner, get_grid
    from repro_torch.experiments.runner import ABORT_ENV
    grid = get_grid(name)
    kdir = os.path.join(root, f"killed_{name}")
    os.environ[ABORT_ENV] = str(kill_after)
    killed = False
    try:
        GridRunner(grid, kdir, device="cuda", log=log).run()
    except KeyboardInterrupt:
        killed = True
    finally:
        os.environ.pop(ABORT_ENV, None)
    ckpt = os.path.join(kdir, grid.cells()[1].cell_id, "state.npz")
    if not killed or not os.path.exists(ckpt):
        raise AssertionError(f"the kill after {kill_after} steps did not "
                             f"land mid-cell ({ckpt})")
    GridRunner(grid, kdir, device="cuda", log=log).run(resume=True)
    got = _grid_outputs(kdir, grid)
    want = _grid_outputs(os.path.join(root, name), grid)
    differ = [f"{c.cell_id} trajectory" for c in grid.cells()
              if got[0][c.cell_id] != want[0][c.cell_id]] + [
        f"{cid} {key}: {row.get(key)} != {want[1][cid].get(key)}"
        for cid, row in got[1].items()
        for key in set(row) | set(want[1][cid])
        if row.get(key) != want[1][cid].get(key)]
    log(f"  {name} killed after {kill_after} steps and resumed: "
        f"trajectories and rows {'DIFFERENT' if differ else 'equal'} to "
        "the uninterrupted run's" + "".join(f"\n    {d}" for d in differ))
    if differ:
        raise AssertionError(f"resumed {name} differs from the "
                             "uninterrupted run")
    return True


def experiment_phase(workdir: str, lk) -> dict:
    """Phase 11: the experiment harness on the card."""
    import torch
    from repro_torch.experiments import GridRunner, get_grid
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "experiments")
    shutil.rmtree(root, ignore_errors=True)
    deterministic = torch.backends.cudnn.deterministic
    out: dict = {}
    try:
        need = {"C1_comparable_at_small_batch",
                "C3_lars_ge_sgd_at_largest_batch",
                "C4_sgd_gen_error_grows_faster"}
        for name in EXP_GRIDS:
            out[name] = run_grid_checked(
                name, root, lk, need | ({"P1_int8_matches_f32"}
                                        if name == "int8_parity_smoke"
                                        else set()))
        out["kill_resume_equal"] = kill_and_resume(EXP_GRIDS[0], root,
                                                   EXP_KILL_AFTER)
        grid = get_grid(EXP_GRIDS[0])

        # steps/s of the b64 LARS cell: stats on/off x deterministic on/off,
        # in the order ABCD DCBA
        cell = next(c for c in grid.cells()
                    if c.optimizer == "lars" and c.batch == 64)
        configs = [(st, det) for st in (True, False) for det in (True, False)]
        rates: dict = {}
        for stats, det in configs + configs[::-1]:
            runner = GridRunner(grid, os.path.join(root, "timing"),
                                device="cuda", collect_stats=stats, log=None)
            torch.backends.cudnn.deterministic = det
            state, _ = runner.open_cell(cell)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run_cell_segment(cell, state, start=0,
                                    until_step=cell.steps)
            torch.cuda.synchronize()
            key = (f"stats_{'on' if stats else 'off'}_"
                   f"deterministic_{'on' if det else 'off'}")
            rates.setdefault(key, []).append(
                cell.steps / (time.perf_counter() - t0))
        for key, r in rates.items():
            log(f"  {cell.cell_id} {key}: "
                + " / ".join(f"{x:.2f}" for x in r) + " steps/s")
        out["timing"] = {"cell": cell.cell_id, "steps": cell.steps,
                         "steps_per_s": rates}
        out["profile"] = experiment_profile(grid, cell, root)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 11 wall time {out['phase_wall_s']:.1f} s")
    return out


def experiment_profile(grid, cell, root: str, steps: int = EXP_PROFILE_STEPS
                       ) -> dict:
    """Phase 11: a ``torch.profiler`` window over ``steps`` steps of the
    runner's b64 LARS cell as a grid runs it (stats on, deterministic
    cuDNN, a checkpoint every 25 steps), after 25 warm-up steps: the
    device's busy share and time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiments import GridRunner
    runner = GridRunner(grid, os.path.join(root, "profile"), device="cuda",
                        log=None)
    state, _ = runner.open_cell(cell)
    state, _, _ = runner.run_cell_segment(cell, state, start=0,
                                          until_step=25)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_cell_segment(cell, state, start=25, until_step=25 + steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile, {steps} steps of {cell.cell_id}: wall "
        f"{wall_ms / steps:.3f} ms/step, device busy {busy / steps:.3f} "
        f"ms/step ({100 * busy / wall_ms:.1f}%)" if busy else
        "  profile: device time not measured (the profiler recorded no "
        "CUDA events)")
    for name, ms in top:
        log(f"    {ms / steps:9.4f} ms/step  {name[:90]}")
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps if busy else None,
            "top_kernels_ms_per_step": [[n[:90], ms / steps]
                                        for n, ms in top]}


def lm_layout(cfg):
    """An LM's packed layout at ``cfg``'s size (shapes only: a meta
    init)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.models import build_model
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "meta")
    return packing.build_layout(params, model.stacked_marker(params))


def lm_kernel_rows(lk, bw: float, flops: float, floor: float) -> dict:
    """Phase 12: the three LARS kernels at smollm-135m's packed shape
    against their plain versions, timed as phase 3 times its rows."""
    import torch
    from repro_torch.configs import get_config
    layout = lm_layout(get_config("smollm-135m"))
    if (layout.buffer_shape, layout.num_slices) != ((LM_ROWS, 512),
                                                    LM_SLICES):
        raise AssertionError(f"smollm-135m's layout is "
                             f"{layout.buffer_shape}, {layout.num_slices} "
                             "slices")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = kernel_rows(lk, LM_ROWS, 512, gen, bw, flops, layout)
    log_kernel_rows({k: [v] for k, v in rows.items()}, floor)
    return rows


def lm_train_runs(train, lk, fdk, base_args=LM_ARGS, runs=LM_RUNS,
                  steps=LM_STEPS, aux: bool = False,
                  tree: bool = False) -> dict:
    """``launch.train.main`` at full width, one run per entry of ``runs``
    (phase 12: LARS, LAMB and the large-batch LARS path; phase 13: the
    lean knobs and qwen3-14b; phases 14, 15: an MoE, whose aux losses
    ``aux`` gates finite and nonzero; phase 18: ``tree`` states, which
    launch no LARS kernel). Each run's launch counts and the allocator's
    peak are reset just before it and read just after."""
    import gc
    import torch
    out = {}
    for tag, extra in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        lk.reset_launch_counts()
        fdk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        args = base_args + extra
        summary = train.main(args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = dict(lk.LAUNCHES)
        losses = summary["losses"]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{tag}: losses {losses}")
        if fdk.LAUNCHES["flash_decode"]:
            raise AssertionError(f"{tag}: training launched flash_decode")
        lars_steps = steps if args[args.index("--optimizer") + 1] == "lars" \
            and not tree else 0
        int8 = "int8" in args
        want = {"norms_flat": lars_steps,
                "apply_flat": 0 if int8 else lars_steps,
                "apply_flat_q8": lars_steps if int8 else 0}
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, want {want}")
        if aux and not all(math.isfinite(a) and a > 0
                           for a in summary["aux_losses"]):
            raise AssertionError(f"{tag}: aux losses "
                                 f"{summary['aux_losses']}")
        out[tag] = {k: summary[k] for k in (
            "arch", "params", "batch", "seq", "steps", "accum_steps",
            "precision", "opt_state_dtype", "losses", "aux_losses",
            "train_s",
            "steps_per_s", "tokens_per_s")}
        out[tag].update(launches=counts, peak_bytes=peak - before,
                        set=[v for k, v in zip(args, args[1:])
                             if k == "--set"])
        log(f"  {tag}: {summary['steps_per_s']:.3f} steps/s  "
            f"{summary['tokens_per_s']:.0f} tokens/s  peak "
            f"{(peak - before) / 2**30:.2f} GiB  launches {counts}  losses "
            + " ".join(f"{x:.4f}" for x in losses)
            + (f"  aux losses {summary['aux_losses']}" if aux else ""))
    return out


def lm_profile(path: str, steps: int = 1, *, cfg=None, batch: int = 0,
               seq: int = 1024, accum: int = 4, params=None,
               packed: bool = True, annotate_update: bool = False) -> dict:
    """Phases 12, 13: a ``torch.profiler`` window over one full-width step
    (``path``: "f32" LARS or the "large_batch" path: int8 momentum, bf16,
    ``accum`` microbatches) of ``cfg`` (smollm-135m by default; batch 16,
    or 64 on the large-batch path) fed by the loader, after two warm-up
    steps, from ``params`` when given (else a seed-0 init), on a packed
    state (or a tree state, ``packed=False``): busy share, time by kernel,
    the hand kernels' and the loader's H2D copies' device time; with
    ``annotate_update`` also the optimizer update's own kernels (phase
    18)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import build_model
    from repro_torch.train import TrainPipeline, train_state_from_params
    cfg = cfg or get_config("smollm-135m")
    if path == "f32":
        pipe = TrainPipeline(build_model(cfg), lars(0.01), cfg,
                             packed=packed)
        batch = batch or 16
    else:
        pipe = TrainPipeline(build_model(cfg), lars(0.01, slot_dtype="int8"),
                             cfg, accum_steps=accum, precision="bf16",
                             packed=packed)
        batch = batch or 16 * accum
    if annotate_update:
        inner = pipe.optimizer.update

        def update(*args, **kw):
            with torch.profiler.record_function(UPDATE_RANGE):
                return inner(*args, **kw)

        pipe.optimizer = dataclasses.replace(pipe.optimizer, update=update)
    state = (pipe.init_state(torch.Generator().manual_seed(0), "cuda")
             if params is None else
             train_state_from_params(pipe.model, pipe.optimizer, params,
                                     precision=pipe.precision,
                                     packed=packed))
    loader = ShardedLoader(lm_batches(cfg, batch, seq), "cuda")
    try:
        for _ in range(2):
            state, _ = pipe(state, next(loader))
        out, state = profile_steps(
            pipe, state, loader, steps,
            f"{cfg.name} {path}{'' if packed else ' (tree state)'}, "
            f"{steps} step(s) of {batch} x {seq}",
            annotated=UPDATE_RANGE if annotate_update else None)
    finally:
        loader.close()
    del state, pipe
    return dict({"arch": cfg.name, "batch": batch, "seq": seq}, **out)


def profile_steps(pipe, state, batches, steps: int, label: str,
                  annotated: str = None) -> tuple[dict, object]:
    """A ``torch.profiler`` window over ``steps`` steps of ``pipe`` from
    ``state`` on ``batches`` (an iterator): busy share, time by kernel,
    the hand kernels' and the loader's H2D copies' device time; with
    ``annotated``, the name of a ``record_function`` range in the step,
    the kernels launched inside it (count and device ms a step) and its
    host ms. Returns (the numbers, the state after the steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = pipe(state, next(batches))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    kernels.pop(annotated, None)           # the range's own device span
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    ours = {k: sum(ms for n, ms in kernels.items() if f"{k}_kernel" in n)
            / steps for k in KERNELS}
    h2d = sum(ms for n, ms in kernels.items() if "HtoD" in n) / steps
    extra = {}
    if annotated:
        ranges = [ev for ev in prof.events() if ev.name == annotated
                  and ev.device_type == torch.autograd.DeviceType.CPU]
        launched = [k for ev in ranges for k in _kernels_under(ev)]
        extra = {"update_kernels": len(launched) / steps,
                 "update_device_ms": sum(k.duration for k in launched)
                 / 1e3 / steps,
                 "update_host_ms": sum(ev.time_range.elapsed_us()
                                       for ev in ranges) / 1e3 / steps}
    log(f"  {label}: wall {wall_ms / steps:.2f}"
        f" ms/step, device busy {busy / steps:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), H2D copies {h2d:.4f} ms"
        if busy else f"  {label}: device time not measured (the profiler "
        "recorded no CUDA events)")
    for name, ms in top:
        log(f"    {ms / steps:9.4f} ms/step  {name[:90]}")
    log(f"  hand kernels, device ms/step: {ours}")
    if extra:
        log(f"  its optimizer update: {extra['update_kernels']:.0f} device "
            f"kernels, {extra['update_device_ms']:.3f} ms of device time, "
            f"host {extra['update_host_ms']:.2f} ms (under the profiler)")
    return dict({"steps": steps, "wall_ms_per_step": wall_ms / steps,
                 "device_busy_ms_per_step": busy / steps if busy else None,
                 "h2d_ms_per_step": h2d if busy else None,
                 "hand_kernel_device_ms_per_step": ours,
                 "top_kernels_ms_per_step": [[n[:90], ms / steps]
                                             for n, ms in top]},
                **extra), state


def _kernels_under(ev) -> list:
    """The device kernels launched by a profiler CPU event and every op
    under it."""
    return list(ev.kernels) + [k for child in ev.cpu_children
                               for k in _kernels_under(child)]


def train_card_vs_cpu(train, args, label: str,
                      rtol: float = LM_CARD_CPU_RTOL["lars"],
                      aux: bool = False) -> dict:
    """Phases 12-15: ``launch.train.main`` with ``args`` (a reduced LM in
    f32) on the CPU (plain versions) and on the card (kernels): the loss
    trajectories must agree within ``rtol``, and with ``aux`` (an MoE) the
    aux losses of both runs must be finite and nonzero."""
    runs = {dev: train.main(args + ["--device", dev])
            for dev in ("cpu", "cuda")}
    cpu, card = runs["cpu"]["losses"], runs["cuda"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    log(f"  {label}: cpu  {[round(x, 6) for x in cpu]}\n  {label}: card "
        f"{[round(x, 6) for x in card]}\n  rel diff by step "
        f"{[float(f'{x:.3g}') for x in rel]}; max {max(rel):.3g} "
        f"(tolerance {rtol})")
    if not max(rel) <= rtol:
        raise AssertionError(f"{label}: card vs CPU loss rel diff "
                             f"{max(rel)}")
    out = {"max_rel": max(rel), "rel_by_step": rel}
    if aux:
        out["aux_losses"] = runs["cpu"]["aux_losses"] + runs["cuda"][
            "aux_losses"]
        log(f"  {label}: aux losses {min(out['aux_losses']):.4g}.."
            f"{max(out['aux_losses']):.4g}")
        if not all(math.isfinite(a) and a > 0 for a in out["aux_losses"]):
            raise AssertionError(f"{label}: aux losses {out['aux_losses']}")
    return out


def lm_card_vs_cpu(train) -> dict:
    """Phase 12: reduced smollm in f32, 20 steps of LARS and of LAMB, card
    against CPU within LM_CARD_CPU_RTOL."""
    return {opt: train_card_vs_cpu(train, LM_CARD_CPU_ARGS
                                   + ["--optimizer", opt], opt, rtol)
            for opt, rtol in LM_CARD_CPU_RTOL.items()}


def loader_phase() -> dict:
    """Phase 12: the f32 LeNet path (LARS, batch 8192) and the reduced LM
    (LAMB) for LOADER_STEPS steps fed by ShardedLoader with prefetch 2
    and without: losses and final states bit-identical (cuDNN's
    deterministic algorithms on)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lamb, lars
    from repro_torch.data import ShardedLoader, batch_iterator, synthetic_mnist
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import build_model
    from repro_torch.train import TrainPipeline
    from repro_torch.treepath import tree_leaves
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for family in ("cnn", "lm"):
            if family == "cnn":
                cfg = get_config("lenet-mnist")
                x, y, _, _ = synthetic_mnist(8192, 8)
                host = lambda: batch_iterator(x, y, batch=8192,  # noqa: E731
                                              seed=0)
                opt = lars(0.01)
            else:
                cfg = get_config("smollm-135m").reduced()
                host = lambda: lm_batches(cfg, 8, 64)  # noqa: E731
                opt = lamb(0.01)
            pipe = TrainPipeline(build_model(cfg), opt, cfg)
            runs = {}
            for prefetch in (2, 0):
                state = pipe.init_state(torch.Generator().manual_seed(0),
                                        "cuda")
                loader = ShardedLoader(host(), "cuda", prefetch=prefetch)
                losses = []
                try:
                    for _ in range(LOADER_STEPS):
                        state, m = pipe(state, next(loader))
                        losses.append(m["loss"])
                finally:
                    loader.close()
                runs[prefetch] = ([float(v) for v in losses], tree_leaves(
                    state.params) + tree_leaves(state.opt_state.slots))
            same = runs[2][0] == runs[0][0] and all(
                torch.equal(a, b) for a, b in zip(runs[2][1], runs[0][1]))
            log(f"  {cfg.name} {opt.name}, {LOADER_STEPS} steps: prefetch 2 "
                f"{'bit-identical to' if same else 'DIFFERENT from'} "
                f"prefetch 0; losses {[round(v, 6) for v in runs[2][0]]}")
            if not same:
                raise AssertionError(f"{family}: prefetched trajectory "
                                     f"{runs[2][0]} != {runs[0][0]}")
            out[family] = {"bit_identical": same, "losses": runs[2][0]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def lm_phase(train, lk, fdk, bw: float, flops: float, floor: float,
             workdir: str) -> dict:
    """Phase 12: the LM training path on the card."""
    t_phase = time.perf_counter()
    out = {"kernel_rows": lm_kernel_rows(lk, bw, flops, floor)}
    out["runs"] = lm_train_runs(train, lk, fdk)
    out["profile"] = {path: lm_profile(path)
                      for path in ("f32", "large_batch")}
    out["card_vs_cpu"] = lm_card_vs_cpu(train)
    out["loader"] = loader_phase()
    root = os.path.join(workdir, "lm_experiments")
    shutil.rmtree(root, ignore_errors=True)
    out[LM_GRID] = run_grid_checked(
        LM_GRID, root, lk, {"L1_comparable_at_small_batch",
                            "L2_lamb_le_adamw_at_largest_batch",
                            "L3_lars_le_sgd_at_largest_batch",
                            "L4_best_layerwise_beats_best_generic_at_largest"})
    out["kill_resume_equal"] = kill_and_resume(LM_GRID, root, LM_KILL_AFTER)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 wall time {out['phase_wall_s']:.1f} s")
    return out


def qwen_kernel_rows(lk, bw: float, flops: float, floor: float) -> dict:
    """Phase 13: the three LARS kernels at qwen3's (4329072, 512), where
    element indices pass 2^31, as :func:`large_kernel_rows` runs them."""
    import dataclasses
    from repro_torch.configs import get_config
    layout = lm_layout(dataclasses.replace(get_config("qwen3-14b"),
                                           num_layers=2))
    if (layout.buffer_shape, layout.num_slices) != ((QWEN_ROWS, 512),
                                                    QWEN_SLICES):
        raise AssertionError(f"qwen3-14b's layout is {layout.buffer_shape}, "
                             f"{layout.num_slices} slices")
    return large_kernel_rows(lk, layout, 2, bw, flops, floor)


def large_kernel_rows(lk, layout, seed: int, bw: float, flops: float,
                      floor: float) -> dict:
    """The three LARS kernels at a large ``layout``'s rows, on fresh
    buffers drawn from ``seed`` before any model is built. Each is held
    against its plain version on EVERY row — the plain versions run on
    chunks of PLAIN_CHUNK rows, whose temporaries fit beside the
    buffers — and the rows past element 2^31, if any, are reported
    apart. The kernel and the library call are timed from a CUDA graph
    of one call, the chunked plain version by CUDA events."""
    import gc
    import torch
    from repro_torch.core import packing
    R = layout.buffer_shape[0]
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    n = R * 512
    w = torch.randn(R, 512, generator=gen, device=dev)
    g = torch.randn(R, 512, generator=gen, device=dev) * 1e-2
    m = torch.randn(R, 512, generator=gen, device=dev) * 1e-3
    lr = torch.rand(R // 8, 1, generator=gen, device=dev) * 1e-2
    chunks = [(a, min(a + PLAIN_CHUNK, R)) for a in range(0, R, PLAIN_CHUNK)]
    kw = dict(momentum=0.9, weight_decay=1e-4)

    def plain_ms(fn) -> float:
        """One pass of a plain version over every chunk, by CUDA events
        (its temporaries are freed chunk by chunk, which a graph's
        private pool would not do)."""
        return dispatch_ms(lambda: [fn(a, b) for a, b in chunks],
                           warmup=1, reps=5)

    def timed(fn) -> tuple[float, float]:
        ms = device_ms(fn, calls=1, warmup=1, reps=10)
        torch.cuda.empty_cache()
        dispatch = dispatch_ms(fn, warmup=1, reps=5)
        torch.cuda.empty_cache()
        return ms, dispatch

    def errs(pairs) -> tuple[float, float]:
        """(max over all rows, max over the rows past element 2^31)."""
        every = past = 0.0
        for a, b, d in pairs:
            every = max(every, d.max().item())
            if b > PAST_2_31:
                past = max(past, d[max(PAST_2_31 - a, 0):].max().item())
        return every, past

    out = {}
    wsq, gsq = lk.norms_flat(w, g, block_rows=1)
    rel, err = [], 0.0
    for a, b in chunks:
        pw, pg = lk.norms_flat_plain(w[a:b], g[a:b], block_rows=1)
        rel.append((a, b, torch.maximum((wsq[a:b] - pw).abs() / pw,
                                        (gsq[a:b] - pg).abs() / pg)))
        err = max(err, (wsq[a:b] - pw).abs().max().item(),
                  (gsq[a:b] - pg).abs().max().item())
    rel_all, rel_past = errs(rel)
    if not rel_all <= NORMS_RTOL:
        raise AssertionError(f"norms_flat at {R} rows: rel err {rel_all}")
    fold = device_ms(lambda: packing.fold_rows(layout, wsq), calls=1)
    del wsq, gsq, rel
    vn = lambda x: torch.linalg.vector_norm(x, dim=1)  # noqa: E731
    out["norms_flat"] = _row(
        R, 512, err, rel_all, timed(lambda: lk.norms_flat(w, g, block_rows=1)),
        plain_ms(lambda a, b: lk.norms_flat_plain(w[a:b], g[a:b],
                                                  block_rows=1)),
        device_ms(lambda: (vn(w), vn(g)), calls=1),
        2 * n * 4 + 2 * R * 4, 4 * n, bw, flops)
    out["norms_flat"].update(fold_ms=fold, max_rel_err_past_2_31=rel_past)

    w2, m2 = lk.apply_flat(w, g, m, lr, **kw)
    diff = []
    for a, b in chunks:
        pw2, pm2 = lk.apply_flat_plain(w[a:b], g[a:b], m[a:b],
                                       lr[a // 8:b // 8], **kw)
        diff.append((a, b, torch.maximum((w2[a:b] - pw2).abs(),
                                         (m2[a:b] - pm2).abs()).amax(1)))
    err, err_past = errs(diff)
    if not err <= APPLY_ATOL:
        raise AssertionError(f"apply_flat at {R} rows: abs err {err}")
    del w2, m2, diff, pw2, pm2
    out["apply_flat"] = _row(
        R, 512, err, 0.0, timed(lambda: lk.apply_flat(w, g, m, lr, **kw)),
        plain_ms(lambda a, b: lk.apply_flat_plain(
            w[a:b], g[a:b], m[a:b], lr[a // 8:b // 8], **kw)),
        None, 3 * n * 4 + (R // 8) * 4 + 2 * n * 4, 6 * n, bw, flops)
    out["apply_flat"]["max_abs_err_past_2_31"] = err_past

    q = torch.empty(R, 512, dtype=torch.int8, device=dev)
    s = torch.empty(R // 8, 1, device=dev)
    for a, b in chunks:
        qa, sa = packing.quantize_blocks_q8(m[a:b].view(-1, 8 * 512))
        q[a:b], s[a // 8:b // 8] = qa.view(-1, 512), sa
    del m, qa, sa
    torch.cuda.empty_cache()
    got = lk.apply_flat_q8(w, g, q, s, lr, **kw)
    diff = []
    for a, b in chunks:
        want = lk.apply_flat_q8_plain(w[a:b], g[a:b], q[a:b],
                                      s[a // 8:b // 8], lr[a // 8:b // 8],
                                      **kw)
        d = torch.maximum((got[0][a:b] - want[0]).abs(),
                          (got[1][a:b].float() - want[1].float()).abs())
        d = torch.maximum(d.amax(1).view(-1, 8).amax(1),
                          (got[2][a // 8:b // 8] - want[2]).abs()[:, 0])
        diff.append((a, b, d.repeat_interleave(8)))
    err, err_past = errs(diff)
    if not err <= APPLY_Q8_ATOL:
        raise AssertionError(f"apply_flat_q8 at {R} rows: abs err {err} "
                             "(w', q', scale')")
    del got, want, diff, d
    out["apply_flat_q8"] = _row(
        R, 512, err, 0.0,
        timed(lambda: lk.apply_flat_q8(w, g, q, s, lr, **kw)),
        plain_ms(lambda a, b: lk.apply_flat_q8_plain(
            w[a:b], g[a:b], q[a:b], s[a // 8:b // 8], lr[a // 8:b // 8],
            **kw)),
        None, 14 * n + 12 * (R // 8), 12 * n, bw, flops)
    out["apply_flat_q8"]["max_abs_err_past_2_31"] = err_past
    del w, g, q, s, lr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {R} rows, {layout.num_slices} slices ({n:,} elements"
        + (f"; rows from {PAST_2_31} lie past element 2^31):" if R >
           PAST_2_31 else "):"))
    log_kernel_rows({k: [v] for k, v in out.items()}, floor)
    if R > PAST_2_31:
        log(f"  past element 2^31: norms rel err "
            f"{out['norms_flat']['max_rel_err_past_2_31']:.3g}, apply abs "
            f"err {out['apply_flat']['max_abs_err_past_2_31']}, q8 abs err "
            f"{out['apply_flat_q8']['max_abs_err_past_2_31']}")
    return out


def lm_run(cfg, params, batch: int, seq: int, steps: int) -> dict:
    """``steps`` f32 LARS steps of ``cfg`` from ``params`` (shared, not
    written) on the Markov token source: losses, each step's host ms
    (ending in a sync) and the allocator's peak over the run, less what
    was allocated before it."""
    import gc
    import torch
    from repro_torch.core import lars
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import build_model
    from repro_torch.train import TrainPipeline, train_state_from_params
    pipe = TrainPipeline(build_model(cfg), lars(0.01), cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loader = ShardedLoader(lm_batches(cfg, batch, seq), "cuda")
    try:
        state = train_state_from_params(pipe.model, pipe.optimizer, params)
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = pipe(state, next(loader))
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        del state, metrics
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
    finally:
        loader.close()
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": batch, "seq": seq, "losses": losses, "step_ms": ms,
            "peak_bytes": peak}


def qwen_session(lk) -> dict:
    """Phase 13: one seed-0 init of qwen3-14b (2 layers, bf16) on the card,
    shared by a profiled step of each LARS path at 4 x 4096 through the
    lean knobs and by the stock-against-lean comparison at STOCK_LEAN."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    stock = dataclasses.replace(get_config("qwen3-14b"), num_layers=2)
    lean = dataclasses.replace(stock, flash_vjp=True, attn_q_chunk=2048,
                               loss_chunk=1024)
    t0 = time.perf_counter()
    params = build_model(stock).init(torch.Generator().manual_seed(0),
                                     "cuda")
    out = {"init_s": time.perf_counter() - t0}
    log(f"  qwen3-14b init (2 layers, seed 0) {out['init_s']:.1f} s")
    out["profile"] = {
        "f32": lm_profile("f32", cfg=lean, batch=4, seq=4096, params=params),
        "large_batch": lm_profile("large_batch", cfg=lean, batch=4,
                                  seq=4096, accum=2, params=params)}
    batch, seq = STOCK_LEAN
    lk.reset_launch_counts()
    runs = {tag: lm_run(cfg, params, batch, seq, QWEN_STEPS)
            for tag, cfg in (("stock", stock), ("lean", lean))}
    if lk.LAUNCHES != {"norms_flat": 2 * QWEN_STEPS,
                       "apply_flat": 2 * QWEN_STEPS, "apply_flat_q8": 0}:
        raise AssertionError(f"stock and lean runs: launches {lk.LAUNCHES}")
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["lean"]["losses"],
                                               runs["stock"]["losses"])]
    for tag, r in runs.items():
        log(f"  {tag} b{batch} x {seq}: peak {r['peak_bytes'] / 2**30:.2f} "
            f"GiB  step ms {[round(x, 1) for x in r['step_ms']]}  losses "
            f"{[round(x, 6) for x in r['losses']]}")
    log(f"  lean vs stock loss rel diff by step "
        f"{[float(f'{x:.3g}') for x in rel]} (tolerance {STOCK_LEAN_RTOL})")
    if not all(map(math.isfinite, runs["stock"]["losses"]
                   + runs["lean"]["losses"])) or not max(rel) <= \
            STOCK_LEAN_RTOL:
        raise AssertionError(f"stock vs lean: {runs}")
    out["stock_vs_lean"] = dict(runs, rel_by_step=rel)
    del params
    return out


def qwen_card_vs_cpu(train, fdk) -> dict:
    """Phase 13: reduced qwen3-14b in f32 through the four knobs, 20 LARS
    steps on the CPU (plain versions) and on the card (kernels), within
    phase 12's gate; and its decode, 16 teacher-forced steps, card
    (flash_decode) against CPU, as phase 9 holds smollm's."""
    return {"train": train_card_vs_cpu(train, QWEN_CARD_CPU_ARGS,
                                       "reduced qwen3"),
            "decode": serve_card_vs_cpu_phase(fdk, "qwen3-14b")}


def lean_phase(train, lk, fdk, bw: float, flops: float, floor: float
               ) -> dict:
    """Phase 13: the memory-lean LM path on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.overrides import apply_overrides
    t_phase = time.perf_counter()
    out = {"qwen_kernel_rows": qwen_kernel_rows(lk, bw, flops, floor)}
    sets = lambda vs: [a for v in vs for a in ("--set", v)]  # noqa: E731
    out["smollm_runs"] = lm_train_runs(
        train, lk, fdk, LM_ARGS + ["--optimizer", "lars"],
        {tag: sets(vs) for tag, vs in LEAN_RUNS.items()})
    out["smollm_profile"] = lm_profile("f32", cfg=apply_overrides(
        get_config("smollm-135m"), LEAN_RUNS["all_four"]))
    out["qwen_runs"] = lm_train_runs(train, lk, fdk, QWEN_ARGS, QWEN_RUNS,
                                     QWEN_STEPS)
    out["qwen_session"] = qwen_session(lk)
    out["card_vs_cpu"] = qwen_card_vs_cpu(train, fdk)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 13 wall time {out['phase_wall_s']:.1f} s")
    return out


def granite_cfg():
    """granite-moe-3b-a800m as GRANITE_ARGS sets it: GRANITE_LAYERS
    layers, phase 13's lean knobs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.overrides import apply_overrides
    return apply_overrides(dataclasses.replace(
        get_config(GRANITE), num_layers=GRANITE_LAYERS), QWEN_LEAN)


def layer0_dropped_frac(model, params, tokens) -> float:
    """The share of dropped slots in layer 0's MoE block (its
    ``dropped_frac``) for ``tokens``."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_block
    from repro_torch.treepath import tree_map
    cfg = model.cfg
    p = tree_map(lambda t: t[0], params["layers"])
    with torch.no_grad():
        x = model.embed_tokens(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x = x + model.attention_block(
            p["attn"], L.apply_norm(cfg, x, p["ln1"]), positions)
        _, aux = moe_block(cfg, p["moe"], L.apply_norm(cfg, x, p["ln2"]))
    return float(aux["dropped_frac"])


def layer_split_ms(model, params, tokens) -> dict:
    """Layer 0's attention block (GQA or MLA) and MoE block, each forward
    and backward (gradients to its input and its weights) at ``tokens``'
    shape: ms per call by CUDA events around eager calls (dispatch_ms),
    which at these shapes is the device's time."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_block
    from repro_torch.treepath import tree_leaves, tree_map
    cfg = model.cfg
    p = tree_map(lambda t: t[0].detach().requires_grad_(
        t.is_floating_point()), params["layers"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    with torch.no_grad():
        x = model.embed_tokens(params, tokens)
        h1 = L.apply_norm(cfg, x, p["ln1"])
        x = x + model.attention_block(p["attn"], h1, positions)
        h2 = L.apply_norm(cfg, x, p["ln2"])
    h1, h2 = h1.requires_grad_(True), h2.requires_grad_(True)

    def attention():
        out = model.attention_block(p["attn"], h1, positions)
        torch.autograd.grad(out.float().square().mean(),
                            [h1] + tree_leaves(p["attn"]))

    def moe():
        out, aux = moe_block(cfg, p["moe"], h2)
        torch.autograd.grad(out.float().square().mean() + aux["aux_loss"],
                            [h2] + tree_leaves(p["moe"]))
    return {"attention": dispatch_ms(attention, warmup=2, reps=5),
            "moe": dispatch_ms(moe, warmup=2, reps=5)}


def moe_session(cfg, batch: int, label: str) -> dict:
    """Phases 14, 15: the seed-0 init ``launch.train`` draws for ``cfg``
    (an MoE at its training cut), on the card: the share of dropped slots
    at layer 0 for the first ``batch`` x 4096 batch it feeds; layer 0's
    attention and MoE block timed apart, forward and backward; then a
    profiled f32 LARS step at ``batch`` x 4096 through the lean knobs."""
    import torch
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import build_model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    out = {"init_s": time.perf_counter() - t0}
    tokens = torch.from_numpy(next(lm_batches(cfg, batch, 4096))[
        "tokens"]).cuda()
    out["layer0_dropped_frac"] = layer0_dropped_frac(model, params, tokens)
    out["layer0_fwd_bwd_ms"] = layer_split_ms(model, params, tokens)
    log(f"  {label} init (seed 0) {out['init_s']:.1f} s; layer 0 drops "
        f"{out['layer0_dropped_frac']:.4f} of its slots on the first "
        f"{batch} x 4096 batch; layer 0 forward + backward (events, "
        f"eager): attention {out['layer0_fwd_bwd_ms']['attention']:.2f} "
        f"ms, MoE block {out['layer0_fwd_bwd_ms']['moe']:.2f} ms")
    out["profile"] = lm_profile("f32", cfg=cfg, batch=batch, seq=4096,
                                params=params)
    del params
    return out


def granite_card_vs_cpu(train, fdk) -> dict:
    """Phase 14: reduced granite that drops slots, in f32: 20 LARS steps
    on the CPU (plain versions) and on the card (kernels), within phase
    12's gate, aux losses finite and nonzero; its decode, 16
    teacher-forced steps, card against CPU, as phase 9 holds smollm's."""
    import torch
    from repro_torch.launch.train import lm_batches
    cfg, model, params = _reduced_lm("cpu", GRANITE, GRANITE_DROP)
    batch = next(lm_batches(cfg, 8, 64))["tokens"]
    drop = layer0_dropped_frac(model, params, torch.from_numpy(batch))
    log(f"  reduced granite {GRANITE_DROP}: layer 0 drops {drop:.4f} of "
        f"its slots on the first batch")
    if not drop > 0:
        raise AssertionError(f"reduced granite {GRANITE_DROP} drops no slot")
    return {"layer0_dropped_frac": drop,
            "train": train_card_vs_cpu(train, GRANITE_CARD_CPU_ARGS,
                                       "reduced granite", aux=True),
            "decode": serve_card_vs_cpu_phase(fdk, GRANITE, GRANITE_DROP)}


def granite_phase(train, serve, lk, fdk, bw: float, flops: float,
                  floor: float) -> dict:
    """Phase 14: the MoE family (granite-moe-3b-a800m) on the card."""
    import torch
    t_phase = time.perf_counter()
    layout = lm_layout(granite_cfg())
    out = {"rows": layout.buffer_shape[0], "slices": layout.num_slices,
           "kernel_rows": large_kernel_rows(lk, layout, 3, bw, flops,
                                            floor)}
    out["flash_decode_row"] = fd_timed_row(
        fdk, GRANITE_FD, torch.Generator(device="cuda").manual_seed(3), bw,
        flops)
    out["runs"] = lm_train_runs(train, lk, fdk, GRANITE_ARGS, QWEN_RUNS,
                                GRANITE_STEPS, aux=True)
    out["session"] = moe_session(granite_cfg(), 4,
                                 f"granite ({GRANITE_LAYERS} layers)")
    out["serve"] = serve_phase(serve, fdk, lk, GRANITE_SERVE_ARGS)
    out["card_vs_cpu"] = granite_card_vs_cpu(train, fdk)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 14 wall time {out['phase_wall_s']:.1f} s")
    return out


def deepseek_cfg(cut=DEEPSEEK_CUT + DEEPSEEK_LEAN):
    """deepseek-v2-236b as DEEPSEEK_ARGS sets it (or with ``cut``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.overrides import apply_overrides
    return apply_overrides(get_config(DEEPSEEK), cut)


def deepseek_serve(serve, fdk, lk) -> dict:
    """Phase 15: ``launch.serve`` on deepseek at every width, all 160
    experts, DEEPSEEK_SERVE_LAYERS layers (phase 8's traffic): no
    ``flash_decode`` launch in the run; the share of slots the decode
    ticks' MoE blocks drop (each
    tick routes all 32 slots: capacity round(6 * 32 / 160 * 1.25) = 2 an
    expert); the latent cache's bytes beside an expanded K/V cache's."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import lm as lm_module
    drops = []
    inner = lm_module.moe_block

    def recording(cfg, p, x):
        out, aux = inner(cfg, p, x)
        if x.shape[1] == 1:                       # a decode tick
            drops.append(aux["dropped_frac"].detach())
        return out, aux

    lm_module.moe_block = recording
    try:
        out = serve_phase(serve, fdk, lk, DEEPSEEK_SERVE_ARGS)
    finally:
        lm_module.moe_block = inner
    out["decode_dropped_frac"] = float(torch.stack(drops).mean())
    cfg = deepseek_cfg([f"num_layers={DEEPSEEK_SERVE_LAYERS}"])
    cache = build_model(cfg).init_cache(32, 4096, device="meta")
    out["latent_cache_bytes"] = sum(t.numel() * t.element_size()
                                    for k, t in cache.items() if k != "pos")
    # the expanded cache: K (nope + rope) and V of every head, bf16
    out["expanded_kv_cache_bytes"] = (
        cfg.num_layers * 32 * 4096 * cfg.num_heads
        * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2)
    log(f"  decode ticks drop {out['decode_dropped_frac']:.4f} of their "
        f"MoE slots (mean over {len(drops)} layer calls); latent cache "
        f"{out['latent_cache_bytes']:,} B against an expanded K/V cache's "
        f"{out['expanded_kv_cache_bytes']:,} B")
    return out


def masks_phase(train, lk, fdk, stock_tokens_per_s=None) -> dict:
    """Phase 15: smollm-135m at full width with a sliding window and the
    logit softcap, 4 LARS steps through the stock core and through
    flash_vjp (launches and finite losses gated); reduced qwen3 with both,
    20 LARS steps card against CPU within phase 12's gate."""
    out = {"runs": lm_train_runs(train, lk, fdk, MASK_ARGS, MASK_RUNS)}
    out["phase12_stock_tokens_per_s"] = stock_tokens_per_s
    log(f"  smollm with {MASKS}: stock "
        f"{out['runs']['stock']['tokens_per_s']:.0f} tokens/s, flash_vjp "
        f"{out['runs']['flash_vjp']['tokens_per_s']:.0f}; phase 12's stock "
        f"core without them " + (f"{stock_tokens_per_s:.0f}" if
                                 stock_tokens_per_s else "not run"))
    out["card_vs_cpu"] = train_card_vs_cpu(train, MASK_CARD_CPU_ARGS,
                                           "reduced qwen3 with both")
    return out


def mla_phase(train, serve, lk, fdk, bw: float, flops: float, floor: float,
              stock_tokens_per_s=None) -> dict:
    """Phase 15: MLA (deepseek-v2-236b) trained and served on the card,
    and the training side of sliding windows and the softcap."""
    t_phase = time.perf_counter()
    layout = lm_layout(deepseek_cfg())
    out = {"rows": layout.buffer_shape[0], "slices": layout.num_slices,
           "kernel_rows": large_kernel_rows(lk, layout, 4, bw, flops,
                                            floor)}
    out["runs"] = lm_train_runs(train, lk, fdk, DEEPSEEK_ARGS, QWEN_RUNS,
                                DEEPSEEK_STEPS, aux=True)
    out["session"] = moe_session(deepseek_cfg(), DEEPSEEK_BATCH,
                                 "deepseek (2 layers, 16 routed experts)")
    out["serve"] = deepseek_serve(serve, fdk, lk)
    # reduced deepseek in f32 with a nonzero query rank: training and its
    # decode (16 teacher-forced steps, the engine's greedy tokens)
    out["card_vs_cpu"] = {
        "train": train_card_vs_cpu(train, DEEPSEEK_CARD_CPU_ARGS,
                                   f"reduced deepseek {DEEPSEEK_Q_LORA}",
                                   aux=True),
        "decode": serve_card_vs_cpu_phase(fdk, DEEPSEEK, DEEPSEEK_Q_LORA)}
    out["masks"] = masks_phase(train, lk, fdk, stock_tokens_per_s)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 15 wall time {out['phase_wall_s']:.1f} s")
    return out


def ssm_cfg(arch: str):
    """falcon-mamba-7b or zamba2-7b as ``ssm_args`` sets it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.overrides import apply_overrides
    return apply_overrides(get_config(arch),
                           [f"num_layers={SSM_LAYERS[arch]}"] + QWEN_LEAN)


def ssm_split_ms(model, params, tokens) -> dict:
    """Layer 0's Mamba block and, in the hybrid, the shared attention +
    MLP block after it, each forward and backward (gradients to its
    input and its weights) at ``tokens``' shape: ms per call by CUDA
    events around eager calls (dispatch_ms), which at these shapes is
    the device's time. The Mamba block streams its chunks through their
    checkpoints, as in training."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.treepath import tree_leaves, tree_map
    cfg = model.cfg
    p = tree_map(lambda t: t[0].detach().requires_grad_(True),
                 params["layers"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    with torch.no_grad():
        x = model.embed_tokens(params, tokens)
        h = L.apply_norm(cfg, x, p["ln1"])
        x = x + model._ssm_forward(p["ssm"], h)[0]
    h = h.requires_grad_(True)

    def mamba():
        out = model._ssm_forward(p["ssm"], h)[0]
        torch.autograd.grad(out.float().square().mean(),
                            [h] + tree_leaves(p["ssm"]))
    out = {"mamba": dispatch_ms(mamba, warmup=1, reps=3)}
    if cfg.family == "hybrid":
        shared = tree_map(lambda t: t.detach().requires_grad_(True),
                          params["shared"])
        x = x.requires_grad_(True)

        def shared_block():
            y = model._shared_block(shared, x, positions)
            torch.autograd.grad(y.float().square().mean(),
                                [x] + tree_leaves(shared))
        out["shared_block"] = dispatch_ms(shared_block, warmup=1, reps=3)
    return out


def train_runs_with_session(train, lk, fdk, args: list, steps: int,
                            session_fn) -> tuple[dict, dict]:
    """Phases 16, 17: :func:`lm_train_runs` for ``args`` (``steps`` steps
    each of f32 LARS and the large-batch path through
    ``launch.train.main``), the f32 run's init shared with a session: after
    that run's steps, ``session_fn(pipeline, state, batches, session)``
    fills ``session`` and returns the state after its own steps. The
    session's kernel launches are not the run's: the launch counts are
    restored after it. Returns (the runs, the session)."""
    import torch
    inner = train.train_loop
    session = {}

    def loop(pipeline, state, batches, steps, *, log_every=0, eval_fn=None,
             eval_batches=None):
        # hand train_loop the only reference to the first state, as
        # launch.train does: a name held here would keep it through the
        # run (an f32 momentum and bf16 weights, ~13 GB at these sizes)
        first = [state]
        del state
        state, hist = inner(pipeline, first.pop(), batches, steps,
                            log_every=log_every, eval_fn=eval_fn,
                            eval_batches=eval_batches)
        if pipeline.precision.name == "f32" and not session:
            counts = dict(lk.LAUNCHES)
            state = session_fn(pipeline, state, batches, session)
            torch.cuda.synchronize()
            lk.LAUNCHES.update(counts)
        return state, hist

    train.train_loop = loop
    try:
        runs = lm_train_runs(train, lk, fdk, args, QWEN_RUNS, steps)
    finally:
        train.train_loop = inner
    return runs, session


def ssm_train_runs(train, lk, fdk, arch: str) -> tuple[dict, dict]:
    """Phase 16: ``arch``'s runs, and on the f32 run's state after its
    steps layer 0's Mamba block (and zamba2's shared block) timed apart,
    forward and backward, on the next 4 x 4096 batch, then one more f32
    LARS step profiled."""
    def session_fn(pipeline, state, batches, session):
        batch = next(batches)
        session["layer0_fwd_bwd_ms"] = ssm_split_ms(
            pipeline.model, state.params, batch["tokens"])
        log(f"  {arch}, after the f32 run's {SSM_STEPS} steps, forward + "
            f"backward at 4 x 4096 (events, eager): " + ", ".join(
                f"{k} {v:.2f} ms"
                for k, v in session["layer0_fwd_bwd_ms"].items()))
        session["profile"], state = profile_steps(
            pipeline, state, batches, 1, f"{arch} f32, 1 step of 4 x 4096")
        return state

    return train_runs_with_session(train, lk, fdk, ssm_args(arch),
                                   SSM_STEPS, session_fn)


def ssm_serve(serve, fdk, lk, arch: str) -> dict:
    """Phase 16: ``launch.serve`` at ``arch``'s cut (phase 8's traffic):
    the launches per tick (falcon-mamba none, zamba2 one per application
    of its shared block: 2) gated by :func:`serve_phase`; the recurrent
    cache's bytes (bf16 conv states, f32 recurrent states, zamba2's
    shared-block K/V) beside a K/V cache of the same depth (K and V of
    width d_model in every layer, bf16)."""
    from repro_torch.models import build_model
    out = serve_phase(serve, fdk, lk, ssm_serve_args(arch))
    cfg = ssm_cfg(arch)
    # one launch per application of the hybrid's shared block
    want = -(-cfg.num_layers // cfg.attn_every) if arch == ZAMBA else 0
    if out["launches"]["flash_decode"] != want * out["decode_steps"]:
        raise AssertionError(f"{arch}: {out['launches']} in "
                             f"{out['decode_steps']} ticks, want {want} a "
                             "tick")
    cache = build_model(cfg).init_cache(32, 4096, device="meta")
    out["cache_bytes"] = {k: t.numel() * t.element_size()
                          for k, t in cache.items() if k != "pos"}
    out["kv_cache_same_depth_bytes"] = (2 * cfg.num_layers * 32 * 4096
                                        * cfg.d_model * 2)
    log(f"  {arch}: {want} flash_decode launches a tick; cache "
        f"{sum(out['cache_bytes'].values()):,} B {out['cache_bytes']} "
        f"against a K/V cache of the same depth's "
        f"{out['kv_cache_same_depth_bytes']:,} B")
    return out


def ssm_phase(train, serve, lk, fdk, bw: float, flops: float,
              floor: float) -> dict:
    """Phase 16: the SSM (falcon-mamba-7b) and hybrid (zamba2-7b) families
    trained and served on the card."""
    import torch
    t_phase = time.perf_counter()
    out = {}
    for seed, arch in ((5, FALCON), (6, ZAMBA)):
        layout = lm_layout(ssm_cfg(arch))
        out[arch] = {"rows": layout.buffer_shape[0],
                     "slices": layout.num_slices,
                     "kernel_rows": large_kernel_rows(lk, layout, seed, bw,
                                                      flops, floor)}
    out["flash_decode_row"] = fd_timed_row(
        fdk, ZAMBA_FD, torch.Generator(device="cuda").manual_seed(6), bw,
        flops)
    for arch in (FALCON, ZAMBA):
        o = out[arch]
        t0 = time.perf_counter()
        o["runs"], o["session"] = ssm_train_runs(train, lk, fdk, arch)
        o["serve"] = ssm_serve(serve, fdk, lk, arch)
        # the reduced config in f32: training and its decode (16
        # teacher-forced steps, the engine's greedy tokens)
        o["card_vs_cpu"] = {
            "train": train_card_vs_cpu(train, ssm_card_cpu_args(arch),
                                       f"reduced {arch}"),
            "decode": serve_card_vs_cpu_phase(fdk, arch,
                                              SSM_REDUCED[arch])}
        o["wall_s"] = time.perf_counter() - t0
        log(f"  {arch} wall time {o['wall_s']:.1f} s")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 16 wall time {out['phase_wall_s']:.1f} s")
    return out


def family_cfg(arch: str):
    """whisper-base whole, or paligemma-3b as PALI_ARGS sets it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.overrides import apply_overrides
    if arch == WHISPER:
        return apply_overrides(get_config(WHISPER), ["flash_vjp=true"])
    return apply_overrides(get_config(PALIGEMMA),
                           [f"num_layers={PALI_LAYERS}"] + PALI_LEAN)


def stub_input(cfg) -> tuple[str, int]:
    """The family's stub input in a batch, and its length."""
    if cfg.family == "encdec":
        return "frames", cfg.encoder_seq
    return "image_embeddings", cfg.num_image_tokens


def family_train_runs(train, lk, fdk, arch: str) -> tuple[dict, dict]:
    """Phase 17: ``arch``'s runs (3 steps each of f32 LARS and the
    large-batch path), and one more f32 LARS step profiled on the f32
    run's state."""
    args = WHISPER_ARGS if arch == WHISPER else PALI_ARGS
    zero_stub = train.lm_batches

    def noise_stub(cfg, batch, seq, seed=0):
        """The loader's batches with seeded unit-normal image embeddings
        in place of the zeros."""
        import numpy as np
        rng = np.random.default_rng(seed + 1)
        for b in zero_stub(cfg, batch, seq, seed):
            img = b["image_embeddings"]
            b["image_embeddings"] = rng.standard_normal(img.shape,
                                                        dtype=np.float32)
            yield b

    def session_fn(pipeline, state, batches, session):
        session["profile"], state = profile_steps(
            pipeline, state, batches, 1,
            f"{arch} f32, 1 step of {args[args.index('--batch') + 1]} x "
            f"{args[args.index('--seq') + 1]} tokens")
        return state

    if arch == PALIGEMMA:
        train.lm_batches = noise_stub
    try:
        runs, session = train_runs_with_session(train, lk, fdk, args,
                                                FAMILY_STEPS, session_fn)
    finally:
        train.lm_batches = zero_stub
    if arch == WHISPER:         # and the encoder's stub frames a second
        enc = family_cfg(WHISPER).encoder_seq
        for r in runs.values():
            r["frames_per_s"] = r["tokens_per_s"] / r["seq"] * enc
            log(f"  {r['opt_state_dtype']} LARS: {r['frames_per_s']:.0f} "
                f"frames/s beside {r['tokens_per_s']:.0f} decoder tokens/s")
    return runs, session


def decode_engine_serve(fdk, lk, arch: str) -> dict:
    """Phase 17: ``DecodeEngine`` at ``arch``'s training width and depth
    (bf16, the seed-0 init the training runs drew): one static batch of
    WHISPER_SERVE / PALI_SERVE (requests, prompt tokens, new tokens) with
    seeded stub frames or image embeddings. A prefill alone launches no
    ``flash_decode``; then a timed prefill and the timed ``generate``
    (prefill and one decode tick per new token but the first): its
    launches, 2 a layer a tick for whisper (self- and cross-attention), 1
    for paligemma; tick ms (generate's time less the prefill's, per
    tick), tokens/s, finite prefill logits and tokens in the vocabulary;
    then a ``torch.profiler`` window over 5 decode ticks after a fresh
    prefill and 2 warm-up ticks: the device's busy share and
    ``flash_decode``'s device time in a tick. Every launch count is set
    to 0 just before and read just after."""
    from torch.profiler import ProfilerActivity, profile
    import dataclasses
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine
    cfg = dataclasses.replace(family_cfg(arch), flash_vjp=False,
                              attn_q_chunk=0, loss_chunk=0)
    B, S, new = WHISPER_SERVE if arch == WHISPER else PALI_SERVE
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    engine = DecodeEngine(model, params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(8)
    name, n = stub_input(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             name: torch.randn(B, n, cfg.d_model, generator=gen,
                               device="cuda") * 0.5}
    cap = S + new + (n if cfg.family == "vlm" else 0)
    lk.reset_launch_counts()
    fdk.reset_launch_counts()
    for _ in range(2):                  # the second one timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine._prefill(params, batch, cache_len=cap)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        del cache
    if fdk.LAUNCHES["flash_decode"] or any(lk.LAUNCHES.values()) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: {fdk.LAUNCHES}, "
                             f"{lk.LAUNCHES}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    fdk.reset_launch_counts()
    t0 = time.perf_counter()
    toks = engine.generate(batch, max_new_tokens=new, cache_len=cap)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fdk.LAUNCHES["flash_decode"]
    ticks = new - 1
    per_tick = model.flash_decode_per_step()
    want = {WHISPER: 2 * cfg.num_layers, PALIGEMMA: cfg.num_layers}[arch]
    out = {"requests": B, "prompt_tokens": S, "new_tokens": new,
           "cache_len": cap, "num_layers": cfg.num_layers,
           "prefill_ms": 1e3 * prefill_s, "wall_s": wall_s,
           "ticks": ticks, "tick_ms": 1e3 * (wall_s - prefill_s) / ticks,
           "tok_per_s": B * new / wall_s,
           "launches": {"flash_decode": launches},
           "flash_decode_per_tick": launches / ticks}
    log(f"  {arch} DecodeEngine: {B} requests of {S} prompt tokens"
        + (f" behind {n} image tokens" if cfg.family == "vlm" else
           f" over {n} stub frames") + f", {new} new tokens (cache "
        f"{cap}): prefill {out['prefill_ms']:.1f} ms, {ticks} ticks of "
        f"{out['tick_ms']:.2f} ms, {out['tok_per_s']:.1f} tok/s; "
        f"flash_decode launches {launches} ({launches / ticks:g} a tick, "
        f"want {want}; none in prefill)")
    if per_tick != want or launches != want * ticks:
        raise AssertionError(f"{arch}: {launches} flash_decode launches in "
                             f"{ticks} ticks, want {want} a tick")
    if tuple(toks.shape) != (B, new) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: tokens {tuple(toks.shape)} out of "
                             "range")
    logits, cache = engine._prefill(params, batch, cache_len=cap)
    tok = logits.argmax(dim=-1).to(torch.int32)[:, None]

    def decode_ticks(n):
        nonlocal logits, cache, tok
        for _ in range(n):
            logits, cache = engine._step(params, cache, tok)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    decode_ticks(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_ticks(5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    kernels = device_ms_by_kernel(prof)
    busy = sum(kernels.values()) / 5
    fd_ms = sum(ms for k, ms in kernels.items() if "flash_decode" in k) / 5
    out["profile"] = {"wall_ms_per_tick": wall_ms,
                      "device_busy_ms_per_tick": busy if busy else None,
                      "flash_decode_ms_per_tick": fd_ms if busy else None}
    log(f"  {arch}, a profile of 5 decode ticks: wall {wall_ms:.3f} ms a "
        f"tick, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"flash_decode {fd_ms:.4f} ms a tick" if busy else
        f"  {arch}: device time not measured (the profiler recorded no "
        "CUDA events)")
    del engine, params, batch, logits, toks, cache
    torch.cuda.empty_cache()
    return out


def family_decode_card_vs_cpu(fdk, arch: str, changes: dict) -> dict:
    """Phase 17: a reduced encdec or vlm model in f32 on the CPU (plain
    versions) and on the card (kernels): prefill (no ``flash_decode``
    launch), 16 teacher-forced decode steps with their launches, logits
    within SERVE_CARD_CPU_ATOL; ``DecodeEngine``'s greedy tokens
    identical on both."""
    import torch
    from repro_torch.serve import DecodeEngine
    from repro_torch.treepath import tree_map
    cfg, model, params = _reduced_lm("cpu", arch, tuple(changes.items()))
    card = tree_map(lambda t: t.cuda(), params)
    g = torch.Generator().manual_seed(0)
    name, n = stub_input(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 24),
                                     generator=g, dtype=torch.int32),
             name: torch.randn(4, n, cfg.d_model, generator=g) * 0.5}
    feed = torch.randint(0, cfg.vocab_size, (16, 4, 1), generator=g,
                         dtype=torch.int32)
    cap = 48 + (n if cfg.family == "vlm" else 0)
    logits, greedy = {}, {}
    for dev, p in (("cpu", params), ("cuda", card)):
        fdk.reset_launch_counts()
        _, cache = model.prefill(p, batch["tokens"].to(dev), cache_len=cap,
                                 **{name: batch[name].to(dev)})
        if fdk.LAUNCHES["flash_decode"]:
            raise AssertionError("prefill launched flash_decode")
        logits[dev] = torch.stack([model.decode_step(p, cache, t.to(dev))[0]
                                   .cpu() for t in feed])
        want = model.flash_decode_per_step() * len(feed) \
            if dev == "cuda" else 0
        if fdk.LAUNCHES["flash_decode"] != want:
            raise AssertionError(f"{dev}: {fdk.LAUNCHES} launches, want "
                                 f"{want}")
        greedy[dev] = DecodeEngine(model, p, cfg).generate(
            batch, max_new_tokens=12, cache_len=cap).cpu().tolist()
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    same = greedy["cpu"] == greedy["cuda"]
    log(f"  reduced {arch} {changes or ''}: 16 teacher-forced decode "
        f"steps: max abs logits diff {diff:.3g} (tolerance "
        f"{SERVE_CARD_CPU_ATOL});"
        f" DecodeEngine's greedy tokens of 4 requests "
        f"{'identical' if same else 'DIFFERENT'}")
    if not diff <= SERVE_CARD_CPU_ATOL or not same:
        raise AssertionError(f"{arch} card vs CPU: diff {diff}, greedy "
                             f"{greedy}")
    return {"max_abs_logits_diff": diff, "greedy_identical": same}


def fd_wide_f32_check(fdk) -> dict:
    """Phase 17: the D 256 instance in f32 against its plain version at
    (8, 4096, 1, 8, 256), lengths 0, 1, S and past S among the rows."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, lens = fd_inputs(8, 4096, 1, 8, 256, "edges", torch.float32,
                              gen)
    err, rel = _fd_err(fdk, q, k, v, lens, "float32")
    log(f"  flash_decode float32 D=256 G=8: max abs err {err:.3g} (rel "
        f"{rel:.3g}); lengths 0, 1, S, S+7 included")
    return {"shape": {"B": 8, "S": 4096, "Hkv": 1, "G": 8, "D": 256,
                      "dtype": "float32"}, "max_abs_err": err,
            "max_rel_err": rel}


def fd_poison_check(fdk) -> dict:
    """Phase 17: for each bf16 instance (D 64, 128 and the wide kernel at
    256), K and V rows past each length filled with NaN give the same
    output bits as finite rows (lengths 0, 1, inside a tile, on a tile,
    on a split boundary, S)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(10)
    B, S = 8, 1024
    out = {}
    for D in (64, 128, 256):
        q, k, v, _ = fd_inputs(B, S, 1, 8, D, "full", torch.bfloat16, gen)
        kps = fdk.plan(q, k).keys_per_split
        lens = torch.tensor([0, 1, 17, 16, kps, kps + 5, S - 3, S],
                            dtype=torch.int32, device=q.device)
        past = (torch.arange(S, device=q.device)[None, :]
                >= lens[:, None].long())[:, :, None, None]
        nan = torch.tensor(float("nan"), dtype=k.dtype, device=q.device)
        clean = fdk.flash_decode(q, k, v, lens, scale=D ** -0.5)
        poisoned = fdk.flash_decode(q, torch.where(past, nan, k),
                                    torch.where(past, nan, v), lens,
                                    scale=D ** -0.5)
        torch.cuda.synchronize()
        if not torch.equal(clean, poisoned):
            raise AssertionError(f"flash_decode D={D}: NaN rows past the "
                                 "length reach the output")
        out[D] = True
    log(f"  flash_decode bf16 D 64, 128, 256: NaN rows past each length "
        f"give the same bits as finite rows")
    return out


def family_phase(train, lk, fdk, bw: float, flops: float,
                 floor: float) -> dict:
    """Phase 17: the encdec (whisper-base) and vlm (paligemma-3b) families
    trained and served on the card."""
    import torch
    from repro_torch.kernels import build
    t_phase = time.perf_counter()
    layout = lm_layout(family_cfg(PALIGEMMA))
    out = {PALIGEMMA: {"rows": layout.buffer_shape[0],
                       "slices": layout.num_slices,
                       "kernel_rows": large_kernel_rows(lk, layout, 7, bw,
                                                        flops, floor)},
           WHISPER: {}}
    gen = torch.Generator(device="cuda").manual_seed(7)
    out["flash_decode_rows"] = [fd_timed_row(fdk, shape, gen, bw, flops)
                                for shape in PALI_FD + [WHISPER_FD]]
    out["flash_decode_f32"] = fd_wide_f32_check(fdk)
    out["flash_decode_poison"] = fd_poison_check(fdk)
    out["ptxas"] = {k: v for k, v in build.ptxas_usage(
        "flash_decode").items() if k.endswith("<256>")}
    log(f"  ptxas, the D 256 instances: {out['ptxas']}")
    wide = out["ptxas"].get("flash_decode_wide_kernel<256>")
    if wide is None or wide.get("spill_stores") or wide.get("spill_loads"):
        raise AssertionError(f"flash_decode's wide kernel: ptxas {wide}")
    for arch in (WHISPER, PALIGEMMA):
        o = out[arch]
        t0 = time.perf_counter()
        o["runs"], o["session"] = family_train_runs(train, lk, fdk, arch)
        o["serve"] = decode_engine_serve(fdk, lk, arch)
        o["wall_s"] = time.perf_counter() - t0
        log(f"  {arch} wall time {o['wall_s']:.1f} s")
    out["card_vs_cpu"] = {
        tag: {"train": train_card_vs_cpu(
            train, family_card_cpu_args(arch, changes), f"reduced {tag}"),
              "decode": family_decode_card_vs_cpu(fdk, arch, changes)}
        for tag, (arch, changes) in FAMILY_REDUCED.items()}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 17 wall time {out['phase_wall_s']:.1f} s")
    return out


@contextlib.contextmanager
def tree_states(train):
    """Within the block ``launch.train`` builds its pipelines with
    ``packed=False``: markerless (tree) optimizer states."""
    inner = train.TrainPipeline

    def pipeline(*args, **kw):
        return inner(*args, packed=False, **kw)

    train.TrainPipeline = pipeline
    try:
        yield
    finally:
        train.TrainPipeline = inner


def tree_lenet_runs(train, lk, fdk, packed_runs: dict) -> dict:
    """Phase 18 (a): ``launch.train.main`` on tree states, LeNet at phase
    4's batch 8192 and 20 steps: f32 LARS, SGD, LAMB, AdamW and the
    large-batch LARS path (bf16, f32 master tree, int8 momentum, 8
    microbatches unfused). No LARS kernel launches; finite losses;
    steps/s beside phase 4's packed run of the same path."""
    out = {}
    zero = {k: 0 for k in KERNELS}
    for tag, extra in TREE_RUNS.items():
        lk.reset_launch_counts()
        fdk.reset_launch_counts()
        with tree_states(train):
            summary = train.main(MAIN_ARGS + extra)
        counts = dict(lk.LAUNCHES)
        losses = summary["losses"]
        if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"tree {tag}: losses {losses}")
        if counts != zero or fdk.LAUNCHES["flash_decode"]:
            raise AssertionError(f"tree {tag}: launches {counts}")
        twin = packed_runs.get(TREE_PACKED_TWIN.get(tag))
        out[tag] = {"steps_per_s": summary["steps_per_s"],
                    "train_s": summary["train_s"], "losses": losses,
                    "eval_accuracy": summary["eval_accuracy"],
                    "launches": counts,
                    "packed_steps_per_s": twin["steps_per_s"] if twin
                    else None}
        log(f"  tree {tag}: {summary['steps_per_s']:.3f} steps/s"
            + (f" (phase 4 packed: {twin['steps_per_s']:.3f})" if twin
               else "") + f"  eval accuracy {summary['eval_accuracy']:.4f}"
            f"  launches {counts}  losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")
    return out


def tree_against_packed(lk, schedule: str) -> dict:
    """Phase 18 (a): 20 f32 LARS steps at batch 8192 from one init, on a
    packed and on a tree state (cuDNN's deterministic algorithms on), at
    a flat LR of TREE_PACKED_LR (``schedule="flat"``: the params within
    TREE_PACKED_RTOL / ATOL and the losses within TREE_LOSS_RTOL, gated)
    or on phase 4's schedule (``"phase4"``: logged). The packed run
    launches one ``norms_flat`` and one ``apply_flat`` a step, the tree
    run none. The two runs are timed (steps/s, each ending in a sync),
    packed first on the flat LR and tree first on phase 4's schedule."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import get_optimizer
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import TrainPipeline, train_state_from_params
    from repro_torch.treepath import tree_leaves
    dev = torch.device("cuda")
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    opt = get_optimizer("lars", learning_rate=TREE_PACKED_LR
                        if schedule == "flat" else train.make_lr_schedule(
                            train.parse_args(MAIN_ARGS)))
    params = model.init(torch.Generator().manual_seed(0), dev)
    batches = _batches(dev, 8192, MAIN_STEPS)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for packed in ((True, False) if schedule == "flat"
                       else (False, True)):
            pipe = TrainPipeline(model, opt, cfg, packed=packed)
            state = train_state_from_params(model, opt, params,
                                            packed=packed)
            lk.reset_launch_counts()
            losses = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                state, m = pipe(state, b)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            rate = len(batches) / (time.perf_counter() - t0)
            runs[packed] = ([float(x) for x in losses],
                            tree_leaves(state.params), dict(lk.LAUNCHES),
                            rate)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = {True: {"norms_flat": MAIN_STEPS, "apply_flat": MAIN_STEPS,
                   "apply_flat_q8": 0},
            False: {k: 0 for k in KERNELS}}
    for packed, (_, _, counts, _) in runs.items():
        if counts != want[packed]:
            raise AssertionError(f"packed={packed}: launches {counts}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[False][0],
                                                  runs[True][0]))
    excess = max(float(torch.max(torch.abs(a - b) - TREE_PACKED_RTOL
                                 * torch.abs(b))) for a, b in
                 zip(runs[False][1], runs[True][1]))
    diff = max(float(torch.max(torch.abs(a - b))) for a, b in
               zip(runs[False][1], runs[True][1]))
    gated = schedule == "flat"
    log(f"  tree against packed, {MAIN_STEPS} f32 LARS steps from one "
        f"init, {schedule} LR: losses within {rel:.3g} relative, params "
        f"within {diff:.3g} absolute" + (
            f" (tolerances: losses {TREE_LOSS_RTOL}, params rtol "
            f"{TREE_PACKED_RTOL} atol {TREE_PACKED_ATOL})" if gated
            else " (logged)") + f"; launches packed {runs[True][2]}, "
        f"tree {runs[False][2]}; steps/s packed {runs[True][3]:.2f}, tree "
        f"{runs[False][3]:.2f}")
    if gated and (not rel <= TREE_LOSS_RTOL
                  or not excess <= TREE_PACKED_ATOL):
        raise AssertionError(f"tree against packed: loss rel {rel}, param "
                             f"excess {excess}")
    return {"loss_max_rel": rel, "param_max_abs": diff,
            "launches": {("packed" if k else "tree"): v[2]
                         for k, v in runs.items()},
            "steps_per_s": {("packed" if k else "tree"): v[3]
                            for k, v in runs.items()}}


def tree_lm_phase(train, lk, fdk, packed_runs: dict) -> dict:
    """Phase 18 (b): smollm-135m whole at 16 x 1024 on tree states: f32
    LARS and the large-batch path (4 microbatches of 4), each beside a
    packed run of the same in turns (tree first for f32, packed first
    for the large-batch path) and beside phase 12's figures (tokens/s and
    peak; phase 12's large-batch run is 4 microbatches of 16);
    a profiled f32 step on each engine with the optimizer's update
    annotated (its device kernels, their count and device ms, its host
    ms)."""
    import gc
    import torch
    runs, twins = {}, {}
    for (tag, args), order in zip(TREE_LM_RUNS.items(),
                                  ((True, False), (False, True))):
        for tree in order:
            with (tree_states(train) if tree else contextlib.nullcontext()):
                got = lm_train_runs(train, lk, fdk, LM_ARGS, {tag: args},
                                    tree=tree)[tag]
            (runs if tree else twins)[tag] = got
    for tag, r in runs.items():
        p, t = packed_runs[tag], twins[tag]
        r.update(packed_tokens_per_s=p["tokens_per_s"],
                 packed_peak_bytes=p["peak_bytes"], twin=t)
        log(f"  tree {tag}: {r['tokens_per_s']:.0f} tokens/s against "
            f"{t['tokens_per_s']:.0f} packed in turn "
            f"({r['tokens_per_s'] / t['tokens_per_s']:.3f}x) and phase "
            f"12's {p['tokens_per_s']:.0f} (batch {p['batch']}); peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB against "
            f"{t['peak_bytes'] / 2**30:.2f} GiB (phase 12: "
            f"{p['peak_bytes'] / 2**30:.2f} GiB)")
    out = {"runs": runs, "profile": {}}
    for packed in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        out["profile"]["packed" if packed else "tree"] = lm_profile(
            "f32", packed=packed, annotate_update=True)
    return out


def pbt_run(experiment, lk, out_dir: str, report: str,
            kill_after: int = 0) -> dict:
    """``launch.experiment.main`` with PBT_ARGS into ``out_dir``; with
    ``kill_after`` it is killed after that many steps (it must return
    130) and resumed. Every segment's launches are held to
    ``_want_launches``'s per step; returns the segments' counts."""
    from repro_torch.experiments import GridRunner
    from repro_torch.experiments.runner import ABORT_ENV
    inner = GridRunner.run_cell_segment
    segments = []

    def counted(self, cell, state, *, start, until_step, **kw):
        before = dict(lk.LAUNCHES)
        out = inner(self, cell, state, start=start, until_step=until_step,
                    **kw)
        ran = max(0, min(until_step, cell.steps) - start)
        got = {k: lk.LAUNCHES[k] - before[k] for k in before}
        want = {k: ran * v // cell.steps
                for k, v in _want_launches(cell).items()}
        if got != want:
            raise AssertionError(f"{cell.cell_id} steps {start}..{start + ran}"
                                 f": launches {got}, want {want}")
        segments.append((cell.cell_id, ran, got))
        return out

    args = PBT_ARGS + ["--out-dir", out_dir, "--out", report]
    GridRunner.run_cell_segment = counted
    try:
        if kill_after:
            os.environ[ABORT_ENV] = str(kill_after)
            try:
                rc = experiment.main(args)
            finally:
                os.environ.pop(ABORT_ENV, None)
            if rc != 130:
                raise AssertionError(f"the kill after {kill_after} steps "
                                     f"returned {rc}")
            args = args + ["--resume"]
        rc = experiment.main(args)
    finally:
        GridRunner.run_cell_segment = inner
    if rc != 0:
        raise AssertionError(f"launch.experiment --pbt returned {rc}")
    return {"segments": len(segments),
            "steps": sum(n for _, n, _ in segments),
            "launches": {k: sum(c[k] for _, _, c in segments)
                         for k in KERNELS}}


def pbt_phase(workdir: str, lk) -> dict:
    """Phase 18 (d): ``launch.experiment --pbt`` on the registered
    pbt_smoke grid on the card, into a fresh directory under ``build/``:
    every member finished, killed or early-stopped by the protocol, every
    finished member with finite losses, each LARS segment one
    ``norms_flat`` and one ``apply_flat`` a step and each SGD segment
    none; the report's ``pbt`` block (claims logged, not gated); then the
    same run killed mid-round and resumed: its ``pbt.json`` and every
    lineage's trajectory (without timing keys) identical."""
    from repro_torch.experiments import cell_from_json, read_trajectory
    from repro_torch.experiments.record import load_json
    from repro_torch.launch import experiment
    root = os.path.join(workdir, "pbt")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    t0 = time.perf_counter()
    runs = {"run": pbt_run(experiment, lk, os.path.join(root, "run"),
                           os.path.join(root, "report.json"))}
    out["wall_s"] = time.perf_counter() - t0
    st = load_json(os.path.join(root, "run", "pbt.json"))
    for lin, m in sorted(st["members"].items()):
        if m["status"] not in ("done", "killed", "early_stopped"):
            raise AssertionError(f"{lin}: status {m['status']}")
        losses = [r["loss"] for r in read_trajectory(os.path.join(
            root, "run", lin, "trajectory.jsonl")) if "event" not in r]
        if m["status"] == "done" and not all(
                x is not None and math.isfinite(x) for x in losses):
            raise AssertionError(f"{lin}: losses {losses}")
        cell = cell_from_json(m["cell"])
        log(f"  {lin}: {m['status']} at step {m['step']} (generation "
            f"{cell.generation}, lr {cell.cell_base_lr:.4g}, trust "
            f"{cell.cell_trust_coef:.4g})"
            + (f", {m['reason']}" if m.get("reason") else ""))
    section = load_json(os.path.join(root, "report.json"))["pbt"]
    log(f"  pbt: {runs['run']['segments']} segments, "
        f"{runs['run']['steps']} steps in {out['wall_s']:.2f} s; events "
        f"{section['events']}; launches {runs['run']['launches']}")
    for key, val in section["claims"].items():
        log(f"  claim pbt.{key}: {val}")
    t0 = time.perf_counter()
    runs["killed"] = pbt_run(experiment, lk, os.path.join(root, "killed"),
                             os.path.join(root, "killed.json"),
                             PBT_KILL_AFTER)
    out["killed_wall_s"] = time.perf_counter() - t0

    def read(name):
        with open(os.path.join(root, name, "pbt.json"), "rb") as f:
            return f.read()

    differ = ([] if read("killed") == read("run") else ["pbt.json"]) + [
        lin for lin in sorted(st["members"])
        if read_trajectory(os.path.join(root, "killed", lin,
                                        "trajectory.jsonl"),
                           strip_timing=True)
        != read_trajectory(os.path.join(root, "run", lin,
                                        "trajectory.jsonl"),
                           strip_timing=True)]
    verdict = f"DIFFERENT: {differ}" if differ else "identical"
    log(f"  pbt killed after {PBT_KILL_AFTER} steps and resumed: pbt.json "
        f"and trajectories {verdict} to the uninterrupted run's")
    if differ:
        raise AssertionError(f"resumed pbt run differs: {differ}")
    log("  pbt block: " + json.dumps(section))
    out.update(runs=runs, events=section["events"],
               claims=section["claims"], resume_identical=True)
    return out


def tree_phase(train, lk, fdk, phase4: dict, phase12: dict,
               workdir: str) -> dict:
    """Phase 18: the tree engine and the PBT controller on the card."""
    t_phase = time.perf_counter()
    out = {"lenet": tree_lenet_runs(train, lk, fdk, phase4)}
    out["lenet_against_packed"] = {s: tree_against_packed(lk, s)
                                   for s in ("flat", "phase4")}
    out["smollm"] = tree_lm_phase(train, lk, fdk, phase12)
    with tree_states(train):
        out["card_vs_cpu"] = train_card_vs_cpu(
            train, LM_CARD_CPU_ARGS + ["--optimizer", "lars"], "tree lars",
            LM_CARD_CPU_RTOL["lars"])
    out["pbt"] = pbt_phase(workdir, lk)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 18 wall time {out['phase_wall_s']:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    # the large steps (zamba2's f32 LARS at 24 layers) fit the card only
    # without the allocator's fragmentation (set before CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    stamps = []

    def phase(title: str) -> None:
        """Log a phase's title and note when it began."""
        stamps.append((title.split(".")[0].lstrip("= "),
                       time.perf_counter()))
        log(title)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, flash_decode as fdk
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch import serve, train

    phase("== 1. device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bw, flops = card_rates(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
        f"nvidia-smi: {smi}; {bw / 1e12} TB/s, {flops / 1e12} TFLOP/s f32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("== 2. build")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for src in sorted(libs):
        for kname, use in build.ptxas_usage(src).items():
            log(f"  ptxas {kname}: {use}")

    phase("== 3. kernels against their plain versions")
    kern, floor = kernel_phase(lk, bw, flops)
    fd_rows = flash_decode_phase(fdk, bw, flops)

    phase("== 4. main path: lenet-mnist, batch 8192, 20 steps")
    runs = main_phase(train, lk, fdk)

    phase("== 5. card against CPU: 5 LARS steps at batch 32")
    card_cpu = card_vs_cpu_phase(train)

    phase("== 6. checkpoint: 10 + 10 steps against 20, large-batch path")
    ckpt = checkpoint_phase(os.path.join(ROOT, "build"))

    phase("== 7. profile of main-path steps")
    prof = {path: profile_phase(path) for path in ("f32", "large_batch")}

    phase("== 8. serve: smollm-135m at full width, 32 slots, 64 requests")
    served = serve_phase(serve, fdk, lk)

    phase("== 9. serve, card against CPU: reduced smollm in f32")
    serve_cpu = serve_card_vs_cpu_phase(fdk)

    phase("== 10. serve profile: 5 decode ticks at full width")
    serve_prof = serve_profile_phase(fdk)

    phase("== 11. experiments: lars_vs_sgd_smoke and int8_parity_smoke")
    exp = experiment_phase(os.path.join(ROOT, "build"), lk)

    phase("== 12. LM training: smollm-135m at full width, lm_smoke")
    lm = lm_phase(train, lk, fdk, bw, flops, floor,
                  os.path.join(ROOT, "build"))

    # from here on a model's runs, sessions and serving in one phase share
    # one host draw of its init
    phase("== 13. the memory-lean LM path: smollm-135m's knobs, qwen3-14b "
          "at full width")
    with shared_inits():
        lean = lean_phase(train, lk, fdk, bw, flops, floor)

    phase(f"== 14. the MoE family: {GRANITE} trained at full width and "
          f"{GRANITE_LAYERS} layers, trained and served")
    with shared_inits():
        granite = granite_phase(train, serve, lk, fdk, bw, flops, floor)

    phase(f"== 15. MLA and masks: {DEEPSEEK} trained at every width, 2 "
          f"layers and 16 routed experts, served with all 160 at "
          f"{DEEPSEEK_SERVE_LAYERS}; sliding windows and the softcap in "
          f"training")
    with shared_inits():
        mla = mla_phase(train, serve, lk, fdk, bw, flops, floor,
                        lm["runs"]["lars"]["tokens_per_s"])

    phase(f"== 16. the SSM and hybrid families: {FALCON} trained and "
          f"served at full width and {SSM_LAYERS[FALCON]} layers, {ZAMBA} "
          f"at {SSM_LAYERS[ZAMBA]}")
    with shared_inits():
        ssm = ssm_phase(train, serve, lk, fdk, bw, flops, floor)

    phase(f"== 17. the encdec and vlm families: {WHISPER} whole, "
          f"{PALIGEMMA} at full width and {PALI_LAYERS} layers, trained "
          f"and served by DecodeEngine")
    with shared_inits():
        fam = family_phase(train, lk, fdk, bw, flops, floor)

    phase("== 18. the tree engine and PBT: tree-state LeNet and "
          "smollm-135m, launch.experiment --pbt on pbt_smoke")
    with shared_inits():
        tree = tree_phase(train, lk, fdk, runs, lm["runs"],
                          os.path.join(ROOT, "build"))
    stamps.append(("end", time.perf_counter()))
    phase_s = {a[0]: b[1] - a[1] for a, b in zip(stamps, stamps[1:])}
    log("phase wall times, s: " + ", ".join(f"{k}: {v:.1f}" for k, v in
                                            phase_s.items()))

    replaces = {"norms_flat": "src/repro/kernels/lars_kernels.py:49",
                "apply_flat": "src/repro/kernels/lars_kernels.py:86",
                "apply_flat_q8": "src/repro/kernels/lars_kernels.py:139"}
    entries = []
    grids = dict({g: exp[g] for g in EXP_GRIDS}, **{LM_GRID: lm[LM_GRID]})
    for kname, rows in kern.items():
        main_row = next(r for r in rows if r["rows"] == MAIN_ROWS)
        # the run on the kernel's own main path: f32 LARS for norms_flat
        # and apply_flat, the large-batch int8 path for apply_flat_q8
        int8 = kname == "apply_flat_q8"
        run = runs["lars_int8_bf16_accum8" if int8 else "lars"]
        in_step = prof["large_batch" if int8 else "f32"]
        launches = run["launches"][kname]
        entry = {
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lars_kernels.cu",
            "replaces": replaces[kname], "launches": launches,
            "launches_per_step": launches / MAIN_STEPS,
            "launches_by_run": {t: r["launches"][kname]
                                for t, r in runs.items()},
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "floor_ms": floor,
            "dispatch_ms": main_row["dispatch_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms_in_step": in_step["hand_kernel_device_ms_per_step"][
                kname]}
        if kname == "norms_flat":
            entry["fold_ms"] = main_row["fold_ms"]
        entry["launches_by_grid"] = {
            g: sum(c["launches"][kname] for c in r["cells"].values())
            for g, r in grids.items()}
        entry["launches_by_lm_run"] = {t: r["launches"][kname]
                                       for t, r in lm["runs"].items()}
        lm_row = lm["kernel_rows"][kname]
        entry["shapes"] = rows + [lm_row]
        entry["smollm_row"] = {
            "rows": LM_ROWS, "ms": lm_row["ms"], "bound_ms":
            lm_row["bound_ms"], "plain_ms": lm_row["plain_ms"],
            "library_ms": lm_row["library_ms"],
            "dispatch_ms": lm_row["dispatch_ms"],
            "max_abs_err": lm_row["max_abs_err"],
            "device_ms_in_lm_step": lm["profile"][
                "large_batch" if int8 else "f32"][
                "hand_kernel_device_ms_per_step"][kname]}
        if "fold_ms" in lm_row:
            entry["smollm_row"]["fold_ms"] = lm_row["fold_ms"]
        entry["launches_by_lean_run"] = {
            t: r["launches"][kname] for t, r in lean["smollm_runs"].items()}
        entry["launches_by_lean_run"].update(
            {"qwen3_" + t: r["launches"][kname]
             for t, r in lean["qwen_runs"].items()})
        q_row = lean["qwen_kernel_rows"][kname]
        entry["shapes"].append(q_row)
        entry["qwen3_row"] = dict(
            {k: v for k, v in q_row.items() if k.startswith("max_")},
            rows=QWEN_ROWS, ms=q_row["ms"], bound_ms=q_row["bound_ms"],
            plain_ms=q_row["plain_ms"], library_ms=q_row["library_ms"],
            dispatch_ms=q_row["dispatch_ms"],
            device_ms_in_qwen3_step=lean["qwen_session"]["profile"][
                "large_batch" if int8 else "f32"][
                "hand_kernel_device_ms_per_step"][kname])
        g_row = granite["kernel_rows"][kname]
        entry["shapes"].append(g_row)
        entry["granite_row"] = dict(
            rows=granite["rows"], ms=g_row["ms"], bound_ms=g_row["bound_ms"],
            plain_ms=g_row["plain_ms"], library_ms=g_row["library_ms"],
            dispatch_ms=g_row["dispatch_ms"],
            max_abs_err=g_row["max_abs_err"])
        if not int8:
            entry["granite_row"]["device_ms_in_granite_step"] = granite[
                "session"]["profile"]["hand_kernel_device_ms_per_step"][kname]
        entry["launches_by_granite_run"] = {
            t: r["launches"][kname] for t, r in granite["runs"].items()}
        d_row = mla["kernel_rows"][kname]
        entry["shapes"].append(d_row)
        entry["deepseek_row"] = dict(
            {k: v for k, v in d_row.items() if k.startswith("max_")},
            rows=mla["rows"], ms=d_row["ms"], bound_ms=d_row["bound_ms"],
            plain_ms=d_row["plain_ms"], library_ms=d_row["library_ms"],
            dispatch_ms=d_row["dispatch_ms"])
        if not int8:
            entry["deepseek_row"]["device_ms_in_deepseek_step"] = mla[
                "session"]["profile"]["hand_kernel_device_ms_per_step"][kname]
        entry["launches_by_deepseek_run"] = {
            t: r["launches"][kname] for t, r in mla["runs"].items()}
        entry["launches_by_mask_run"] = {
            t: r["launches"][kname] for t, r in mla["masks"]["runs"].items()}
        for arch, tag in ((FALCON, "falcon"), (ZAMBA, "zamba2")):
            s_row = ssm[arch]["kernel_rows"][kname]
            entry["shapes"].append(s_row)
            entry[f"{tag}_row"] = dict(
                {k: v for k, v in s_row.items() if k.startswith("max_")},
                rows=ssm[arch]["rows"], ms=s_row["ms"],
                bound_ms=s_row["bound_ms"], plain_ms=s_row["plain_ms"],
                library_ms=s_row["library_ms"],
                dispatch_ms=s_row["dispatch_ms"])
            if not int8:
                entry[f"{tag}_row"][f"device_ms_in_{tag}_step"] = ssm[arch][
                    "session"]["profile"]["hand_kernel_device_ms_per_step"][
                    kname]
            entry[f"launches_by_{tag}_run"] = {
                t: r["launches"][kname]
                for t, r in ssm[arch]["runs"].items()}
        p_row = fam[PALIGEMMA]["kernel_rows"][kname]
        entry["shapes"].append(p_row)
        entry["paligemma_row"] = dict(
            {k: v for k, v in p_row.items() if k.startswith("max_")},
            rows=fam[PALIGEMMA]["rows"], ms=p_row["ms"],
            bound_ms=p_row["bound_ms"], plain_ms=p_row["plain_ms"],
            library_ms=p_row["library_ms"],
            dispatch_ms=p_row["dispatch_ms"])
        if not int8:
            entry["paligemma_row"]["device_ms_in_paligemma_step"] = fam[
                PALIGEMMA]["session"]["profile"][
                "hand_kernel_device_ms_per_step"][kname]
        for arch, tag in ((WHISPER, "whisper"), (PALIGEMMA, "paligemma")):
            entry[f"launches_by_{tag}_run"] = {
                t: r["launches"][kname]
                for t, r in fam[arch]["runs"].items()}
        entries.append(entry)
    serve_row = fd_rows[0]                  # the serve path's shape
    ticks = served["decode_steps"]
    entries.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:85",
        "launches": served["launches"]["flash_decode"],
        "launches_per_tick": served["launches"]["flash_decode"] / ticks,
        "splits": serve_row["splits"],
        "max_abs_err": serve_row["max_abs_err"],
        "ms": serve_row["ms"], "kernel_ms": serve_row["ms"],
        "floor_ms": floor,
        "dispatch_ms": serve_row["dispatch_ms"],
        "plain_ms": serve_row["plain_ms"],
        "bound_ms": serve_row["bound_ms"],
        "bound_by": serve_row["bound_by"],
        "library_ms": serve_row["library_ms"],
        "device_ms_in_tick": serve_prof["flash_decode_ms_per_tick"],
        "granite_row": {k: granite["flash_decode_row"][k] for k in (
            "shape", "ms", "bound_ms", "plain_ms", "library_ms",
            "dispatch_ms", "max_abs_err", "splits")},
        "granite_serve_launches": granite["serve"]["launches"][
            "flash_decode"],
        "granite_serve_launches_per_tick": granite["serve"]["launches"][
            "flash_decode"] / granite["serve"]["decode_steps"],
        # MLA's absorbed decode is torch ops, as the reference's is jnp
        "deepseek_serve_launches": mla["serve"]["launches"]["flash_decode"],
        "zamba2_row": {k: ssm["flash_decode_row"][k] for k in (
            "shape", "ms", "bound_ms", "plain_ms", "library_ms",
            "dispatch_ms", "max_abs_err", "splits")},
        "zamba2_serve_launches": ssm[ZAMBA]["serve"]["launches"][
            "flash_decode"],
        "zamba2_serve_launches_per_tick": ssm[ZAMBA]["serve"]["launches"][
            "flash_decode"] / ssm[ZAMBA]["serve"]["decode_steps"],
        # Mamba layers are torch ops, as the reference's are jnp
        "falcon_serve_launches": ssm[FALCON]["serve"]["launches"][
            "flash_decode"],
        # the D 256 instance (paligemma: serve shape, decode_32k's
        # length) and whisper's cross-attention decode
        "paligemma_rows": [{k: r[k] for k in (
            "shape", "ms", "bound_ms", "plain_ms", "library_ms",
            "dispatch_ms", "max_abs_err", "splits", "ctas")}
            for r in fam["flash_decode_rows"][:2]],
        "whisper_row": {k: fam["flash_decode_rows"][2][k] for k in (
            "shape", "ms", "bound_ms", "plain_ms", "library_ms",
            "dispatch_ms", "max_abs_err", "splits", "ctas")},
        "d256_f32": fam["flash_decode_f32"],
        "nan_past_length_identical": fam["flash_decode_poison"],
        "ptxas_d256": fam["ptxas"],
        "paligemma_serve_launches": fam[PALIGEMMA]["serve"]["launches"][
            "flash_decode"],
        "paligemma_serve_launches_per_tick": fam[PALIGEMMA]["serve"][
            "flash_decode_per_tick"],
        "whisper_serve_launches": fam[WHISPER]["serve"]["launches"][
            "flash_decode"],
        "whisper_serve_launches_per_tick": fam[WHISPER]["serve"][
            "flash_decode_per_tick"],
        "device_ms_in_tick_by_model": {
            arch: fam[arch]["serve"]["profile"]["flash_decode_ms_per_tick"]
            for arch in (WHISPER, PALIGEMMA)},
        "shapes": fd_rows + [granite["flash_decode_row"],
                             ssm["flash_decode_row"]]
        + fam["flash_decode_rows"]})
    main_path = {tag: {k: r[k] for k in ("steps_per_s", "examples_per_s",
                                        "eval_accuracy", "train_s")}
                 for tag, r in runs.items()}
    log(json.dumps({"main_path": main_path, "card_vs_cpu_rel": card_cpu,
                    "checkpoint": ckpt, "profile": prof, "serve": served,
                    "serve_card_vs_cpu": serve_cpu,
                    "serve_profile": serve_prof, "experiments": exp,
                    "lm": lm, "lean": lean, "granite": granite,
                    "mla": mla, "ssm": ssm, "families": fam,
                    "tree": tree, "phase_wall_s": phase_s}))
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
