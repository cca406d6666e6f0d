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
             the length mask; ``flash_decode`` in f32 and bf16 at D 64
             and 128 with a zero-length row (which must give zeros); and
             its capped instances (the logit softcap, 30) in f32 and bf16
             at D 64, 128 and 256 against their plain version, with
             zero-length rows and NaN rows past each length kept out of
             the output, and timed at the serve shape beside its library
             call, one compiled ``flex_attention`` with the cap as its
             ``score_mod`` and the lengths as its block mask; its
             log-sum-exp instances (``lse=True``: an f32 output and each
             row's log-sum-exp, what the serving mesh's stripes merge by)
             at the serve shape (also capped), paligemma's D 256 (the
             wide kernel) and in f32 against their plain versions (lse
             within 1e-5 of max(|lse|, 1), -inf on an empty row), three
             stripes of the serve shape merged against the whole cache's
             one launch (f32 within 1e-5, bf16 one ulp), NaN past a
             stripe's lengths kept out, and timed at the serve shape and
             at a third of the D 128 shape's keys beside the instance
             without it and SDPA; the rows without lse are printed
             beside PERF.md's;
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
             32 requests (64 until the script needed the time for
             phase 20) with prompts of 256-2048 tokens and 32-256 new
             tokens, a Poisson arrival every tick: exactly 30
             ``flash_decode`` launches per decode tick and no LARS kernel,
             every request finished with finite logits, the allocator's
             peak kept for phase 19;
9. serve card vs CPU — reduced smollm in f32, as configured, with a
             window of 16 (prompts up to 30 tokens: a ring) and with the
             softcap (30): 16 teacher-forced decode steps, card (kernel)
             against CPU (plain version), logits within 1e-4; the
             engine's greedy tokens identical on both; no
             ``flash_decode`` launch during prefill;
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
             deterministic algorithms on and off (64 steps a run, ABCD
             DCBA); a profile of 50 of its
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
             losses; a profile of one full-width f32 LARS step fed by
             the loader (busy share, time by kernel, the H2D copies; the
             large-batch path's profile was cut for phase 20's time in
             PR 29); reduced smollm in f32, 20 steps of LARS and of LAMB
             on the card against the CPU; LeNet (LARS, batch 8192) and the
             reduced LM (LAMB) for 5 steps through ``ShardedLoader`` with
             prefetch and without, bit-identical; the registered
             ``lm_smoke`` grid through ``GridRunner`` (8 cells, 1,152
             steps) with its launches per cell, then its first cell run
             again, killed mid-cell and resumed to equal trajectories and
             rows;
13. lean LM — the memory-lean path (``flash_vjp``, ``attn_q_chunk``,
             ``loss_chunk``, ``remat_block``, set through ``--set``):
             first ``norms_flat``, ``apply_flat`` and ``apply_flat_q8``
             at qwen3-14b's packed shape (4329072, 512), on fresh buffers,
             timed beside their HBM bound and held against their plain
             versions (run on row chunks) on every row, the rows past
             element 2^31 reported apart; ``launch.train.main`` with
             smollm-135m at phase 12's 16 x 1024 and LARS, each knob alone
             and all four together, 2 steps each (one ``norms_flat`` and
             one ``apply_flat`` per step; steps/s, tokens/s, the
             allocator's peak), and a profile of one step with all four;
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
             its 2-layer superbuffer (rows from the layout), timed and
             held on every row as in phase 13, and ``flash_decode`` at its
             decode shape (B 32, S 4096, Hkv 8, G 3, D 64, bf16) timed as
             in phase 3; ``launch.train.main`` at full width, 2 of its 32
             layers (``--set num_layers=2``), 4 x 4096 tokens through
             phase 13's lean knobs, 3 steps each of f32 LARS and the
             large-batch path (one ``norms_flat`` and one ``apply_flat``
             or ``apply_flat_q8`` per step; finite losses, aux losses
             finite and nonzero; steps/s, tokens/s, the peak); from the
             same seed-0 init, the share of dropped slots at layer 0 for
             the first batch and a profiled f32 LARS step;
             ``launch.serve.main`` at full width and the same 2 layers
             (bf16), phase 8's 32 requests over 32 slots of capacity 4096:
             2 ``flash_decode`` launches per decode tick, none in
             admission, finite logits; reduced granite that drops slots
             (8 experts, top-2, capacity factor 0.5) in f32: 20 LARS
             steps card against CPU within 1e-5, 16 teacher-forced decode
             steps within 1e-4, greedy tokens identical;
15. MLA and masks — deepseek-v2-236b at every published width, 1 of its
             60 layers (2 until the script needed the time for phase 20)
             and 16 of its 160 routed experts (``--set num_layers=1
             --set num_experts=16``), 4 x 4096 tokens
             through ``flash_vjp``, ``attn_q_chunk=512``,
             ``loss_chunk=1024`` and remat: 3 steps each of f32 LARS and
             the large-batch path (one ``norms_flat`` and one
             ``apply_flat`` or ``apply_flat_q8`` per step; finite losses,
             aux losses finite and nonzero; tokens/s, the peak); from the
             same seed-0 init, layer 0's dropped share, its MLA attention
             and MoE block timed apart (forward and backward, CUDA
             events) and a profiled f32 LARS step; ``launch.serve.main``
             with all 160 experts at 1 layer (bf16), phase 8's traffic
             with 8 new tokens a request: no ``flash_decode`` launch (the
             absorbed decode is torch ops), every request finished,
             finite logits, the decode
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
             1-layer and zamba2-7b's 7-layer superbuffers, on fresh
             buffers, held on every row and timed
             as in phase 13, and ``flash_decode`` at zamba2's decode shape
             (B 32, S 4096, Hkv 32, G 1, D 112, bf16) timed as in phase 3;
             then for each model at full width and that depth (``--set
             num_layers=1`` / ``7``), 4 x 4096 tokens through phase 13's
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
             paligemma-3b at full width and 5 of its 18 layers (4 x 4096
             text tokens behind 256 seeded normal image embeddings, where
             the reference's zero stub overflows the gradient from 16,
             through ``flash_vjp``,
             ``attn_q_chunk=1088`` and ``loss_chunk=1024``): 3 steps each
             of f32 LARS and the large-batch path through
             ``launch.train.main`` (one ``norms_flat`` and one
             ``apply_flat`` or ``apply_flat_q8`` per step; tokens/s,
             whisper's frames/s, the peak) and a profiled f32 step;
             ``DecodeEngine`` at the same width and depth (bf16): 32
             requests (whisper: 4 prompt tokens over 1,500 seeded frames;
             paligemma: 64 behind 256 seeded image embeddings), 128 new
             tokens: 12 (whisper: self- and cross-attention) or 5
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
             trajectory identical;
19. serve stack — ``launch.serve.main`` with smollm-135m at full width
             (30 layers, bf16), 32 slots of 4096, ``--prefill-chunk 512
             --prefix-entries 16 --slos 0:0.5:30,1:5:120 --min-slots 8
             --reserve-slots 1``: a session run (8 sessions, 2 turns over
             a 1,024-token system prompt) and the report's ``bursty_32``
             scenario (31 tier-1 requests holding every slot but the
             reserved one, and 4 pairs of tier-0 ones, over a 9 s
             window), both through phase 8's gates:
             every request finished with finite logits, one
             ``decode_step`` call a decode tick with exactly 30
             ``flash_decode`` launches and none in chunk admission,
             restore or snapshot, prefix hits on the session run,
             preemptions under the burst, the allocator's peak at most
             phase 8's plus the prefix store's bytes plus 1 GiB; tokens/s,
             TTFT and latency p50/p99 by tier, tick ms and occupancy beside
             phase 8's; a sliding window of 256 rows served at full width
             (prompts longer than it: a ring; 30 launches a tick); each
             serve family reduced in f32 (qwen3-14b, deepseek-v2-236b,
             falcon-mamba-7b, zamba2-7b) through the chunked engine with
             the prefix store and forced preemptions, on the CPU and the
             card: greedy tokens identical, chunked equal to monolithic
             on the card (a preempted stream equal to its uninterrupted
             run); ``launch.serve_experiment --grid serve_slo_smoke``
             into ``build/serve_grid/``, gated on its decode contract,
             its claims A1–A3 logged;
20. data parallelism, ZeRO and tensor parallelism — (a) two ranks on the one card (this
             file run as ``--zero-rank R 2 DIR``, gloo over a file store:
             NCCL refuses two ranks on one device; gloo's all-gather and
             reduce-scatter of CUDA tensors go through pinned host
             memory, counted), each with its tensors on ``cuda:0``, a
             ``2x1`` mesh and ``TrainPipeline(zero=True)`` and then
             ``zero=False`` through ``ShardedLoader(mesh=)``: LeNet at
             batch 1024, 20 steps, f32 and int8 LARS momentum, and
             smollm-135m at full width (263,144 rows padded to 263,152:
             131,576 a rank), 3 steps of 16 x 1024 tokens, f32 LARS;
             every step of every rank exactly one ``norms_flat`` and one
             ``apply_flat``/``apply_flat_q8``, each on the rank's own
             rows; ZeRO bit-identical to replicated (losses and every
             parameter); each against the same run alone on the card:
             losses within ``MESH_RTOL`` (5e-3, the reference's), and
             each rank's final params within 1e-2 of the change of the
             run alone split into 2 microbatches as the ranks split the
             batch (over the whole parameter vector; an unchanged state
             reads 1.0), both ranks' params equal; slot bytes a rank
             half the padded rows', pad rows zero and int8 pad scales
             1.0; the allocator's peaks, step ms and the share in
             collectives (CUDA events around each, no sync added)
             printed; (b) ``launch.train --mesh 1x1 --zero`` on reduced
             smollm (a cut in width: the full width's time goes to two
             1.6 GB checkpoints) under ``torchrun --standalone
             --nproc-per-node 1`` (NCCL), started with (a)'s and (c)'s
             ranks: its checkpoint equal, member for member, to the
             same run's without a mesh; (c) tensor parallelism: three
             ranks on the card (``--tp-rank R 3 DIR``, gloo, started
             with (a)'s, so each mesh's step ms is taken beside the
             other's processes), a ``1x3`` mesh,
             smollm-135m at full width and depth (every attention, MLP
             and vocabulary split head-aligned over 3), (a)'s smollm
             run: the ranks' losses equal, every replicated leaf
             bit-identical across them, one ``norms_flat`` and one
             ``apply_flat`` a step a rank on the global 263,144 rows,
             the gathered final params within ``TP_PARAM_RTOL`` of the
             change of (a)'s run alone at one microbatch (same init and
             batches), losses within ``MESH_RTOL``; step ms, the share
             in collectives, bytes all-reduced and all-gathered a step,
             host-staged copies and each rank's peak against the run
             alone's printed; (d) ``norms_flat``, ``apply_flat`` and
             ``apply_flat_q8`` timed as in phase 3 on a shard's rows:
             smollm-135m's 131,576 and qwen3-14b's 2,164,536; (e) the
             serving mesh in (c)'s ranks after their training:
             ``launch.serve --mesh 1x3`` on reduced smollm (f32, a
             48-row cache: prompts span its stripes; greedy tokens
             identical to the run alone on the card) and on smollm-135m
             whole (bf16, 32 slots of 1,536 rows, 512 a stripe, 32
             requests of 520-1,450 prompt tokens, 8 new): every request
             finished with finite logits, 30 ``flash_decode`` launches a
             tick a rank (the lse instance on its stripe) and none
             outside the ticks, the ranks' scheduler digests and tokens
             equal; the share of requests whose tokens equal the run
             alone's, tick ms, the share of a tick in collectives, bytes
             a tick and the peaks printed; (f) the moe family on meshes,
             in (a)'s ranks after their runs, on their ``2x1`` mesh and a
             ``1x2`` mesh of the same two processes: granite-moe-3b-a800m
             at full width and 1 of 32 layers, 2 f32 LARS steps of 2 x
             4096 tokens (``2x1``: each global batch routed over
             ``data``; ``1x2``: its 40 experts split, 20 a rank), each
             against the same run alone on the card: step 0 layer 0's
             kept (token, expert) slots differing in under 1 % of the run
             alone's, losses within 2e-4, one ``norms_flat`` and one
             ``apply_flat`` a step a rank on the global rows, the router
             and the norm scales bit-identical across ``1x2``'s ranks;
             step ms, the share in collectives and the peaks printed;
             then ``launch.serve --mesh`` on both meshes: reduced granite
             with drops (f32; greedy tokens identical to the run alone)
             and granite at full width and 1 layer (bf16; phase 8's
             traffic, 8 new tokens): one ``flash_decode`` a layer a tick
             a rank (the lse instance on ``1x2``'s stripes), none outside
             the ticks, digests equal, the share of requests whose
             tokens equal the run alone's printed; (g) MLA on meshes, in
             two processes of its own (``--mla-mesh-rank``) started once
             every other rank of the phase has ended (each needs ~37
             GiB), on a ``1x2`` mesh: deepseek-v2-236b at full width, 1 layer
             and 16 routed experts (its 128 heads 64 a rank), 2 f32 LARS
             steps of 4 x 4096 tokens through ``launch.train --mesh
             1x2``, held against phase 15's own f32 LARS run: losses
             within 2e-4, step 0 layer 0's kept slots differing in under
             1 %, one ``norms_flat`` and one ``apply_flat`` a step a rank
             on the global rows, the down projections, their norms, the
             router and the norms bit-identical across the ranks (step
             ms, the share in collectives, the bytes handed to them and
             the peaks printed); ``launch.serve --mesh 1x2`` on reduced
             deepseek with a query rank of 48 and drops (f32, a 48-row
             latent cache in two stripes; greedy tokens identical to the
             run alone) and on phase 15's full-width serving run (every
             request finished with finite logits, no ``flash_decode``
             launch, digests equal, the share of requests whose tokens
             equal phase 15's printed), the first tick's layer 0 on each
             rank (each stripe's out_lat and lse, the merged latent)
             against the plain absorbed decode within MLA_MERGE_TOL.
             (a)'s and (f)'s runs alone, and (e)'s and (g)'s reduced
             serving runs alone, run in this process beside the ranks.
             The phases' wall times are printed at the end.

From phase 13 on, a model's seeded init is drawn once per phase and
shared by its training runs, sessions and serving (``shared_inits``:
below 0.5 B parameters on the host, the values of a fresh init; the
larger full-width cuts on the card, from a generator seeded by the
host's).

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
GRAPH_CALLS = {272: 100, 65536: 10, 131576: 5,    # calls per timed graph
               263144: 5}
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
FD_CALLS = {448: 50, 1500: 20, 4095: 20, 4096: 20, 10923: 10,
            32768: 5}                          # calls per timed graph
# the kernel sums in another order than its plain version (an online
# rescale per tile of keys, a merge of warps and of splits): f32 agrees to a few ulp of values of order
# one; bf16 outputs round the same f32 result, so one bf16 ulp (2^-7
# relative) may separate them
FD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-6)}
# the logit softcap at decode: the capped instances held at FD_TOL at
# D 64, 128 and 256 (G 3, 5 and 8), and timed at the serve shape
SOFTCAP = 30.0
FD_CAP_SHAPES = [(64, 3, 3), (128, 8, 5), (256, 1, 8)]
# flash_decode's log-sum-exp instances (the serving mesh runs them on
# each rank's stripe of the KV cache): held against their plain versions
# (out at FD_TOL, lse at FD_LSE_RTOL of max(|lse|, 1), -inf exactly on an
# empty row) at phase 8's serve shape (the mma kernel, D 64; also
# capped), paligemma's (the wide kernel, D 256), in f32 (the SIMT
# kernel, D 64 and 128) and at the two stripes phase 20 (e) gives it:
# smollm-135m's full-width stripe (bf16, 512 rows: two splits of 256)
# and reduced smollm's (f32, 16 rows, D 72); each with lengths 0, 1,
# S/2, S/2 + 1, S and past S in its first rows: (shape, dtype, softcap)
FD_LSE_CHECKS = [((32, 4096, 3, 3, 64, "drawn"), "bfloat16", 0.0),
                 ((32, 4096, 3, 3, 64, "drawn"), "bfloat16", SOFTCAP),
                 ((32, 448, 1, 8, 256, "edges"), "bfloat16", 0.0),
                 ((8, 4096, 3, 3, 64, "drawn"), "float32", 0.0),
                 ((8, 4096, 8, 5, 128, "drawn"), "float32", 0.0),
                 ((32, 512, 3, 3, 64, "drawn"), "bfloat16", 0.0),
                 ((4, 16, 1, 4, 72, "drawn"), "float32", 0.0)]
FD_LSE_RTOL = 1e-5
# three stripes of the serve shape (4,095 keys: 1,365 a stripe), merged,
# against the whole cache's one launch
FD_STRIPES = (3, 1365)
# timed: the lse instance at the serve shape and at a third of
# decode_32k's S, beside the instance without it on the same inputs
FD_LSE_TIMED = [(32, 4096, 3, 3, 64, "drawn"), (8, 10923, 8, 5, 128, "full")]
# the rows without lse as PERF.md section 6 keeps them (NVIDIA H100
# 80GB HBM3 at 700 W): this run's are logged beside them
FD_PERF_MS = {4096: 0.02608, 32768: 0.38031}
# phase 8's traffic, also served by phases 14-16: 32 requests (64 until
# the script needed the time: it ran 1,294 s on a slower H100 host)
SERVE_ARGS = ["--arch", "smollm-135m", "--slots", "32", "--capacity", "4096",
              "--requests", "32", "--prompt-min", "256", "--prompt-max",
              "2048", "--new-min", "32", "--new-max", "256",
              "--arrival-every", "1", "--seed", "0"]
# reduced smollm, card vs CPU: only f32 summation orders differ
SERVE_CARD_CPU_ATOL = 1e-4
# phase 9 also serves reduced smollm in f32 with a window of 16 (prompts
# up to 30 tokens: a ring) and with the softcap
SERVE_MASKS = {"window": {"sliding_window": 16},
               "softcap": {"attn_logit_softcap": SOFTCAP}}

# phase 11: the registered grids it runs; the kill lands in the smoke
# grid's second cell (lars-b64, 256 steps, after sgd-b64's 256) at its
# step 110, past its step-100 checkpoint
EXP_GRIDS = ("lars_vs_sgd_smoke", "int8_parity_smoke")
EXP_KILL_AFTER = 256 + 110
EXP_PROFILE_STEPS = 50
# steps of each timed run of the b64 LARS cell (stats and deterministic
# on and off, ABCD DCBA)
EXP_TIMING_STEPS = 64

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
# the registered lm_smoke grid: the killed run holds its first cell only
# (phase 11 kills and resumes a whole grid, a finished cell skipped on
# resume); the kill lands in lamb-b16 (256 steps) at its step 110, past
# its step-100 checkpoint
LM_GRID = "lm_smoke"
LM_KILL_AFTER = 110

# phase 13: the memory-lean LM path. smollm-135m at phase 12's 16 x 1024
# with LARS, each knob alone and then all four, through --set
LEAN_RUNS = {
    "flash_vjp": ["flash_vjp=true"],
    "flash_vjp_q512": ["flash_vjp=true", "attn_q_chunk=512"],
    "loss_chunk": ["loss_chunk=1024"],
    "remat_block": ["remat_block=5"],
    "all_four": ["flash_vjp=true", "attn_q_chunk=512", "loss_chunk=1024",
                 "remat_block=5"]}
# each knob run takes 2 steps (phase 12's runs take LM_STEPS) to keep the
# script within its time limit beside phase 20
LEAN_STEPS = 2
LEAN_ARGS = ["--arch", "smollm-135m", "--batch", "16", "--seq", "1024",
             "--steps", str(LEAN_STEPS), "--lr", "0.01", "--log-every", "0"]
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
# verbatim) at full width, depth cut to 2 of its 32 layers (f32 LARS at
# 32 would not fit the card; 16 ran until the script needed the time for
# phase 16, 8 and then 4 until it needed it for phase 19), 4 x 4096
# tokens a step through
# phase 13's lean knobs: f32 LARS and the large-batch path, as qwen3's
# runs
GRANITE = "granite-moe-3b-a800m"
GRANITE_LAYERS = 2
GRANITE_STEPS = 3
GRANITE_ARGS = ["--arch", GRANITE, "--set", f"num_layers={GRANITE_LAYERS}"] \
    + [a for v in QWEN_LEAN for a in ("--set", v)] + [
    "--batch", "4", "--seq", "4096", "--steps", str(GRANITE_STEPS),
    "--lr", "0.01", "--log-every", "0"]
# served at the same cut (bf16; full depth until the script needed the
# time for phase 16): 32 slots of capacity 4096,
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
# verbatim) at every published width, trained at 1 of its 60 layers and
# 16 of its 160 routed experts (at 2 layers 2,196,537,344 parameters; one
# layer's 160 experts are 3.77 B parameters, which f32 LARS could not
# hold on the card beside the rest; cut from 2 layers to 1 to keep the
# script within its time limit beside phase 20), 4 x 4096 tokens a step
# through flash_vjp, attn_q_chunk=512, loss_chunk=1024 and remat: f32
# LARS and the large-batch path, as qwen3's runs
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_LAYERS = 1
DEEPSEEK_CUT = [f"num_layers={DEEPSEEK_LAYERS}", "num_experts=16"]
DEEPSEEK_LEAN = ["flash_vjp=true", "attn_q_chunk=512", "loss_chunk=1024"]
DEEPSEEK_STEPS = 3
DEEPSEEK_BATCH = 4
DEEPSEEK_ARGS = ["--arch", DEEPSEEK] + [
    a for v in DEEPSEEK_CUT + DEEPSEEK_LEAN for a in ("--set", v)] + [
    "--batch", str(DEEPSEEK_BATCH), "--seq", "4096", "--steps",
    str(DEEPSEEK_STEPS), "--lr", "0.01", "--log-every", "0"]
# served at every width with all 160 experts, 1 of 60 layers
# (5,020,680,192 parameters, bf16; cut from 2 to keep the script within its
# time limit), phase 8's traffic over a latent cache with 8 new tokens a
# request (32-256 until phase 20 (g) held its 1x2 mesh against this run:
# the same traffic, paid for by this run's shorter decode), its weights
# drawn on the card from DEEPSEEK_SERVE_DRAW
DEEPSEEK_SERVE_LAYERS = 1
DEEPSEEK_SERVE_ARGS = ["--arch", DEEPSEEK, "--set",
                       f"num_layers={DEEPSEEK_SERVE_LAYERS}"] \
    + SERVE_ARGS[2:] + ["--new-min", "8", "--new-max", "8"]
DEEPSEEK_SERVE_DRAW = 15
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
# qwen3's runs. falcon-mamba-7b at 1 of its 64 layers, zamba2-7b at 7 of
# its 81 (the shared block after layers 0 and 6: still two applications).
# Both are served at the same cut with phase 8's traffic. Both trained at
# 16 and 24 layers, and at 8 and 12, too (PERF.md); the cut keeps the
# script within its time limit beside phases 17 and 19.
FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
SSM_LAYERS = {FALCON: 1, ZAMBA: 7}
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
# paligemma-3b at full width and 5 of its 18 layers (all 18, then 9,
# until the script needed the time for phase 19), 4 x 4,096 text tokens
# behind its
# 256 image tokens (4,352
# positions a row) through flash_vjp, query chunks of 1,088 (a divisor of
# 4,352) and loss_chunk=1024; f32 LARS and the large-batch path. Its image
# stub is seeded unit normals where launch.train feeds the reference's
# zeros: a zero prefix stays zero through every layer, rmsnorm's gradient
# there is 1 / sqrt(eps), and it compounds through the prefix's
# attention until the gradient overflows from 16 layers on, in the
# reference as in the port (tests/test_torch_vlm.py)
PALI_LAYERS = 5
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


# phase 19: the serve stack. smollm-135m at full width through
# launch.serve with chunked prefill (chunks of 512), a 16-entry prefix
# store, two SLO tiers (tier 0: TTFT 0.5 s, latency 30 s; tier 1: 5 s,
# 120 s), slot autoscaling from 8 and one slot reserved for tier 0, over
# 32 slots of 4096: a session run (8 sessions, 2 turns over a 1,024-token
# system prompt: the second turn hits the first's retirement snapshots)
# and the report's bursty_32 shape, sized so that preemption does not
# hang on the host's speed: its tier-1 burst (31 requests of 512 prompt
# tokens and 128 new ones: every slot but the reserved one) arrives over
# the first 1.4 s of a 9 s window, slot autoscaling admits it one
# request a tick, and it holds the slots for 128 ticks more; of the 4
# pairs of tier-0 requests the last three land at 22.5, 45 and 67.5 %
# (2.0, 4.05 and 6.1 s). A pair that finds every slot held waits past
# 0.25 s (half its TTFT budget) and preempts. On the card it preempted
# 5, 10, 14 and 17 times (ticks of 57-90 ms), where 2 pairs preempted
# 1-5 times and the shapes tried before once or never.
STACK_PREFIX_ENTRIES = 16
STACK_ARGS = ["--arch", "smollm-135m", "--slots", "32", "--capacity",
              "4096", "--prefill-chunk", "512", "--prefix-entries",
              str(STACK_PREFIX_ENTRIES), "--slos", "0:0.5:30,1:5:120",
              "--min-slots", "8", "--reserve-slots", "1", "--seed", "0"]
STACK_SESSIONS, STACK_TURNS = 8, 2
STACK_SESSION = ["--session", str(STACK_SESSIONS), "--turns",
                 str(STACK_TURNS), "--shared-prefix", "1024",
                 "--prompt-min", "64", "--prompt-max", "512", "--new-min",
                 "16", "--new-max", "48"]
STACK_BURSTY = ["--scenario", "bursty_32", "--time-scale", "9.0"]
STACK_BURSTY_REQUESTS = 39
# a sliding window of 256 rows at full width, prompts longer than it
STACK_WINDOW_REQUESTS = 16
STACK_WINDOW_ARGS = SERVE_ARGS + [
    "--set", "sliding_window=256", "--requests", str(STACK_WINDOW_REQUESTS),
    "--prompt-min", "300", "--prompt-max", "1200", "--new-min", "16",
    "--new-max", "64"]
# each serve family reduced in f32 through the chunked engine, card
# against CPU (zamba2 at 3 layers: its shared block after 0 and 2); tier
# 0's TTFT budget puts it at risk at once, so it preempts
STACK_FAMILIES = {"qwen3-14b": {}, DEEPSEEK: {}, FALCON: {},
                  ZAMBA: {"num_layers": 3}}
STACK_SLOS = {0: (1e-6, 10.0), 1: (10.0, 60.0)}


# phase 20: data parallelism and ZeRO. Two ranks on the one card over
# gloo (NCCL refuses two ranks on one device): LeNet at batch 1024, 20
# steps, f32 and int8 LARS momentum, and smollm-135m at full width, 3
# steps of 16 x 1024 tokens, each with ZeRO and replicated, against the
# same run alone; one rank under torchrun over NCCL and (c)'s three
# ranks started at the same time; then the LARS kernels on a shard's
# rows
ZERO_RANKS = 2
ZERO_RUNS = ("lenet_f32", "lenet_int8", "smollm_f32")
ZERO_LENET = (1024, 20)                  # global batch, steps
ZERO_LM = (16, 1024, 3)                  # global batch, seq, steps
# smollm-135m's 263144 rows padded to a multiple of 2 * 8; a rank's half;
# qwen3-14b's (4329072, 512) over two ranks
ZERO_LM_ROWS = 263152
ZERO_SHARD_ROWS = {"smollm": ZERO_LM_ROWS // ZERO_RANKS,
                   "qwen3": 4329072 // ZERO_RANKS}
# the reference's data-parallel mesh tolerance (tests/test_golden.py:73)
ZERO_MESH_RTOL = 5e-3
# a rank's final params against the run alone with the batch split as
# the ranks split it: ||rank - alone|| / ||alone - init|| over the whole
# parameter vector, which a rank that never updated reads as 1.0
ZERO_PARAM_RTOL = 1e-2
ZERO_JOIN_S = 300
# (b): reduced smollm, f32 LARS (deterministic on the card without
# cuDNN). A cut in width: at full width most of its ~40 s went to writing
# and reading two 1.6 GB checkpoints, which the script's time limit
# cannot spare
ZERO_NCCL_ARGS = ["--arch", "smollm-135m", "--reduced", "--batch", "8",
                  "--seq", "64", "--steps", "5", "--lr", "0.01",
                  "--log-every", "0", "--optimizer", "lars"]
# (c): tensor parallelism. Three ranks on the card over gloo, a 1x3 mesh:
# smollm-135m's 9 heads and 3 KV heads, its MLP's 1536 and its vocabulary
# of 49152 all split evenly (head-aligned) over 3 ranks; zero_spec's
# smollm run (init seed 0, 16 x 1024 tokens, 3 f32 LARS steps), held
# against the run alone of (a)'s gates (one microbatch, same init and
# batches). The packed state is the global one: 263,144 rows a rank
TP_RANKS = 3
TP_ROWS = 263144
# the ranks' gathered final params against the run alone,
# ||tp - alone|| / ||alone - init|| over the whole vector (an unchanged
# state reads 1.0). smollm's params are bf16: the split products'
# partial sums are added over the ranks in bf16 (as the reference's
# GSPMD adds them) and a weight moves ~3e-5 of itself a step, under a
# bf16 ulp, so a rounding that lands elsewhere flips a whole ulp.
# Measured on an H100: 0.0839 (worst leaf 0.142, layers/attn/wk); the
# same run alone split into two microbatches reads 0.070 against it
TP_PARAM_RTOL = 0.25
# (e): the serving mesh, in (c)'s three ranks after their training,
# through launch.serve --mesh 1x3, each run against the same run alone
# on the card: reduced smollm (f32) on a 48-row cache (16 rows a stripe,
# prompts of 17-40 tokens: two stripes or three), greedy tokens gated
# identical; smollm-135m whole in bf16, 32 slots of 1,536 (512 rows a
# stripe), 32 requests of 520-1,450 prompt tokens (each spans two
# stripes or more) and 8 new (cut from 32 for the script's time: a tick
# took 614-823 ms a rank on an H100 over gloo), greedy: every request
# finished, finite logits, 30 flash_decode launches a tick a rank (its
# lse instance, one a layer) and none outside the ticks, the ranks'
# scheduler digests equal; in both runs the first tick's layer 0 on
# every rank against the plain version (each stripe's out and lse, the
# merged output against the whole cache's); its tokens' agreement with
# the run alone (bf16 sums differ under tensor parallelism), tick ms,
# the tick's share in collectives and the bytes a tick logged
SERVE_MESH_ARGS = {
    "reduced": ["--arch", "smollm-135m", "--reduced", "--slots", "4",
                "--capacity", "48", "--requests", "6", "--prompt-min", "17",
                "--prompt-max", "40", "--new-min", "8", "--new-max", "8",
                "--arrival-every", "1", "--prefill-bucket", "1", "--seed",
                "0"],
    "full": ["--arch", "smollm-135m", "--slots", "32", "--capacity", "1536",
             "--requests", "32", "--prompt-min", "520", "--prompt-max",
             "1450", "--new-min", "8", "--new-max", "8", "--arrival-every",
             "0", "--prefill-bucket", "64", "--seed", "0"]}
# (f): the moe family on meshes, in (a)'s two ranks after their runs, on
# a 2x1 mesh (each global batch's routing taken over data: the slots
# counted per expert, the counts all-gathered) and on a second mesh of
# the same two processes, 1x2 (expert parallelism: granite's 40 experts,
# 20 a rank; the router and norms whole). Training: granite-moe-3b-a800m
# at full width, 1 of its 32 layers, f32 LARS, 2 steps of 2 x 4096
# tokens, each mesh against the same run alone on the card: at step 0
# layer 0 the kept (token, expert) slots (~30 % drop at this width) may
# differ in MOE_MESH_SLOT_SHARE of the run alone's (near-ties in the
# router may flip), the losses within MOE_MESH_LOSS_RTOL (the reference's
# own mesh tolerance, tests/test_pipeline.py:284-289), one norms_flat and
# one apply_flat a step a rank on the global rows, every replicated leaf
# (the router, the norm scales) bit-identical across 1x2's ranks.
# Serving, through launch.serve --mesh on both meshes: reduced granite
# with drops (f32; 4 slots of 48 rows), greedy tokens identical to the
# run alone; granite at full width and 1 layer (bf16; phase 8's traffic
# with 8 new tokens, as (e)): every request finished with finite logits,
# one flash_decode a layer a tick a rank (the lse instance on 1x2's
# stripes) and none outside the ticks, the ranks' digests equal; the
# share of requests whose tokens equal the run alone's printed
MOE_MESHES = ("2x1", "1x2")
MOE_MESH_LAYERS = 1
MOE_MESH_TRAIN = (2, 4096, 2)           # global batch, seq, steps
MOE_MESH_SLOT_SHARE = 0.01
MOE_MESH_LOSS_RTOL = 2e-4
MOE_MESH_SERVE = {
    "moe_reduced": ["--arch", GRANITE, "--reduced"]
    + [a for k, v in GRANITE_DROP.items() for a in ("--set", f"{k}={v}")]
    + SERVE_MESH_ARGS["reduced"][3:],
    "moe_full": ["--arch", GRANITE, "--set", f"num_layers={MOE_MESH_LAYERS}",
                 "--slots", "32", "--capacity", "4096", "--requests", "32",
                 "--prompt-min", "256", "--prompt-max", "2048", "--new-min",
                 "8", "--new-max", "8", "--arrival-every", "0",
                 "--prefill-bucket", "64", "--seed", "0"]}
# (g): MLA on meshes, in two ranks of its own started once the phase's
# other ranks have ended (each holds deepseek's whole packed f32 LARS
# state and its update's buffers: ~37 GiB), on a 1x2 mesh
# (deepseek's 128 heads split 64 a rank, its 16 routed experts 8 a rank;
# q_down, kv_down, their norms and the router whole). Training: phase
# 15's f32 LARS run (full width, 1 layer, 16 routed experts, 4 x 4096
# tokens, the lean knobs, seed 0) through launch.train --mesh 1x2 for
# MLA_MESH_STEPS steps, held against phase 15's run itself (its first
# losses and step 0 layer 0's kept slots: the run alone costs no time of
# its own): losses within MOE_MESH_LOSS_RTOL, kept slots within
# MOE_MESH_SLOT_SHARE, one norms_flat and one apply_flat a step a rank
# on the global rows, the replicated leaves bit-identical across the
# ranks. Serving through launch.serve --mesh 1x2: reduced deepseek with a
# query rank of 48 and granite's drops (f32; 4 slots of 48 rows: two
# stripes of 24), greedy tokens identical to the run alone; phase 15's
# full-width run (all 160 experts, 1 layer, bf16, phase 8's traffic with
# 8 new tokens, the same card draw), held against phase 15's: every
# request finished with finite logits, no flash_decode launch, digests
# equal; the first tick's layer 0 on each rank (each stripe's out_lat
# and lse, the merged latent) against the plain absorbed decode
MLA_MESH = "1x2"
MLA_MESH_STEPS = 2
# each rank's share of the card (38.0 GiB of an H100's 79.18): a rank
# peaked at 37,382.4 MiB allocated before the step dropped its packed
# gradient ahead of cutting the blocks (~6 GiB less at that point since);
# without a share one rank's cached blocks starved the other (the card
# full while the failing rank held 26.1 GiB)
MLA_MESH_CARD_SHARE = 0.48
MLA_MESH_TRAIN = DEEPSEEK_ARGS + QWEN_RUNS["lars"] + [
    "--steps", str(MLA_MESH_STEPS), "--mesh", MLA_MESH]
MLA_MESH_SERVE = {
    "mla_reduced": ["--arch", DEEPSEEK, "--reduced"]
    + [a for k, v in dict(GRANITE_DROP, **DEEPSEEK_Q_LORA).items()
       for a in ("--set", f"{k}={v}")] + SERVE_MESH_ARGS["reduced"][3:],
    "mla_full": DEEPSEEK_SERVE_ARGS}
# each stripe's (out_lat, lse) and the merged latent against the plain
# absorbed decode (masked softmax over the stripe, or over the whole
# latent cache), all in f32: (rtol, atol). Measured on an H100 at full
# width (a bf16 cache of 32 x 4096 rows, 128 heads): 4.3e-7 on a stripe,
# 4.0e-7 merged, the lse exact
MLA_MERGE_TOL = (1e-5, 1e-5)

# Published HBM bandwidth (B/s) and f32 non-tensor-core peak (FLOP/s), by
# the name nvidia-smi reports (NVIDIA data sheets).
CARDS = [("H100 NVL", 3.9e12, 60e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


_STARTED = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a line that is not a JSON object ends with the
    seconds since the script started, to show where its time goes."""
    if not msg.startswith("{"):
        msg = f"{msg}  [{time.perf_counter() - _STARTED:.1f} s]"
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
    """Within the block, each model's seeded init is drawn once and kept
    on the host: a later init for the card of the same param shapes from
    a generator in the same state moves the kept copy there, so a
    phase's training runs, sessions and serving of one model share one
    draw. A model of fewer than CARD_DRAW_ELEMENTS parameters draws on
    the host, the values of a fresh init (the card's casts round as the
    host's do), as the card-against-CPU runs and the ranks of phase 20
    need; a larger one (the full-width cuts, which no CPU run meets)
    draws its normals on the card from a CUDA generator seeded by the
    host generator's state (``card_draws``): other values than a fresh
    init's, the same for every init in the block, in seconds where the
    host takes 16-19 s per 2.2 B parameters. Inits for the CPU or the
    meta device draw as before."""
    import hashlib
    import torch
    from repro_torch.models import EncDecModel, LanguageModel
    from repro_torch.treepath import tree_flatten_with_path, tree_map
    memo: dict = {}
    saved = {cls: cls.init for cls in (LanguageModel, EncDecModel)}

    def wrap(inner):
        def init(self, generator, device):
            if torch.device(device).type != "cuda" or _CARD_DRAWS:
                return inner(self, generator, device)
            shapes = tuple((path, tuple(t.shape), t.dtype) for path, t in
                           tree_flatten_with_path(inner(
                               self, torch.Generator(), "meta"))[0])
            state = generator.get_state().numpy().tobytes()
            key = (shapes, state)
            if key not in memo:
                if sum(math.prod(s) for _, s, _ in shapes) \
                        < CARD_DRAW_ELEMENTS:
                    memo[key] = inner(self, generator, "cpu")
                else:
                    seed = int.from_bytes(
                        hashlib.sha256(state).digest()[:7], "little")
                    with card_draws(seed):
                        memo[key] = tree_map(lambda t: t.cpu(), inner(
                            self, generator, device))
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


_CARD_DRAWS: list = []
# shared_inits draws a model of this many parameters or more on the card
CARD_DRAW_ELEMENTS = 500_000_000


@contextlib.contextmanager
def card_draws(seed: int):
    """Within the block an init for the card draws its normals there,
    from one CUDA generator seeded ``seed``: other values than the
    host's, for a model no CPU run is held against (deepseek served
    with all 160 experts: 9.0 B normals, ~35 s on the host).
    ``shared_inits`` steps aside inside it."""
    import torch
    from repro_torch.models import layers as L
    inner = L._normal
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(g, shape, std, dtype, device):
        if torch.device(device).type != "cuda":
            return inner(g, shape, std, dtype, device)
        return torch.randn(shape, generator=gen, device=device).mul_(
            std).to(dtype)

    L._normal = normal
    _CARD_DRAWS.append(gen)
    try:
        yield
    finally:
        L._normal = inner
        _CARD_DRAWS.pop()


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


def _fd_err(fdk, q, k, v, lens, dtype_name, softcap: float = 0.0
            ) -> tuple[float, float]:
    """(max abs err, max rel err) of the kernel (with ``softcap``, its
    capped instance) against its plain version; raises beyond FD_TOL."""
    import torch
    scale = q.shape[-1] ** -0.5
    got = fdk.flash_decode(q, k, v, lens, scale=scale,
                           softcap=softcap).float()
    want = fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                  softcap=softcap).float()
    torch.cuda.synchronize()
    rtol, atol = FD_TOL[dtype_name]
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"flash_decode {tuple(q.shape)} S "
                             f"{k.shape[1]} {dtype_name} softcap "
                             f"{softcap}: max abs err "
                             f"{err.max().item()} beyond rtol {rtol} atol "
                             f"{atol}")
    zero = (lens == 0).nonzero().flatten()
    if len(zero) and not bool((got[zero] == 0).all()):
        raise AssertionError("flash_decode: a zero-length row is not zero")
    return err.max().item(), (err / want.abs().clamp(min=1e-6)).max().item()


def flash_decode_phase(fdk, bw: float, flops: float) -> list[dict]:
    """Phase 3, flash_decode: f32 and bf16 at D 64 and 128 with zero-length
    rows, the capped instances (SOFTCAP) at D 64, 128 and 256 in f32 and
    bf16 with zero-length rows and NaN rows past each length, then the
    timed bf16 rows at FD_SHAPES and the capped one at the serve
    shape."""
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
    capped = []
    # its own draws: the timed rows below see the draws they saw before
    # the capped instances existed
    gen_cap = torch.Generator(device="cuda").manual_seed(1)
    for D, Hkv, G in FD_CAP_SHAPES:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v, lens = fd_inputs(8, 4096, Hkv, G, D, "drawn", dt,
                                      gen_cap)
            lens[0], lens[1], lens[2] = 0, 1, 4096 + 7
            # scores of order the cap, so that it bites
            q = (q.float() * (SOFTCAP * D ** 0.5 / 8)).to(dt)
            err, rel = _fd_err(fdk, q, k, v, lens, name, SOFTCAP)
            capped.append({"D": D, "G": G, "dtype": name,
                           "max_abs_err": err, "max_rel_err": rel})
            log(f"  flash_decode softcap {SOFTCAP} {name} D={D} G={G}: "
                f"max abs err {err:.3g} (rel {rel:.3g}); lengths 0, 1, "
                f"S+7 included")
    poison = fd_poison_check(fdk, softcap=SOFTCAP)
    serve_draws = gen.get_state()
    rows = [fd_timed_row(fdk, shape, gen, bw, flops) for shape in FD_SHAPES]
    # the capped kernel on the serve row's very inputs
    gen.set_state(serve_draws)
    rows.append(fd_timed_row(fdk, FD_SHAPES[0], gen, bw, flops,
                             softcap=SOFTCAP))
    rows[-1].update(capped_checks=capped, nan_past_length_identical=poison)
    return rows


def _fd_lse_err(fdk, q, k, v, lens, dtype_name, softcap: float = 0.0
                ) -> dict:
    """The kernel's lse instance against its plain version: out (f32) at
    FD_TOL of its input dtype, lse at FD_LSE_RTOL of max(|lse|, 1) and
    -inf exactly (and a zero output) where a row has no valid key; one
    launch. Raises beyond them."""
    import torch
    scale = q.shape[-1] ** -0.5
    before = fdk.LAUNCHES["flash_decode"]
    out, lse = fdk.flash_decode(q, k, v, lens, scale=scale, softcap=softcap,
                                lse=True)
    launches = fdk.LAUNCHES["flash_decode"] - before
    want, want_lse = fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                            softcap=softcap, lse=True)
    torch.cuda.synchronize()
    rtol, atol = FD_TOL[dtype_name]
    err = (out - want).abs()
    empty = lens.clamp(max=k.shape[1]) == 0
    fin = ~empty
    lerr = ((lse[fin] - want_lse[fin]).abs()
            / want_lse[fin].abs().clamp(min=1.0))
    bad = []
    if out.dtype != torch.float32 or lse.dtype != torch.float32 \
            or launches != 1:
        bad.append(f"out {out.dtype}, lse {lse.dtype}, {launches} launches")
    if not bool((err <= atol + rtol * want.abs()).all()):
        bad.append(f"out max abs err {err.max().item()}")
    if lerr.numel() and not lerr.max().item() <= FD_LSE_RTOL:
        bad.append(f"lse max rel err {lerr.max().item()}")
    if not bool(torch.isneginf(lse[empty]).all()) \
            or not bool((out[empty] == 0).all()) \
            or bool(torch.isinf(lse[fin]).any()):
        bad.append("an empty row's lse is not -inf (or its output not 0), "
                   "or a row with keys has an infinite lse")
    if bad:
        raise AssertionError(f"flash_decode lse {tuple(q.shape)} S "
                             f"{k.shape[1]} {dtype_name} softcap {softcap}: "
                             + "; ".join(bad))
    return {"max_abs_err": err.max().item(),
            "lse_max_rel_err": lerr.max().item() if lerr.numel() else 0.0,
            "empty_rows": int(empty.sum())}


def fd_stripes(fdk, q, k, v, lens, rows: int, stripes: int) -> tuple:
    """flash_decode with the log-sum-exp on each of ``stripes`` stripes of
    ``rows`` keys of the cache, at each stripe's own valid length
    clamp(min(n, S) - r * rows, 0, rows), as the serving mesh's ranks
    run it: [(out, lse)], one launch each."""
    import torch
    S = k.shape[1]
    parts = []
    for r in range(stripes):
        n = torch.clamp(torch.clamp(lens, max=S) - r * rows, 0, rows)
        sl = slice(r * rows, (r + 1) * rows)
        parts.append(fdk.flash_decode(
            q, k[:, sl].contiguous(), v[:, sl].contiguous(),
            n.to(torch.int32), scale=q.shape[-1] ** -0.5, lse=True))
    return parts


def fd_lse_phase(fdk, bw: float, flops: float, fd_rows: list) -> dict:
    """Phase 3, the lse instances: each against its plain version
    (FD_LSE_CHECKS), three stripes of the serve shape merged against the
    whole cache's one launch (f32 within FD_TOL, bf16 within one bf16
    ulp), NaN rows past a stripe's length (the same bits as finite rows,
    out and lse), then the timed rows (FD_LSE_TIMED) beside the instance
    without lse; this run's rows without lse are logged beside PERF.md's
    (FD_PERF_MS)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(30)
    out = {"checks": [], "rows": []}
    for (B, S, Hkv, G, D, lengths), name, cap in FD_LSE_CHECKS:
        dt = getattr(torch, name)
        q, k, v, lens = fd_inputs(B, S, Hkv, G, D, lengths, dt, gen)
        if cap:
            q = (q.float() * (cap * D ** 0.5 / 8)).to(dt)
        edges = [0, 1, S // 2, S // 2 + 1, S, S + 7]
        for i in range(0, len(edges), B):      # B rows of edges a launch
            part = edges[i:i + B]
            lens[:len(part)] = torch.tensor(part, device=lens.device)
            r = _fd_lse_err(fdk, q, k, v, lens, name, cap)
            r.update(shape=[B, S, Hkv, G, D], dtype=name, softcap=cap,
                     edge_lengths=part)
            out["checks"].append(r)
            log(f"  flash_decode lse {name} B={B} S={S} Hkv={Hkv} G={G} "
                f"D={D} softcap {cap} (lengths {part} in the first rows): "
                f"out max abs err {r['max_abs_err']:.3g}, lse max rel err "
                f"{r['lse_max_rel_err']:.3g}, {r['empty_rows']} empty rows "
                "at -inf")
    count, rows = FD_STRIPES
    S = count * rows
    merge = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        q, k, v, lens = fd_inputs(32, S, 3, 3, 64, "drawn", dt, gen)
        lens[:6] = torch.tensor([0, 1, rows, rows + 1, 2 * rows, S + 7],
                                device=lens.device)
        whole = fdk.flash_decode(q, k, v, lens, scale=64 ** -0.5)
        parts = fd_stripes(fdk, q, k, v, lens, rows, count)
        got = fdk.merge_stripes([o for o, _ in parts], [x for _, x in parts])
        want = fdk.flash_decode_plain(q, k, v, lens, scale=64 ** -0.5,
                                      lse=True)[0]
        torch.cuda.synchronize()
        rtol, atol = FD_TOL[name]
        err = (got.to(dt).float() - whole.float()).abs()
        if not bool((err <= atol + rtol * whole.float().abs()).all()):
            raise AssertionError(f"flash_decode: {count} merged stripes "
                                 f"{name} max abs err {err.max().item()} "
                                 "against the whole cache")
        merge[name] = {"max_abs_err_vs_whole": err.max().item(),
                       "max_abs_err_vs_plain":
                       (got - want).abs().max().item()}
        log(f"  flash_decode {name}: {count} stripes of {rows} keys (B 32, "
            f"Hkv 3, G 3, D 64), merged: max abs err "
            f"{merge[name]['max_abs_err_vs_whole']:.3g} against the whole "
            f"cache's one launch, {merge[name]['max_abs_err_vs_plain']:.3g} "
            f"against the plain whole (f32)")
    out["stripe_merge"] = merge
    out["poison"] = fd_lse_poison_check(fdk)
    for shape in FD_LSE_TIMED:
        out["rows"].append(fd_lse_timed_row(fdk, shape, gen, bw, flops))
    for row in fd_rows:
        S = row["shape"]["S"]
        if S in FD_PERF_MS and not row["shape"]["softcap"]:
            row["perf_md_ms"] = FD_PERF_MS[S]
            log(f"  flash_decode without lse, S={S}: {row['ms']:.5f} ms, "
                f"PERF.md {FD_PERF_MS[S]:.5f} ms "
                f"({row['ms'] / FD_PERF_MS[S] - 1:+.1%})")
    return out


def fd_lse_poison_check(fdk) -> dict:
    """The lse instances (bf16 D 64 and the wide D 256, f32 D 64) on one
    stripe of a cache: K and V rows past each row's valid length filled
    with NaN give the same bits, out and lse, as finite rows; a row with
    none gives -inf and zeros."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    for D, name in ((64, "bfloat16"), (256, "bfloat16"), (64, "float32")):
        dt = getattr(torch, name)
        q, k, v, _ = fd_inputs(8, 512, 1, 8, D, "full", dt, gen)
        lens = torch.tensor([0, 1, 17, 16, 255, 300, 509, 512],
                            dtype=torch.int32, device=q.device)
        past = (torch.arange(512, device=q.device)[None, :]
                >= lens[:, None].long())[:, :, None, None]
        nan = torch.tensor(float("nan"), dtype=dt, device=q.device)
        clean = fdk.flash_decode(q, k, v, lens, scale=D ** -0.5, lse=True)
        dirty = fdk.flash_decode(q, torch.where(past, nan, k),
                                 torch.where(past, nan, v), lens,
                                 scale=D ** -0.5, lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(clean[0], dirty[0])
                and torch.equal(clean[1], dirty[1])):
            raise AssertionError(f"flash_decode lse D={D} {name}: NaN rows "
                                 "past the length reach the output")
        if not bool(torch.isneginf(clean[1][0]).all()) \
                or not bool((clean[0][0] == 0).all()):
            raise AssertionError(f"flash_decode lse D={D} {name}: an empty "
                                 "row is not (0, -inf)")
        out[f"{name}_D{D}"] = True
    log("  flash_decode lse, bf16 D 64 and 256, f32 D 64: NaN rows past "
        "each length give the same bits (out and lse) as finite rows")
    return out


def fd_lse_timed_row(fdk, shape: tuple, gen, bw: float, flops: float
                     ) -> dict:
    """The lse instance in bf16 at ``shape`` (B, S, Hkv, G, D, lengths):
    timed beside the instance without lse on the same inputs, its plain
    version and SDPA (the library call, on the same keys: it gives no
    log-sum-exp), with its bound: K and V over the valid rows, q read, an
    f32 output and lse written once."""
    import torch
    import torch.nn.functional as F
    B, S, Hkv, G, D, lengths = shape
    q, k, v, lens = fd_inputs(B, S, Hkv, G, D, lengths, torch.bfloat16, gen)
    chk = _fd_lse_err(fdk, q, k, v, lens, "bfloat16")
    scale = D ** -0.5
    valid = int(lens.clamp(max=S).sum())
    nbytes = valid * Hkv * D * 2 * 2 + q.numel() * 2 + q.numel() * 4 \
        + B * Hkv * G * 4 + B * 4
    nops = valid * Hkv * G * (4 * D + 1)
    calls = FD_CALLS[S]
    qs = q.reshape(B, Hkv * G, 1, D)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    row = _row(B, S, chk["max_abs_err"], chk["lse_max_rel_err"], timings(
        lambda: fdk.flash_decode(q, k, v, lens, scale=scale, lse=True),
        calls),
        device_ms(lambda: fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                                 lse=True),
                  calls=max(1, calls // 5)),
        device_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True),
            calls=calls), nbytes, nops, bw, flops)
    del row["rows"], row["lane"]
    row["without_lse_ms"] = device_ms(
        lambda: fdk.flash_decode(q, k, v, lens, scale=scale), calls=calls)
    plan = fdk.plan(q, k)
    row.update(shape={"B": B, "S": S, "Hkv": Hkv, "G": G, "D": D,
                      "dtype": "bfloat16", "lengths": lengths,
                      "valid_rows": valid, "lse": True},
               splits=plan.splits, keys_per_split=plan.keys_per_split,
               ctas=B * Hkv * plan.splits, library="SDPA")
    log(f"  flash_decode lse B={B} S={S} Hkv={Hkv} G={G} D={D} bf16 "
        f"({lengths} lengths, {valid} valid rows; {plan.splits} splits of "
        f"{plan.keys_per_split} keys): kernel {row['ms']:.5f} ms (without "
        f"lse {row['without_lse_ms']:.5f}; dispatch "
        f"{row['dispatch_ms']:.4f})  plain {row['plain_ms']:.5f} ms  SDPA "
        f"{row['library_ms']:.5f} ms  bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']})")
    del q, k, v, lens, kt, vt, mask, qs
    torch.cuda.empty_cache()
    return row


def flex_decode(q, k, v, lens, scale: float, softcap: float):
    """A zero-argument call of PyTorch's compiled ``flex_attention``
    computing the capped, length-masked GQA decode of ``flash_decode(q,
    k, v, lens, softcap=softcap)``: the cap as its ``score_mod`` (applied
    to the scaled score, as the kernel applies it), ``j < lens[b]`` as
    its block mask, ``enable_gqa``; returns (B, Hkv, G, D)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    qf = q.reshape(B, Hkv * G, 1, D)
    kf = k.permute(0, 2, 1, 3).contiguous()
    vf = v.permute(0, 2, 1, 3).contiguous()
    lens = lens.clamp(max=S)

    def keep(b, h, q_idx, kv_idx):
        return kv_idx < lens[b]

    def cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(keep, B, None, 1, S, device=q.device)
    fn = torch.compile(flex_attention)
    return lambda: fn(qf, kf, vf, score_mod=cap, block_mask=mask,
                      scale=scale, enable_gqa=True).reshape(B, Hkv, G, D)


def fd_timed_row(fdk, shape: tuple, gen, bw: float, flops: float,
                 softcap: float = 0.0) -> dict:
    """flash_decode in bf16 at ``shape`` (B, S, Hkv, G, D, lengths):
    held against its plain version, then timed beside the plain version,
    the library call and its bound. The library call is masked SDPA;
    with ``softcap`` (the capped instance; SDPA takes no cap) it is a
    compiled ``flex_attention`` (:func:`flex_decode`), held against the
    plain version too (logged), and the bound counts a tanh with the exp
    of each score."""
    import torch
    import torch.nn.functional as F
    B, S, Hkv, G, D, lengths = shape
    q, k, v, lens = fd_inputs(B, S, Hkv, G, D, lengths, torch.bfloat16, gen)
    err, rel = _fd_err(fdk, q, k, v, lens, "bfloat16", softcap)
    scale = D ** -0.5
    valid = int(lens.clamp(max=S).sum())
    # K and V over the valid rows, q read and out written once, lengths
    nbytes = valid * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + B * 4
    # per valid key and query head: D multiply-adds for the score and
    # D for the value product, plus the exp (and the cap's tanh)
    nops = valid * Hkv * G * (4 * D + (2 if softcap else 1))
    calls = FD_CALLS[S]
    qs = q.reshape(B, Hkv * G, 1, D)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    lib_extra = {}
    if softcap:
        import torch._inductor.config as inductor_config
        inductor_config.compile_threads = 1     # no worker processes
        t0 = time.perf_counter()
        library = flex_decode(q, k, v, lens, scale, softcap)
        want = fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                      softcap=softcap).float()
        lib_err = (library().float() - want).abs().max().item()
        torch.cuda.synchronize()
        lib_extra = {"library": "flex_attention (compiled)",
                     "library_max_abs_err": lib_err,
                     "library_compile_s": time.perf_counter() - t0}
    else:
        library = sdpa
    plan = fdk.plan(q, k)
    row = _row(B, S, err, rel, timings(
        lambda: fdk.flash_decode(q, k, v, lens, scale=scale,
                                 softcap=softcap), calls),
        device_ms(lambda: fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                                 softcap=softcap),
                  calls=max(1, calls // 5)),
        device_ms(library, calls=calls), nbytes, nops, bw, flops)
    del row["rows"], row["lane"]
    row.update(shape={"B": B, "S": S, "Hkv": Hkv, "G": G, "D": D,
                      "dtype": "bfloat16", "lengths": lengths,
                      "valid_rows": valid, "softcap": softcap},
               splits=plan.splits, keys_per_split=plan.keys_per_split,
               ctas=B * Hkv * plan.splits, **lib_extra)
    lib = (f"flex_attention {row['library_ms']:.5f} ms (max abs err "
           f"{lib_extra['library_max_abs_err']:.3g} against the plain "
           f"version; compiled in {lib_extra['library_compile_s']:.1f} s)"
           if softcap else f"SDPA {row['library_ms']:.5f} ms")
    log(f"  flash_decode B={B} S={S} Hkv={Hkv} G={G} D={D} bf16 "
        f"softcap {softcap} ({lengths} lengths, {valid} valid rows; "
        f"{plan.splits} splits of {plan.keys_per_split} keys, "
        f"{row['ctas']} CTAs): kernel {row['ms']:.5f} ms (dispatch "
        f"{row['dispatch_ms']:.4f})  plain {row['plain_ms']:.5f} ms  {lib}"
        f"  bound {row['bound_ms']:.5f} ms ({row['bound_by']})  max abs "
        f"err {err:.3g}")
    del q, k, v, lens, kt, vt, mask, qs, library
    torch.cuda.empty_cache()
    return row


def serve_phase(serve, fdk, lk, args=SERVE_ARGS, requests: int = 32,
                phase8=None, label: str = "", keep: dict | None = None
                ) -> dict:
    """Phase 8 (and 14, for granite; 15, for deepseek, whose absorbed MLA
    decode launches no ``flash_decode``; 16, for falcon-mamba, which
    launches none, and zamba2, one per application of its shared block;
    19, the serve stack's runs): the serve entry point at full width.
    Every launch count is set to 0 just before it and read just after.
    Gated: every request finished with finite logits; one ``decode_step``
    call a decode tick with exactly ``flash_decode_per_tick`` launches
    each and none outside the ticks (chunk admission, restores and
    snapshots included: the engine counts them); no LARS kernel. The
    allocator's peak above what was allocated before the call is kept
    (``peak_bytes``); given ``phase8`` (phase 19) it is held to at most
    phase 8's peak plus the prefix store's bytes plus 1 GiB (a masked
    decode or chunk call that copied the cache would pass it), and the
    tick, occupancy, TTFT and latency (by tier) are logged beside phase
    8's. ``keep`` takes the report and the launches under ``tuple(args)``
    (a mesh's run is held against them, as :func:`serve_alone` gives
    them)."""
    import torch
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lk.reset_launch_counts()
    fdk.reset_launch_counts()
    t0 = time.perf_counter()
    rep = serve.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(fdk.LAUNCHES)
    lars = dict(lk.LAUNCHES)
    if keep is not None:
        keep[tuple(args)] = (rep, launches)
    st, per = rep["stats"], rep["flash_decode_per_tick"]
    ticks = rep["decode_steps"]
    want = per * ticks
    tick_ms = 1e3 * rep["wall_s"] / max(ticks, 1)
    keys = ("requests", "tokens", "wall_s", "tok_per_s", "occupancy",
            "latency_mean_s", "latency_p50_s", "latency_p90_s",
            "latency_p99_s", "ttft_mean_s", "ttft_p50_s", "ttft_p90_s",
            "ttft_p99_s", "decode_steps", "admit_calls", "logits_finite")
    out = dict({k: rep[k] for k in keys}, launches=launches,
               tick_wall_ms=tick_ms, peak_bytes=peak, stats=st,
               flash_decode_per_tick=per, call_wall_s=wall)
    if phase8 is None:
        log(f"  {rep['requests']} requests, {rep['tokens']} tokens, "
            f"{rep['tok_per_s']:.1f} tok/s, {ticks} decode ticks "
            f"({tick_ms:.2f} ms of wall time per tick, admissions "
            f"included), {rep['admit_calls']} admissions; TTFT p50/p99 "
            f"{1e3 * rep['ttft_p50_s']:.1f}/{1e3 * rep['ttft_p99_s']:.1f} "
            f"ms, latency p50/p99 {1e3 * rep['latency_p50_s']:.1f}/"
            f"{1e3 * rep['latency_p99_s']:.1f} ms; flash_decode launches "
            f"{launches['flash_decode']} (want {want}); LARS kernels {lars}"
            f"; logits finite {rep['logits_finite']}; peak "
            f"{peak / 2 ** 30:.3f} GiB")
    else:
        entries = int(args[args.index("--prefix-entries") + 1]) \
            if "--prefix-entries" in args else 0
        store = stack_store_bytes(entries)
        bound = phase8["peak_bytes"] + store + 2 ** 30
        by_tier = {cls: {"ttft_p50_s": r["ttft"]["p50"],
                         "ttft_p99_s": r["ttft"]["p99"],
                         "latency_p50_s": r["latency"]["p50"],
                         "latency_p99_s": r["latency"]["p99"],
                         "requests": r["requests"]}
                   for cls, r in rep.get("by_class", {}).items()}
        out.update(by_tier=by_tier, prefix=rep.get("prefix"),
                   peak_bound_bytes=bound, store_bytes=store)
        log(f"  {label}: {rep['requests']} requests, {rep['tokens']} "
            f"tokens, {rep['tok_per_s']:.1f} tok/s, {ticks} decode ticks "
            f"({tick_ms:.2f} ms of wall time per tick, chunks included; "
            f"phase 8: {phase8['tick_wall_ms']:.2f}), occupancy "
            f"{rep['occupancy']:.3f} (phase 8: {phase8['occupancy']:.3f}); "
            f"TTFT p50/p99 {1e3 * rep['ttft_p50_s']:.1f}/"
            f"{1e3 * rep['ttft_p99_s']:.1f} ms (phase 8: "
            f"{1e3 * phase8['ttft_p50_s']:.1f}/"
            f"{1e3 * phase8['ttft_p99_s']:.1f}), latency p50/p99 "
            f"{1e3 * rep['latency_p50_s']:.1f}/"
            f"{1e3 * rep['latency_p99_s']:.1f} ms")
        for tier, r in by_tier.items():
            log(f"    {tier}: TTFT p50/p99 {r['ttft_p50_s']}/"
                f"{r['ttft_p99_s']} s, latency p50/p99 "
                f"{r['latency_p50_s']}/{r['latency_p99_s']} s")
        log(f"    {st['decode_calls']} decode_step calls, flash_decode "
            f"{st['flash_decode_launches']} in the ticks (want {per} x "
            f"{ticks}), {st['flash_decode_outside_ticks']} outside; chunks "
            f"{st['chunk_calls']}, restores {st['restore_calls']}, "
            f"snapshots {st['snap_calls']}, prefix hits "
            f"{st['prefix_hits']} ({st['prefix_hit_tokens']} tokens), "
            f"preemptions {st['preemptions']}; peak {peak / 2 ** 30:.3f} "
            f"GiB (bound {bound / 2 ** 30:.3f}: phase 8's "
            f"{phase8['peak_bytes'] / 2 ** 30:.3f} + store "
            f"{store / 2 ** 30:.3f} + 1); LARS kernels {lars}; logits "
            f"finite {rep['logits_finite']}; call {wall:.1f} s")
    bad = []
    if rep["requests"] != requests or not rep["logits_finite"]:
        bad.append(f"{rep['requests']} of {requests} requests finished, "
                   f"logits finite {rep['logits_finite']}")
    # a scenario's warm pass (before the engine's counts are reset) adds
    # its own ticks' launches to the wrapper's count
    warm = "--scenario" in args
    if ticks == 0 or st["decode_calls"] != ticks \
            or st["flash_decode_launches"] != want \
            or st["flash_decode_outside_ticks"] \
            or launches["flash_decode"] != rep["flash_decode_launches"] \
            or (not warm and launches["flash_decode"] != want):
        bad.append(f"{launches} flash_decode launches for {ticks} ticks of "
                   f"{rep['num_layers']} layers, want {want}; {st}")
    if any(lars.values()):
        bad.append(f"LARS kernels launched: {lars}")
    if phase8 is not None and peak > out["peak_bound_bytes"]:
        bad.append(f"peak {peak} B above {out['peak_bound_bytes']} B")
    if bad:
        raise AssertionError(f"serve {label or args[1]}: " + "; ".join(bad))
    return out


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


def _grid_outputs(out_dir: str, grid, ids) -> tuple[dict, dict]:
    """(trajectories without timing keys, manifest rows without wall_s)
    of the cells ``ids``."""
    from repro_torch.experiments import read_trajectory
    from repro_torch.experiments.record import load_json
    traj = {cid: read_trajectory(
        os.path.join(out_dir, cid, "trajectory.jsonl"), strip_timing=True)
        for cid in ids}
    rows = {cid: {k: v for k, v in row.items() if k != "wall_s"}
            for cid, row in load_json(os.path.join(
                out_dir, "manifest.json"))["cells"].items() if cid in ids}
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


def kill_and_resume(name: str, root: str, kill_after: int,
                    cells: int = 0) -> bool:
    """Run grid ``name`` into ``root/killed_<name>``, killed after
    ``kill_after`` steps (mid-cell, past a checkpoint, in the second
    cell, or in the first where it runs alone), resume it, and hold its
    trajectories and rows (without ``wall_s``) equal to the uninterrupted
    run's in ``root/name``. With ``cells`` only the grid's first
    ``cells`` cells run (the runner's ``cell_ids``); a cell finished
    before the kill is skipped on resume, the killed one resumed from
    its checkpoint."""
    from repro_torch.experiments import GridRunner, get_grid
    from repro_torch.experiments.runner import ABORT_ENV
    grid = get_grid(name)
    ids = [c.cell_id for c in grid.cells()][:cells or None]
    kdir = os.path.join(root, f"killed_{name}")
    os.environ[ABORT_ENV] = str(kill_after)
    killed = False
    try:
        GridRunner(grid, kdir, device="cuda", log=log).run(cell_ids=ids)
    except KeyboardInterrupt:
        killed = True
    finally:
        os.environ.pop(ABORT_ENV, None)
    ckpt = os.path.join(kdir, ids[min(1, len(ids) - 1)], "state.npz")
    if not killed or not os.path.exists(ckpt):
        raise AssertionError(f"the kill after {kill_after} steps did not "
                             f"land mid-cell ({ckpt})")
    GridRunner(grid, kdir, device="cuda", log=log).run(resume=True,
                                                       cell_ids=ids)
    got = _grid_outputs(kdir, grid, ids)
    want = _grid_outputs(os.path.join(root, name), grid, ids)
    differ = [f"{cid} trajectory" for cid in ids
              if got[0][cid] != want[0][cid]] + [
        f"{cid} {key}: {row.get(key)} != {want[1][cid].get(key)}"
        for cid, row in got[1].items()
        for key in set(row) | set(want[1][cid])
        if row.get(key) != want[1][cid].get(key)]
    if set(got[1]) != set(ids):
        differ.append(f"rows {sorted(got[1])}, want {ids}")
    log(f"  {name} ({len(ids)} cells) killed after {kill_after} steps and "
        f"resumed: trajectories and rows "
        f"{'DIFFERENT' if differ else 'equal'} to the uninterrupted run's"
        + "".join(f"\n    {d}" for d in differ))
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
                                    until_step=EXP_TIMING_STEPS)
            torch.cuda.synchronize()
            key = (f"stats_{'on' if stats else 'off'}_"
                   f"deterministic_{'on' if det else 'off'}")
            rates.setdefault(key, []).append(
                EXP_TIMING_STEPS / (time.perf_counter() - t0))
        for key, r in rates.items():
            log(f"  {cell.cell_id} {key}: "
                + " / ".join(f"{x:.2f}" for x in r) + " steps/s")
        out["timing"] = {"cell": cell.cell_id, "steps": EXP_TIMING_STEPS,
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
    # one full-width f32 step profiled (the large-batch path's profile
    # went for phase 20's time: phase 13 profiles it at qwen3-14b)
    out["profile"] = {"f32": lm_profile("f32")}
    out["card_vs_cpu"] = lm_card_vs_cpu(train)
    out["loader"] = loader_phase()
    root = os.path.join(workdir, "lm_experiments")
    shutil.rmtree(root, ignore_errors=True)
    out[LM_GRID] = run_grid_checked(
        LM_GRID, root, lk, {"L1_comparable_at_small_batch",
                            "L2_lamb_le_adamw_at_largest_batch",
                            "L3_lars_le_sgd_at_largest_batch",
                            "L4_best_layerwise_beats_best_generic_at_largest"})
    out["kill_resume_equal"] = kill_and_resume(LM_GRID, root, LM_KILL_AFTER,
                                               cells=1)
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
                      floor: float, rows: int = 0) -> dict:
    """The three LARS kernels at a large ``layout``'s rows, on fresh
    buffers drawn from ``seed`` before any model is built. Each is held
    against its plain version on EVERY row — the plain versions run on
    chunks of PLAIN_CHUNK rows, whose temporaries fit beside the
    buffers — and the rows past element 2^31, if any, are reported
    apart. The kernel and the library call are timed from a CUDA graph
    of one call, the chunked plain version by CUDA events. ``rows`` (with
    no layout): a ZeRO shard's rows, which no fold follows."""
    import gc
    import torch
    from repro_torch.core import packing
    R = rows or layout.buffer_shape[0]
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
    fold = device_ms(lambda: packing.fold_rows(layout, wsq), calls=1) \
        if layout is not None else None
    del wsq, gsq, rel
    vn = lambda x: torch.linalg.vector_norm(x, dim=1)  # noqa: E731
    out["norms_flat"] = _row(
        R, 512, err, rel_all, timed(lambda: lk.norms_flat(w, g, block_rows=1)),
        plain_ms(lambda a, b: lk.norms_flat_plain(w[a:b], g[a:b],
                                                  block_rows=1)),
        device_ms(lambda: (vn(w), vn(g)), calls=1),
        2 * n * 4 + 2 * R * 4, 4 * n, bw, flops)
    out["norms_flat"]["max_rel_err_past_2_31"] = rel_past
    if fold is not None:
        out["norms_flat"]["fold_ms"] = fold

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
    log(f"  {R} rows, " + (f"{layout.num_slices} slices " if layout
                           else "a ZeRO shard ") + f"({n:,} elements"
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
        train, lk, fdk, LEAN_ARGS + ["--optimizer", "lars"],
        {tag: sets(vs) for tag, vs in LEAN_RUNS.items()}, LEAN_STEPS)
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


def deepseek_serve(serve, fdk, lk, keep: dict | None = None) -> dict:
    """Phase 15: ``launch.serve`` on deepseek at every width, all 160
    experts, DEEPSEEK_SERVE_LAYERS layers (phase 8's traffic with 8 new
    tokens; its init drawn on the card, ``card_draws``; the report kept
    in ``keep`` for phase 20 (g)): no
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
        with card_draws(DEEPSEEK_SERVE_DRAW):
            out = serve_phase(serve, fdk, lk, DEEPSEEK_SERVE_ARGS,
                              keep=keep)
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


def mla_alone(train, lk, fdk, runs: dict, keep: dict) -> dict:
    """Phase 15's deepseek training runs (``runs`` through
    ``launch.train`` at DEEPSEEK_ARGS; the f32 LARS run first) and what
    phase 20 (g)'s mesh is held against, in ``keep["train"]``: that
    run's losses, its global packed rows and step 0 layer 0's routing
    (:func:`first_routing`). (Its serving run alone is phase 15's
    :func:`deepseek_serve`, kept in ``keep["serve"]``.) Returns
    :func:`lm_train_runs`' result."""
    first = next(iter(runs))
    if runs[first] != QWEN_RUNS["lars"]:
        raise ValueError(f"the first run must be f32 LARS, not {first}")
    with first_routing({}) as box:
        res = lm_train_runs(train, lk, fdk, DEEPSEEK_ARGS, runs,
                            DEEPSEEK_STEPS, aux=True)
    keep["train"] = {"losses": res[first]["losses"], "box": box,
                     "rows": lm_layout(deepseek_cfg()).buffer_shape[0],
                     "peak_bytes": res[first]["peak_bytes"],
                     "step_ms": 1e3 / res[first]["steps_per_s"]}
    return res


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
              stock_tokens_per_s, keep: dict) -> dict:
    """Phase 15: MLA (deepseek-v2-236b) trained and served on the card,
    and the training side of sliding windows and the softcap. ``keep``
    takes what phase 20 (g)'s mesh is held against (:func:`mla_alone`):
    the f32 LARS run's losses, rows and first routing, and the full-width
    serving report."""
    t_phase = time.perf_counter()
    layout = lm_layout(deepseek_cfg())
    out = {"rows": layout.buffer_shape[0], "slices": layout.num_slices,
           "kernel_rows": large_kernel_rows(lk, layout, 4, bw, flops,
                                            floor)}
    out["runs"] = mla_alone(train, lk, fdk, QWEN_RUNS, keep)
    out["session"] = moe_session(deepseek_cfg(), DEEPSEEK_BATCH,
                                 f"deepseek ({DEEPSEEK_LAYERS} layer, 16 "
                                 "routed experts)")
    out["serve"] = deepseek_serve(serve, fdk, lk, keep.setdefault(
        "serve", {}))
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


def fd_poison_check(fdk, softcap: float = 0.0) -> dict:
    """Phase 17 (and 3, for the capped instances): for each bf16 instance
    (D 64, 128 and the wide kernel at 256), K and V rows past each length
    filled with NaN give the same output bits as finite rows (lengths 0,
    1, inside a tile, on a tile, on a split boundary, S)."""
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
        clean = fdk.flash_decode(q, k, v, lens, scale=D ** -0.5,
                                 softcap=softcap)
        poisoned = fdk.flash_decode(q, torch.where(past, nan, k),
                                    torch.where(past, nan, v), lens,
                                    scale=D ** -0.5, softcap=softcap)
        torch.cuda.synchronize()
        if not torch.equal(clean, poisoned):
            raise AssertionError(f"flash_decode D={D} softcap {softcap}: "
                                 "NaN rows past the length reach the "
                                 "output")
        if not torch.equal(clean[0], torch.zeros_like(clean[0])):
            raise AssertionError(f"flash_decode D={D} softcap {softcap}: "
                                 "a zero-length row is not zero")
        out[D] = True
    log(f"  flash_decode bf16 D 64, 128, 256, softcap {softcap}: NaN rows "
        f"past each length give the same bits as finite rows")
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


# ------------------------------------------------------ phase 19: serve stack

def stack_store_bytes(entries: int = STACK_PREFIX_ENTRIES) -> int:
    """Bytes of full-width smollm's prefix store: ``entries`` slot rows
    of its decode cache at capacity 4096."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cache = build_model(get_config("smollm-135m")).init_cache(
        entries, 4096, device="meta")
    return sum(t.numel() * t.element_size() for t in cache.values())


def serve_stack_family(fdk, arch: str, changes: dict) -> dict:
    """Phase 19 (b): a reduced serve family in f32 through the chunked
    engine with the prefix store and SLO tiers, on the CPU (plain
    version) and on the card (kernel): two tier-1 requests fill both
    slots, then tier-0 arrivals force preemptions. Gated: the card's
    greedy tokens equal the CPU's; on the card the chunked run equals a
    monolithic FIFO run of the same requests (so every preempted
    request's stream equals its uninterrupted run); preemptions >= 1;
    flash_decode only in the ticks, ``flash_decode_per_step()`` a tick."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import TierSLO
    from repro_torch.treepath import tree_map
    cfg, model, params = _reduced_lm("cpu", arch, changes)
    card = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, (16,))
    reqs = [(rng.integers(1, cfg.vocab_size, (13,)), 12, 1),
            (np.concatenate([shared, rng.integers(1, cfg.vocab_size, (9,))]),
             12, 1)] + [
        (np.concatenate([shared, rng.integers(1, cfg.vocab_size, (n,))]),
         6, 0) for n in (4, 7)] + [
        (rng.integers(1, cfg.vocab_size, (n,)), 6, 0) for n in (5, 21)]
    slos = {t: TierSLO(*v) for t, v in STACK_SLOS.items()}

    def chunked(p, dev):
        eng = ServeEngine(model, p, cfg, slots=2, capacity=64, seed=7,
                          prefill_chunk=5, prefix_entries=8,
                          prefix_min_tokens=4, slos=slos)
        fdk.reset_launch_counts()
        rids = [eng.submit(t, n, tier=tier) for t, n, tier in reqs[:2]]
        for _ in range(8):
            eng.step()
        rids += [eng.submit(t, n, tier=tier) for t, n, tier in reqs[2:]]
        got = {f.request.rid: f.tokens.tolist() for f in eng.run([])}
        if dev == "cuda":
            torch.cuda.synchronize()
        return ([got[r] for r in rids], dict(eng.stats),
                fdk.LAUNCHES["flash_decode"], eng.logits_finite)

    cpu, cpu_st, _, _ = chunked(params, "cpu")
    gpu, st, launches, finite = chunked(card, "cuda")
    mono = ServeEngine(model, card, cfg, slots=2, capacity=64, seed=7)
    rids = [mono.submit(t, n) for t, n, _ in reqs]
    got = {f.request.rid: f.tokens.tolist() for f in mono.run([])}
    mono_toks = [got[r] for r in rids]
    want = model.flash_decode_per_step() * st["decode_steps"]
    out = {"greedy_identical_card_cpu": gpu == cpu,
           "chunked_equals_monolithic": gpu == mono_toks,
           "preemptions": st["preemptions"], "cpu_preemptions":
           cpu_st["preemptions"], "prefix_hits": st["prefix_hits"],
           "restore_calls": st["restore_calls"],
           "decode_steps": st["decode_steps"],
           "decode_calls": st["decode_calls"],
           "flash_decode_launches": launches, "want_launches": want,
           "outside_ticks": st["flash_decode_outside_ticks"],
           "logits_finite": finite}
    log(f"  reduced {arch}{' ' + str(changes) if changes else ''} (f32): "
        f"greedy tokens card vs CPU "
        f"{'identical' if out['greedy_identical_card_cpu'] else 'DIFFERENT'}"
        f", chunked vs monolithic on the card "
        f"{'identical' if out['chunked_equals_monolithic'] else 'DIFFERENT'}"
        f"; {st['preemptions']} preemptions (CPU {cpu_st['preemptions']}), "
        f"{st['prefix_hits']} prefix hits, {st['restore_calls']} restores; "
        f"flash_decode {launches} (want {want}), "
        f"{st['flash_decode_outside_ticks']} outside the ticks")
    if not (out["greedy_identical_card_cpu"]
            and out["chunked_equals_monolithic"] and st["preemptions"] >= 1
            and launches == want and st["decode_calls"] == st["decode_steps"]
            and not st["flash_decode_outside_ticks"] and finite):
        raise AssertionError(f"serve stack {arch}: {out}; card {gpu}, CPU "
                             f"{cpu}, monolithic {mono_toks}")
    return out


def serve_grid_run(workdir: str) -> dict:
    """Phase 19 (d): ``launch.serve_experiment --grid serve_slo_smoke``
    on the card into ``build/serve_grid/``. Gated on the decode contract
    (exit code 0); A1–A3 are logged as they come out."""
    from repro_torch.launch import serve_experiment
    out_dir = os.path.join(workdir, "serve_grid")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "EXPERIMENTS_torch_serve.json")
    t0 = time.perf_counter()
    rc = serve_experiment.main(["--grid", "serve_slo_smoke", "--out", path])
    wall = time.perf_counter() - t0
    with open(path) as f:
        payload = json.load(f)["serve_slo"]
    claims = payload["claims"]
    for name, value in claims.items():
        log(f"  claim serve_slo.{name}: {value}")
    log(f"  serve_slo_smoke: {len(payload['cells'])} cells in {wall:.1f} s, "
        f"exit {rc}")
    if rc != 0 or not claims["contract_one_decode_trace_per_cell"]:
        raise AssertionError(f"serve grid: exit {rc}, claims {claims}")
    return {"claims": claims, "wall_s": wall, "report": path,
            "cells": {cid: {k: r[k] for k in (
                "tok_per_s", "occupancy", "preemptions", "decode_steps",
                "decode_calls", "flash_decode_launches",
                "flash_decode_outside_ticks")}
                for cid, r in payload["cells"].items()}}


def serve_stack_phase(serve, fdk, lk, phase8: dict, workdir: str) -> dict:
    """Phase 19: the serve stack on the card (SLO tiers and preemption,
    chunked prefill with ring caches, the prefix store, the scenario
    library and the serve SLO grid)."""
    t_phase = time.perf_counter()
    out = {"session": serve_phase(
        serve, fdk, lk, STACK_ARGS + STACK_SESSION,
        STACK_SESSIONS * STACK_TURNS, phase8, "session")}
    if out["session"]["stats"]["prefix_hits"] < 1:
        raise AssertionError("serve stack session: no prefix hit")
    out["bursty"] = serve_phase(serve, fdk, lk, STACK_ARGS + STACK_BURSTY,
                                STACK_BURSTY_REQUESTS, phase8, "bursty")
    if out["bursty"]["stats"]["preemptions"] < 1:
        raise AssertionError("serve stack bursty: no preemption")
    log("  a window served at full width (a ring of 256 rows, prompts "
        "longer than it):")
    out["window"] = serve_phase(serve, fdk, lk, STACK_WINDOW_ARGS,
                                requests=STACK_WINDOW_REQUESTS)
    out["families"] = {arch: serve_stack_family(fdk, arch, changes)
                       for arch, changes in STACK_FAMILIES.items()}
    out["grid"] = serve_grid_run(workdir)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 19 wall time {out['phase_wall_s']:.1f} s")
    return out


# ------------------------------------------ phase 20: data parallel, ZeRO

def zero_spec(name: str):
    """(cfg, model, optimizer, host batches, global batch, steps) of one
    phase 20 run: LeNet at batch 1024 with f32 or int8 LARS momentum,
    smollm-135m at full width, 16 x 1024 tokens, f32 LARS, or (f)'s
    granite at full width and MOE_MESH_LAYERS layers."""
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.data import batch_iterator, synthetic_mnist
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import build_model
    if name.startswith("lenet"):
        cfg = get_config("lenet-mnist")
        b, steps = ZERO_LENET
        x, y, _, _ = synthetic_mnist(4 * b, 8, seed=0)
        host = batch_iterator(x, y, batch=b, seed=0)
        slots = "int8" if name.endswith("int8") else "f32"
    elif name.startswith("granite"):
        import dataclasses
        cfg = dataclasses.replace(get_config(GRANITE),
                                  num_layers=MOE_MESH_LAYERS)
        b, seq, steps = MOE_MESH_TRAIN
        host = lm_batches(cfg, b, seq, seed=0)
        slots = "f32"
    else:
        cfg = get_config("smollm-135m")
        b, seq, steps = ZERO_LM
        host = lm_batches(cfg, b, seq, seed=0)
        slots = "f32"
    return (cfg, build_model(cfg), lars(0.01, slot_dtype=slots), host, b,
            steps)


def timed_collectives(events: list):
    """Within the block each collective of the data-parallel step is
    bracketed by a pair of CUDA events on the current stream, appended to
    ``events`` (the module's functions wrapped, as ``record_rows`` wraps
    the kernels). The start event fires when the work queued before the
    collective is done, the end event when its result is back on the
    card, host staging included; nothing syncs the step."""
    import contextlib
    import torch
    from repro_torch.distributed import collectives

    @contextlib.contextmanager
    def block():
        names = ("all_reduce_sum", "all_reduce_max", "reduce_scatter_rows",
                 "all_gather_rows")
        saved = {k: getattr(collectives, k) for k in names}
        for k, inner in saved.items():
            def clocked(*a, _f=inner, **kw):
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
                out = _f(*a, **kw)
                pair[1].record()
                events.append(pair)
                return out
            setattr(collectives, k, clocked)
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(collectives, k, fn)
    return block()


def zero_run(name: str, mesh, zero: bool, rows_seen: list,
             accum: int = 1) -> tuple:
    """One phase 20 run through TrainPipeline and ShardedLoader, on this
    rank's rows (``mesh``) or alone (``mesh=None``; ``accum`` microbatches
    a step, ``ZERO_RANKS`` of them split the batch as the ranks do, and
    off a mesh the pipeline sums them in the order the ranks' reduction
    does): per step exactly one
    ``norms_flat`` and one ``apply_flat`` (``apply_flat_q8``: int8) on
    this rank's rows, checked through LAUNCHES and the rows each launch
    was given, and both summed over the run. Every step from the second
    on gives its wall time and the time of its collectives
    (``timed_collectives``). Returns (result, initial params, final
    params)."""
    import gc
    import torch
    from repro_torch.data import ShardedLoader
    from repro_torch.distributed import collectives
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.train import TrainPipeline
    from repro_torch.treepath import tree_flatten_with_path, tree_leaves
    cfg, model, opt, host, batch, steps = zero_spec(name)
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pipe = TrainPipeline(model, opt, cfg, mesh=mesh, zero=zero,
                         accum_steps=accum)
    state = pipe.init_state(torch.Generator().manual_seed(0), dev)
    init = [t.clone() for t in tree_leaves(state.params)]
    layout = state.opt_state.layout
    rows = state.opt_state.slots["momentum"].shape[0]
    apply = "apply_flat_q8" if name.endswith("int8") else "apply_flat"
    want = {k: int(k in ("norms_flat", apply)) for k in KERNELS}
    loader = ShardedLoader(host, dev, mesh=mesh, spec=pipe.batch_specs(
        batch) if mesh is not None else None, blocks=pipe.row_blocks)
    losses, step_ms, coll_ms, staged = [], [], [], []
    launches = {k: 0 for k in KERNELS}
    launch_rows = {k: [] for k in KERNELS}
    try:
        for i in range(steps):
            b = next(loader)
            lk.reset_launch_counts()
            collectives.reset_counts()
            rows_seen.clear()
            events: list = []
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with timed_collectives(events):
                state, m = pipe(state, b)
            torch.cuda.synchronize(dev)
            if i:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                coll_ms.append(sum(a.elapsed_time(z) for a, z in events))
            staged.append(dict(collectives.STAGED))
            counts = dict(lk.LAUNCHES)
            for k, r in rows_seen:
                launch_rows[k].append(r)
            for k, n in counts.items():
                launches[k] += n
            if counts != want or rows_seen != [("norms_flat", rows),
                                               (apply, rows)]:
                raise AssertionError(
                    f"{name} zero={zero} step {i}: launches {counts} on "
                    f"rows {rows_seen}, want {want} on {rows} rows")
            losses.append(float(m["loss"]))
    finally:
        loader.close()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name} zero={zero}: losses {losses}")
    slot_bytes = sum(v.numel() * v.element_size()
                     for v in state.opt_state.slots.values())
    whole = sum(layout.total_rows * layout.lane * v.element_size()
                if v.shape[1] == layout.lane else
                layout.num_blocks * v.element_size()
                for v in state.opt_state.slots.values())
    out = {"losses": losses, "step_ms": step_ms,
           "collective_ms": coll_ms, "staged": staged,
           "launches": launches,
           "launch_rows": {k: sorted(set(v)) for k, v in launch_rows.items()},
           "rows": rows, "total_rows": layout.total_rows,
           "leaf_paths": ["/".join(map(str, p)) for p, _ in
                          tree_flatten_with_path(state.params)[0]],
           "pad_rows": layout.pad_rows, "slot_bytes": slot_bytes,
           "whole_slot_bytes": whole,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    if pipe.param_shardings is not None:
        import hashlib
        split = {p: sh.split for p, sh in
                 tree_flatten_with_path(pipe.param_shardings)[0]}
        leaves = tree_flatten_with_path(state.params)[0]
        out["split"] = sorted("/".join(p) for p, _ in leaves if split[p])
        out["replicated"] = {"/".join(p): hashlib.sha256(
            x.float().cpu().numpy().tobytes()).hexdigest()
            for p, x in leaves if not split[p]}
    if mesh is not None and zero:
        # the pad rows lie in the last rank's shard: zero weights and
        # momentum, int8 pad blocks at code 0 and scale 1.0
        start = mesh.coords["data"] * rows
        lo = max(layout.base_rows - start, 0)
        pad = {k: v[lo:] if v.shape[1] == layout.lane else v[lo // 8:]
               for k, v in state.opt_state.slots.items()}
        out["pad_rows_here"] = rows - lo
        out["pad_inert"] = all(
            bool(((v == 1.0) if k.endswith("_scale") else (v == 0)).all())
            for k, v in pad.items())
        if not out["pad_inert"]:
            raise AssertionError(f"{name}: pad rows moved")
    return out, init, tree_leaves(state.params)


def param_drift(got: list, ref: list, init: list) -> dict:
    """How far a run's final params lie from a reference run's, against
    how far the reference moved them from ``init``: over the whole
    parameter vector, ``||got - ref|| / ||ref - init||`` (a run that
    never updated reads 1.0), and the worst leaf's own ratio (its
    index)."""
    gaps, moves = [], []
    for a, b, c in zip(got, ref, init):
        gaps.append(float((a.double() - b.double()).norm()))
        moves.append(float((b.double() - c.double()).norm()))
    leaf = [g / m if m else (0.0 if g == 0 else math.inf)
            for g, m in zip(gaps, moves)]
    worst = max(range(len(leaf)), key=leaf.__getitem__)
    return {"whole": math.hypot(*gaps) / math.hypot(*moves),
            "worst_leaf": leaf[worst], "worst_leaf_index": worst}


def record_rows(lk, rows_seen: list) -> dict:
    """Wrap each LARS kernel wrapper of ``lk`` so that every call notes
    (kernel, rows of its buffers) in ``rows_seen``; returns the wrappers
    it replaced."""
    saved = {k: getattr(lk, k) for k in KERNELS}
    for k, inner in saved.items():
        def seen(w2, *a, _k=k, _f=inner, **kw):
            rows_seen.append((_k, w2.shape[0]))
            return _f(w2, *a, **kw)
        setattr(lk, k, seen)
    return saved


def zero_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 20 (a), one of the ranks (``chip_smoke.py --zero-rank R W
    DIR``): gloo over a file store, every rank's tensors on ``cuda:0``.
    Each run trains with ZeRO and then replicated, and the two must be
    bit-identical (losses and every parameter); the ZeRO run's final
    params go to ``DIR/params_<run>_rank<R>.pt`` for the parent to hold
    against the run alone."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch.mesh import mesh_from_spec
    rows_seen: list = []
    record_rows(lk, rows_seen)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = mesh_from_spec(f"{world}x1", device="cuda:0")
        with shared_inits():        # one host draw of smollm's init
            for name in ZERO_RUNS:
                z, _, zp = zero_run(name, mesh, True, rows_seen)
                r, _, rp = zero_run(name, mesh, False, rows_seen)
                gaps = [float((a.float() - b.float()).abs().max())
                        for a, b in zip(zp, rp)]
                out[name] = {"zero": z, "replicated": r,
                             "identical": z["losses"] == r["losses"]
                             and max(gaps) == 0.0,
                             "max_param_gap": max(gaps)}
                torch.save([t.cpu() for t in zp], os.path.join(
                    workdir, f"params_{name}_rank{rank}.pt"))
                del zp, rp
            out["moe"] = moe_mesh_rank(mesh, rank, workdir, rows_seen)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mla_mesh_rank_main(rank: int, world: int, workdir: str) -> None:
    """Phase 20 (g), one of its two ranks (``chip_smoke.py
    --mla-mesh-rank R 2 DIR``, started once every other rank of the phase
    has ended: two ranks of deepseek's cut need most of the card): gloo
    over a file store, the rank's tensors on ``cuda:0``,
    :func:`mla_mesh_rank`; its result in ``DIR/rank<R>.json`` under
    ``"mla"``. To run (g) without the rest of phase 20: ``chip_smoke.py
    --phase-20g`` (:func:`mla_mesh_phase`)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.cuda.init()
    # the two ranks share the card: each allocator keeps what it holds,
    # its cache included, within its share, so neither starves the other
    torch.cuda.set_per_process_memory_fraction(MLA_MESH_CARD_SHARE, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import lars_kernels as lk
    rows_seen: list = []
    record_rows(lk, rows_seen)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        with shared_inits():
            out = {"mla": mla_mesh_rank(rank, workdir, rows_seen)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def free_card() -> None:
    """Before (g)'s ranks: this process's unreferenced blocks returned to
    the card, and the device copies of the packed layouts' static maps
    that every layout trained so far left cached (a few GiB by phase
    20); the card's free bytes and what this process still holds
    logged."""
    import gc
    import torch
    from repro_torch.core import packing
    packing._on_device.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  the card before (g)'s ranks: {torch.cuda.mem_get_info()[0]:,} B "
        f"free, this process holds {torch.cuda.memory_allocated():,} B "
        f"({torch.cuda.memory_reserved():,} B reserved)")


def mla_mesh_phase(train, serve, lk, fdk, workdir: str) -> dict:
    """Phase 20 (g) alone (the kernels built first): what phase 15 runs
    and (g) is held against (:func:`mla_alone`: the f32 LARS run and the
    full-width serving run), the reduced serving run alone, then (g)'s
    two ranks (``--mla-mesh-rank``) and their gates
    (:func:`mla_mesh_against_alone`)."""
    import torch
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    keep: dict = {}
    rows_seen: list = []
    saved = record_rows(lk, rows_seen)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with shared_inits():
            mla_alone(train, lk, fdk, {"lars": QWEN_RUNS["lars"]}, keep)
            deepseek_serve(serve, fdk, lk, keep.setdefault("serve", {}))
        keep["serve"].update(serve_alone([MLA_MESH_SERVE["mla_reduced"]]))
        free_card()
        ranks = spawn_ranks(workdir, "--mla-mesh-rank", ZERO_RANKS)
        return mla_mesh_against_alone(ranks, workdir, keep)
    finally:
        for k, fn in saved.items():
            setattr(lk, k, fn)


def mla_mesh_rank(rank: int, workdir: str, rows_seen: list) -> dict:
    """Phase 20 (g), in one of its two ranks: MLA_MESH_TRAIN
    through ``launch.train --mesh`` (each step timed between syncs, its
    collectives by CUDA events (``timed_collectives``), the bytes it
    handed them (``MOVED``), its LARS launches and the rows each was
    given; step 0 layer 0's routing in ``DIR/mla_keep_rank<R>.pt``; the
    split leaves, a digest of every replicated leaf; the peak), then each
    MLA_MESH_SERVE run through ``launch.serve --mesh``
    (:func:`serve_mesh_rank`)."""
    import gc
    import hashlib
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch import train
    from repro_torch.train import TrainPipeline
    from repro_torch.treepath import tree_flatten_with_path
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    free = torch.cuda.mem_get_info(dev)[0]
    steps: list = []
    last: dict = {}
    inner = TrainPipeline.__call__

    def step(self, state, batch):
        lk.reset_launch_counts()
        collectives.reset_counts()
        rows_seen.clear()
        events: list = []
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with timed_collectives(events):
            out = inner(self, state, batch)
        torch.cuda.synchronize(dev)
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "collective_ms": sum(a.elapsed_time(z)
                                           for a, z in events),
                      "moved": dict(collectives.MOVED),
                      "staged": dict(collectives.STAGED),
                      "launches": dict(lk.LAUNCHES),
                      "rows": [list(r) for r in rows_seen]})
        last.update(pipe=self, state=out[0])
        return out

    TrainPipeline.__call__ = step
    try:
        with first_routing({}) as box:
            summary = train.main(MLA_MESH_TRAIN)
    finally:
        TrainPipeline.__call__ = inner
    torch.save(box, os.path.join(workdir, f"mla_keep_rank{rank}.pt"))
    split = {p: sh.split for p, sh in
             tree_flatten_with_path(last["pipe"].param_shardings)[0]}
    leaves = tree_flatten_with_path(last["state"].params)[0]
    out = {"losses": summary["losses"], "aux_losses": summary["aux_losses"],
           "steps": steps,
           "split": sorted("/".join(p) for p, _ in leaves if split[p]),
           "replicated": {"/".join(p): hashlib.sha256(
               x.float().cpu().numpy().tobytes()).hexdigest()
               for p, x in leaves if not split[p]},
           "rows": int(last["state"].opt_state.slots["momentum"].shape[0]),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
           "free_bytes_at_start": free}
    del leaves
    last.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = serve_mesh_rank(None, workdir, runs={
        tag: (args, MLA_MESH) for tag, args in MLA_MESH_SERVE.items()})
    return out


def moe_mesh_rank_main(rank: int, world: int, workdir: str) -> None:
    """Phase 20 (f) alone, one of its two ranks (``chip_smoke.py
    --moe-mesh-rank R 2 DIR``): gloo over a file store, the rank's tensors
    on ``cuda:0``, :func:`moe_mesh_rank` on a 2x1 mesh; its result in
    ``DIR/rank<R>.json`` under ``"moe"``, as (a)'s ranks write it. To run
    (f) without the rest of phase 20: :func:`moe_mesh_phase`."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch.mesh import mesh_from_spec
    rows_seen: list = []
    record_rows(lk, rows_seen)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        with shared_inits():
            out = {"moe": moe_mesh_rank(mesh_from_spec(
                f"{world}x1", device="cuda:0"), rank, workdir, rows_seen)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def moe_mesh_phase(lk, workdir: str) -> dict:
    """Phase 20 (f) alone (the kernels built first, ``kernels.build.
    build_all()``): its two ranks (``--moe-mesh-rank``) and, beside them,
    its runs alone in this process (:func:`moe_mesh_alone`); then its
    gates (:func:`moe_mesh_against_alone`)."""
    import torch
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    procs = start_ranks(workdir, "--moe-mesh-rank", ZERO_RANKS)
    rows_seen: list = []
    saved = record_rows(lk, rows_seen)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with shared_inits():
            alone = moe_mesh_alone(rows_seen)
        ranks = join_ranks(workdir, procs, t0)
        return moe_mesh_against_alone(ranks, workdir, alone)
    finally:
        stop_ranks(procs)
        for k, fn in saved.items():
            setattr(lk, k, fn)


@contextlib.contextmanager
def first_routing(box: dict):
    """Within the block, the first MoE routing (``models.moe.place``: layer
    0 of the first step's forward) leaves in ``box`` each token's k
    expert ids and whether each slot was kept, (n, k) on the host."""
    import torch
    from repro_torch.models import moe
    inner = moe.place

    def place(cfg, r, lower=None):
        s = inner(cfg, r, lower)
        if not box:
            keep = torch.empty_like(s.keep).scatter_(0, s.order, s.keep)
            box.update(ids=r.expert_ids.cpu(),
                       keep=keep.reshape(r.expert_ids.shape).cpu())
        return s

    moe.place = place
    try:
        yield box
    finally:
        moe.place = inner


def moe_mesh_rank(mesh, rank: int, workdir: str, rows_seen: list) -> dict:
    """Phase 20 (f), in one of (a)'s ranks (``mesh``: their 2x1 mesh; a
    1x2 mesh of the same processes is built beside it): MOE_MESH_TRAIN's
    granite run on each mesh (:func:`zero_run`: one ``norms_flat`` and
    one ``apply_flat`` a step on the global rows, step ms, the share in
    collectives, the peak, the replicated leaves' digests on 1x2), its
    first routing in ``DIR/moe_keep_<mesh>_rank<R>.pt``; then each
    MOE_MESH_SERVE run through ``launch.serve --mesh`` on each mesh
    (:func:`serve_mesh_rank`)."""
    import gc
    import torch
    from repro_torch.launch.mesh import mesh_from_spec
    meshes = {"2x1": mesh, "1x2": mesh_from_spec("1x2", device="cuda:0")}
    out: dict = {}
    for tag in MOE_MESHES:
        with first_routing({}) as box:
            res, init, final = zero_run("granite_f32", meshes[tag], False,
                                        rows_seen)
        del init, final
        gc.collect()
        torch.cuda.empty_cache()
        torch.save(box, os.path.join(workdir,
                                     f"moe_keep_{tag}_rank{rank}.pt"))
        out[tag] = res
    out["serve"] = serve_mesh_rank(None, workdir, runs={
        f"{name}_{tag}": (args, tag) for name, args in MOE_MESH_SERVE.items()
        for tag in MOE_MESHES})
    return out


def start_ranks(workdir: str, flag: str = "--zero-rank",
                ranks: int = ZERO_RANKS) -> list:
    """Start ``ranks`` processes of this file (``flag R W DIR``: phase 20
    (a)'s or (c)'s ranks), each logging to ``DIR/rank<R>.log``; for
    :func:`join_ranks`."""
    procs = []
    for r in range(ranks):
        log_f = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag,
             str(r), str(ranks), workdir], stdout=log_f,
            stderr=subprocess.STDOUT), log_f))
    return procs


def join_ranks(workdir: str, procs: list, started: float) -> list:
    """Wait for the ranks :func:`start_ranks` started at ``started`` (at
    most ZERO_JOIN_S from then; a rank that hangs or fails ends the
    phase, and every process is stopped); each rank's
    ``rank<R>.json``."""
    deadline = started + ZERO_JOIN_S
    failed = []
    try:
        for r, (p, _) in enumerate(procs):
            try:
                if p.wait(timeout=max(deadline - time.perf_counter(), 1)):
                    failed.append(f"rank {r} exit {p.returncode}")
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} did not end in {ZERO_JOIN_S} s")
    finally:
        stop_ranks(procs)
    if failed:
        for r in range(len(procs)):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                log(f"--- rank {r}\n" + f.read()[-3000:])
        raise AssertionError("; ".join(failed))
    out = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def stop_ranks(procs: list) -> None:
    """Kill every process of ``procs`` still running; close their logs."""
    for p, log_f in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log_f.close()


def spawn_ranks(workdir: str, flag: str = "--zero-rank",
                ranks: int = ZERO_RANKS) -> list:
    """:func:`start_ranks`, then :func:`join_ranks`."""
    t0 = time.perf_counter()
    return join_ranks(workdir, start_ranks(workdir, flag, ranks), t0)


def tp_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 20 (c), one of the ranks (``chip_smoke.py --tp-rank R W
    DIR``): gloo over a file store, every rank's tensors on ``cuda:0``, a
    ``1xW`` mesh. zero_spec's smollm run through TrainPipeline and
    ShardedLoader: each step exactly one ``norms_flat`` and one
    ``apply_flat`` on the global rows (LAUNCHES and the rows each launch
    was given); its wall time and the time of its collectives (CUDA
    events, from the second step), the bytes each kind of collective was
    handed, the host-staged copies; the allocator's peak; a digest of
    every replicated leaf. Rank 0 writes the gathered final params to
    ``DIR/tp_params.pt``."""
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data import ShardedLoader
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import gather_params
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.train import TrainPipeline
    from repro_torch.treepath import tree_flatten_with_path, tree_leaves
    rows_seen: list = []
    record_rows(lk, rows_seen)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = mesh_from_spec(f"1x{world}", device="cuda:0")
        dev = torch.device("cuda", 0)
        with shared_inits():
            cfg, model, opt, host, batch, steps = zero_spec("smollm_f32")
            pipe = TrainPipeline(model, opt, cfg, mesh=mesh)
            state = pipe.init_state(torch.Generator().manual_seed(0), dev)
        rows = state.opt_state.slots["momentum"].shape[0]
        want = {k: int(k in ("norms_flat", "apply_flat")) for k in KERNELS}
        loader = ShardedLoader(host, dev, mesh=mesh,
                               spec=pipe.batch_specs(batch))
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms, coll_ms, moved, staged = [], [], [], [], []
        try:
            for i in range(steps):
                b = next(loader)
                lk.reset_launch_counts()
                collectives.reset_counts()
                rows_seen.clear()
                events: list = []
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                with timed_collectives(events):
                    state, m = pipe(state, b)
                torch.cuda.synchronize(dev)
                if i:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    coll_ms.append(sum(a.elapsed_time(z) for a, z in events))
                moved.append(dict(collectives.MOVED))
                staged.append(dict(collectives.STAGED))
                counts = dict(lk.LAUNCHES)
                if counts != want or rows_seen != [("norms_flat", rows),
                                                   ("apply_flat", rows)]:
                    raise AssertionError(
                        f"tp rank {rank} step {i}: launches {counts} on "
                        f"rows {rows_seen}, want {want} on {rows} rows")
                losses.append(float(m["loss"]))
        finally:
            loader.close()
        split = {p: sh.split for p, sh in
                 tree_flatten_with_path(pipe.param_shardings)[0]}
        leaves = tree_flatten_with_path(state.params)[0]
        out = {"losses": losses, "step_ms": step_ms,
               "collective_ms": coll_ms, "moved": moved, "staged": staged,
               "rows": rows, "peak_bytes": torch.cuda.max_memory_allocated(
                   dev),
               "split": sorted("/".join(p) for p, _ in leaves if split[p]),
               "replicated": {"/".join(p): hashlib.sha256(
                   x.float().cpu().numpy().tobytes()).hexdigest()
                   for p, x in leaves if not split[p]}}
        with pipe.mesh_context():
            whole = gather_params(state.params, pipe.param_shardings)
        if rank == 0:
            torch.save([t.cpu() for t in tree_leaves(whole)],
                       os.path.join(workdir, "tp_params.pt"))
        del whole, state, pipe
        torch.cuda.empty_cache()
        out["serve"] = serve_mesh_rank(world, workdir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def serve_mesh_rank(world, workdir: str, runs: dict | None = None
                    ) -> dict:
    """Phase 20 (e), in one of (c)'s ranks: each SERVE_MESH_ARGS run
    through ``launch.serve --mesh 1xW`` (``runs``: {tag: (args, mesh
    spec)} instead, as (f) serves; the counts set to 0 just before,
    read just after). Each ``decode_step`` (a tick) is timed between
    syncs, its collectives by CUDA events (``timed_collectives``) and the
    bytes it handed them (``MOVED``). The run's first stripe kernel call
    (tick 1, layer 0) is kept: its inputs, its (out, lse) and the merged
    output, in ``DIR/serve_<run>_rank<R>.pt`` (:func:`serve_mesh_merge`
    holds them against the plain version); for MLA, whose absorbed
    decode launches no kernel, its first stripe call
    (``models.mla.latent_attention``) instead. Phase 15's full-width
    deepseek run draws its weights as phase 15 does
    (DEEPSEEK_SERVE_DRAW). Returns per run: the tokens by rid, the
    report's counts, the rank's launches, the ticks' ms, collective ms
    and bytes, the peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.models import LanguageModel
    from repro_torch.models import mla
    dev = torch.device("cuda", 0)
    res = {}
    if runs is None:
        runs = {tag: (args, f"1x{world}")
                for tag, args in SERVE_MESH_ARGS.items()}
    for tag, (args, spec) in runs.items():
        tick_ms, coll_ms, moved, prefill_ms = [], [], [], []
        inner = LanguageModel.decode_step
        inner_prefill = LanguageModel.prefill_at
        inner_fd, inner_merge = kops.flash_decode, collectives.merge_stripes
        inner_latent = mla.latent_attention
        first: dict = {}

        def first_latent(q_lat, q_rope, ckv, krope, n, scale):
            got = inner_latent(q_lat, q_rope, ckv, krope, n, scale)
            if "q" not in first:
                first.update(mla=True, q=q_lat.clone(), q_rope=q_rope.clone(),
                             k=ckv.clone(), v=krope.clone(), n=n.clone(),
                             part=got[0].clone(), lse=got[1].clone(),
                             scale=scale)
            return got

        def first_stripe(q, k, v, n, **kw):
            got = inner_fd(q, k, v, n, **kw)
            if kw.get("lse") and "q" not in first:
                first.update(q=q.clone(), k=k.clone(), v=v.clone(),
                             n=n.clone(), part=got[0].clone(),
                             lse=got[1].clone(), scale=kw["scale"],
                             softcap=kw.get("softcap", 0.0))
            return got

        def first_merge(*a, **kw):
            got = inner_merge(*a, **kw)
            first.setdefault("merged", got.clone())
            return got

        def timed_prefill(self, *a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = inner_prefill(self, *a, **kw)
            torch.cuda.synchronize(dev)
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def timed(self, *a, **kw):
            torch.cuda.synchronize(dev)
            before = dict(collectives.MOVED)
            events: list = []
            t0 = time.perf_counter()
            with timed_collectives(events):
                out = inner(self, *a, **kw)
            torch.cuda.synchronize(dev)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append(sum(x.elapsed_time(y) for x, y in events))
            moved.append(sum(collectives.MOVED[k] - before[k]
                             for k in before))
            return out

        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fdk.reset_launch_counts()
        collectives.reset_counts()
        LanguageModel.decode_step = timed
        LanguageModel.prefill_at = timed_prefill
        kops.flash_decode = first_stripe
        collectives.merge_stripes = first_merge
        mla.latent_attention = first_latent
        draw = card_draws(DEEPSEEK_SERVE_DRAW) \
            if args == DEEPSEEK_SERVE_ARGS else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with draw:
                rep = serve.main(args + ["--mesh", spec])
        finally:
            LanguageModel.decode_step = inner
            LanguageModel.prefill_at = inner_prefill
            kops.flash_decode = inner_fd
            collectives.merge_stripes = inner_merge
            mla.latent_attention = inner_latent
        torch.save({k: x.cpu() if torch.is_tensor(x) else x
                    for k, x in first.items()},
                   os.path.join(workdir, f"serve_{tag}_rank"
                                f"{dist.get_rank()}.pt"))
        res[tag] = {
            "tokens": {str(f.request.rid): f.tokens.tolist()
                       for f in rep["finished"]},
            "requests": rep["requests"], "finite": rep["logits_finite"],
            "agree": rep["ranks_agree"], "ticks": rep["decode_steps"],
            "per_tick": rep["flash_decode_per_tick"],
            "stats": dict(rep["stats"]),
            "launches": fdk.LAUNCHES["flash_decode"],
            "tick_ms": tick_ms, "collective_ms": coll_ms,
            "prefill_ms": prefill_ms,
            "moved_per_tick": moved, "moved_total": dict(collectives.MOVED),
            "striped": "q" in first,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
            "wall_s": time.perf_counter() - t0}
    return res


def serve_mesh_rank_main(rank: int, world: int, workdir: str) -> None:
    """Phase 20 (e) alone, one of its ranks (``chip_smoke.py
    --serve-mesh-rank R W DIR``): gloo over a file store, the rank's
    tensors on ``cuda:0``, :func:`serve_mesh_rank`; its result in
    ``DIR/rank<R>.json`` under ``"serve"``, as (c)'s ranks write it. To
    run (e) without (c)'s training: build the kernels, then
    ``serve_mesh_against_alone([r["serve"] for r in spawn_ranks(dir,
    "--serve-mesh-rank", TP_RANKS)], dir)``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        out = {"serve": serve_mesh_rank(world, workdir)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def serve_mesh_merge(fdk, workdir: str, tag: str, nranks: int = TP_RANKS,
                     label: str = "(e)") -> dict:
    """Phase 20 (e)'s numbers: each rank's first stripe kernel call of
    run ``tag`` (tick 1, layer 0, saved by :func:`serve_mesh_rank`)
    against the plain version on the same inputs: the stripe's out
    within FD_TOL and lse within FD_LSE_RTOL of max(|lse|, 1) (-inf
    exactly where the stripe holds no key of the row), and the merged
    output, rounded to the cache's dtype as the path rounds it, within
    FD_TOL of the plain version on the whole cache (the ranks' stripes
    side by side, lengths their sum); q and the merged output
    bit-identical on every rank. Raises beyond them."""
    import torch
    dev = torch.device("cuda")
    caps = [torch.load(os.path.join(workdir, f"serve_{tag}_rank{r}.pt"))
            for r in range(nranks)]
    if caps[0].get("mla"):
        return mla_mesh_merge(caps, tag, label)
    c0 = caps[0]
    name = str(c0["k"].dtype).removeprefix("torch.")
    rtol, atol = FD_TOL[name]
    kw = dict(scale=c0["scale"], softcap=c0["softcap"])
    bad, out_err, lse_err, empty = [], 0.0, 0.0, 0
    for r, c in enumerate(caps):
        if not (torch.equal(c["q"], c0["q"])
                and torch.equal(c["merged"], c0["merged"])):
            bad.append(f"rank {r}'s q or merged output differs from rank "
                       "0's")
        q, k, v, n = (c[x].to(dev) for x in ("q", "k", "v", "n"))
        B, H, D = q.shape                  # ops.flash_decode's (B, H, D)
        G = H // k.shape[2]
        want, want_lse = fdk.flash_decode_plain(
            q.reshape(B, -1, G, D), k, v, n, lse=True, **kw)
        part = c["part"].to(dev).reshape(want.shape)
        lse = c["lse"].to(dev).reshape(want_lse.shape)
        err = (part - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()):
            bad.append(f"rank {r}'s stripe out max abs err "
                       f"{err.max().item()}")
        out_err = max(out_err, err.max().item())
        none = n == 0
        empty += int(none.sum())
        if not bool(torch.isneginf(lse[none]).all()) \
                or bool(torch.isinf(lse[~none]).any()):
            bad.append(f"rank {r}: an empty stripe row's lse is not -inf, "
                       "or a row with keys has an infinite lse")
        if bool((~none).any()):
            rel = ((lse[~none] - want_lse[~none]).abs()
                   / want_lse[~none].abs().clamp(min=1.0)).max().item()
            lse_err = max(lse_err, rel)
            if not rel <= FD_LSE_RTOL:
                bad.append(f"rank {r}'s stripe lse max rel err {rel}")
    k = torch.cat([c["k"] for c in caps], dim=1).to(dev)
    v = torch.cat([c["v"] for c in caps], dim=1).to(dev)
    q = c0["q"].to(dev).reshape(B, k.shape[2], G, D)
    lens = sum(c["n"] for c in caps).to(dev)
    whole = fdk.flash_decode_plain(q, k, v, lens, lse=True, **kw)[0]
    got = c0["merged"].to(dev).reshape(whole.shape).to(c0["k"].dtype)
    want = whole.to(c0["k"].dtype).float()
    err = (got.float() - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        bad.append(f"merged max abs err {err.max().item()} against the "
                   "plain version on the whole cache")
    res = {"shape": list(k.shape), "dtype": name,
           "stripe_max_abs_err": out_err, "stripe_lse_max_rel_err": lse_err,
           "empty_stripe_rows": empty, "merged_max_abs_err":
           err.max().item()}
    log(f"  {label} {tag}, tick 1 layer 0 on the ranks' stripes (whole cache "
        f"{list(k.shape)} {name}): stripes against the plain version out "
        f"{out_err:.3g}, lse rel {lse_err:.3g} ({empty} empty stripe rows "
        f"at -inf); merged against the plain whole {err.max().item():.3g}")
    if bad:
        raise AssertionError(f"serving mesh {tag}: " + "; ".join(bad))
    return res


def mla_plain(q_lat, q_rope, ckv, krope, n, scale: float) -> tuple:
    """The plain absorbed decode's attention on a whole latent cache, as
    the reference's ``mla_decode`` computes it: each head's scaled scores
    against the first ``n`` rows of its sequence, masked to -1e30 and
    softmaxed,
    the probability-weighted latents (B, H, r); and the scores'
    log-sum-exp (B, H), -inf where a sequence has no row. All in f32."""
    import torch
    ckv, krope = ckv.float(), krope.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
         + torch.einsum("bhe,bse->bhs", q_rope, krope)) * scale
    valid = torch.arange(ckv.shape[1], device=ckv.device) \
        < n[:, None, None]
    probs = torch.softmax(torch.where(valid, s, -1.0e30), dim=-1)
    return (torch.einsum("bhs,bsr->bhr", probs, ckv),
            torch.logsumexp(torch.where(valid, s, -torch.inf), dim=-1))


def mla_mesh_merge(caps: list, tag: str, label: str) -> dict:
    """Phase 20 (g)'s first tick, layer 0, on each rank's stripe of the
    latent cache (``caps``: what :func:`serve_mesh_rank` kept of the first
    ``latent_attention`` call and merge): each stripe's out_lat and lse
    against :func:`mla_plain` on the stripe within MLA_MERGE_TOL (out_lat
    exactly 0 and lse -inf where the stripe holds no row of a sequence),
    and the merged latent against :func:`mla_plain` on the whole cache
    (the stripes side by side, the lengths summed); the queries and the
    merged latent bit-identical on every rank. Raises beyond them."""
    import torch
    dev = torch.device("cuda")
    rtol, atol = MLA_MERGE_TOL
    c0 = caps[0]
    bad, out_err, lse_err, empty = [], 0.0, 0.0, 0
    for r, c in enumerate(caps):
        if not all(torch.equal(c[k], c0[k]) for k in ("q", "q_rope",
                                                     "merged")):
            bad.append(f"rank {r}'s queries or merged latent differ from "
                       "rank 0's")
        q, qr, k, v, n = (c[x].to(dev) for x in ("q", "q_rope", "k", "v",
                                                  "n"))
        want, want_lse = mla_plain(q, qr, k, v, n, c["scale"])
        part, lse = c["part"].to(dev), c["lse"].to(dev)
        none = (n == 0)[:, None].expand(lse.shape)
        empty += int((n == 0).sum())
        if not (bool((part[none] == 0).all())
                and bool(torch.isneginf(lse[none]).all())
                and bool(torch.isfinite(lse[~none]).all())):
            bad.append(f"rank {r}: an empty stripe row is not (0, -inf), "
                       "or a row with keys has an infinite lse")
        if bool((~none).any()):
            err = (part - want).abs()[~none]
            out_err = max(out_err, err.max().item())
            if not bool((err <= atol + rtol * want.abs()[~none]).all()):
                bad.append(f"rank {r}'s stripe out_lat max abs err "
                           f"{err.max().item()}")
            rel = ((lse - want_lse).abs()[~none]
                   / want_lse.abs()[~none].clamp(min=1.0)).max().item()
            lse_err = max(lse_err, rel)
            if not rel <= rtol:
                bad.append(f"rank {r}'s stripe lse max rel err {rel}")
    k = torch.cat([c["k"] for c in caps], dim=1).to(dev)
    v = torch.cat([c["v"] for c in caps], dim=1).to(dev)
    lens = sum(c["n"] for c in caps).to(dev)
    whole = mla_plain(c0["q"].to(dev), c0["q_rope"].to(dev), k, v, lens,
                      c0["scale"])[0]
    err = (c0["merged"].to(dev) - whole).abs()
    if not bool((err <= atol + rtol * whole.abs()).all()):
        bad.append(f"merged max abs err {err.max().item()} against the "
                   "plain absorbed decode on the whole latent cache")
    res = {"shape": list(k.shape), "dtype": str(k.dtype).removeprefix(
        "torch."), "stripe_max_abs_err": out_err,
        "stripe_lse_max_rel_err": lse_err, "empty_stripe_rows": empty,
        "merged_max_abs_err": err.max().item(), "tol": list(MLA_MERGE_TOL)}
    log(f"  {label} {tag}, tick 1 layer 0 on the ranks' stripes of the "
        f"latent cache (whole {list(k.shape)} {res['dtype']}, "
        f"{c0['q'].shape[1]} heads): stripes against the plain absorbed "
        f"decode out_lat {out_err:.3g}, lse rel {lse_err:.3g} ({empty} "
        f"empty stripe rows at (0, -inf)); merged against the plain whole "
        f"{err.max().item():.3g} (tolerance rtol {rtol:g}, atol {atol:g})")
    if bad:
        raise AssertionError(f"serving mesh {tag}: " + "; ".join(bad))
    return res


def serve_mesh_against_alone(ranks: list, workdir: str,
                             runs: dict | None = None,
                             part: str = "(e)",
                             alone: dict | None = None) -> dict:
    """Phase 20 (e)'s gates (and (f)'s: ``runs`` {tag: (args, mesh
    spec)}, ``part`` the label), in the parent once the ranks have
    ended, ``ranks`` each rank's serving results: each run alone on the
    card (:func:`serve_alone`, or ``alone``, its result), then every
    rank's run against it, and where the ranks held stripes the first
    tick's stripes and merge against the plain version
    (:func:`serve_mesh_merge`). Reduced f32: tokens identical. Full
    width, bf16: every request finished with finite logits, one
    ``decode_step`` a tick with a launch a layer on every rank and none
    outside the ticks, the scheduler digests equal, the ranks' tokens
    equal; the share of requests whose tokens equal the run alone's,
    tick ms, the share of a tick in collectives, bytes a tick and peaks
    logged."""
    from repro_torch.kernels import flash_decode as fdk
    res = {}
    if runs is None:
        runs = {tag: (args, f"1x{TP_RANKS}")
                for tag, args in SERVE_MESH_ARGS.items()}
    # one run alone for every mesh of the same arguments
    done = alone if alone is not None else serve_alone(
        dict.fromkeys(tuple(a) for a, _ in runs.values()))
    for tag, (args, spec) in runs.items():
        rep, launched = done[tuple(args)]
        alone = {str(f.request.rid): f.tokens.tolist()
                 for f in rep["finished"]}
        per, n_req = rep["flash_decode_per_tick"], int(args[args.index(
            "--requests") + 1])
        bad = []
        if launched["flash_decode"] != per * rep["decode_steps"]:
            bad.append(f"alone: {launched} for {rep['decode_steps']} "
                       "ticks")
        for r, rk in enumerate(ranks):
            got = rk[tag]
            st = got["stats"]
            if got["requests"] != n_req or not got["finite"] \
                    or got["agree"] is not True:
                bad.append(f"rank {r}: {got['requests']} of {n_req} "
                           f"requests, finite {got['finite']}, digests "
                           f"agree {got['agree']}")
            if got["ticks"] == 0 or st["decode_calls"] != got["ticks"] \
                    or got["launches"] != per * got["ticks"] \
                    or st["flash_decode_launches"] != got["launches"] \
                    or st["flash_decode_outside_ticks"]:
                bad.append(f"rank {r}: {got['launches']} flash_decode "
                           f"launches for {got['ticks']} ticks, want {per} "
                           f"a tick; {st}")
            if got["tokens"] != ranks[0][tag]["tokens"]:
                bad.append(f"rank {r}'s tokens differ from rank 0's")
        mine = ranks[0][tag]["tokens"]
        same = sum(mine.get(k) == v for k, v in alone.items()) / len(alone)
        if "reduced" in tag and same != 1.0:
            bad.append(f"greedy tokens equal the run alone's for {same:.1%} "
                       "of the requests")
        r0 = ranks[0][tag]
        share = statistics.median(
            c / t for c, t in zip(r0["collective_ms"], r0["tick_ms"]))
        res[tag] = {
            "requests": r0["requests"], "ticks": r0["ticks"],
            "launches_per_tick": [rk[tag]["launches"]
                                  / rk[tag]["ticks"]
                                  for rk in ranks],
            "tokens_equal_alone_share": same,
            "tick_ms_median": [statistics.median(rk[tag]["tick_ms"])
                               for rk in ranks],
            "alone_tick_ms": 1e3 * rep["wall_s"] / max(rep["decode_steps"],
                                                        1),
            "prefill_s": sum(r0["prefill_ms"]) / 1e3,
            "collective_share": share,
            "moved_per_tick": statistics.median(r0["moved_per_tick"]),
            "moved_total": r0["moved_total"],
            "peak_bytes": [rk[tag]["peak_bytes"] for rk in ranks],
            "wall_s": [rk[tag]["wall_s"] for rk in ranks],
            "alone_wall_s": rep["wall_s"]}
        if ranks[0][tag]["striped"]:
            res[tag]["first_merge"] = serve_mesh_merge(fdk, workdir, tag,
                                                       len(ranks), part)
        striped = ("on its stripe of the cache, the stripes merged by "
                   "log-sum-exp" if ranks[0][tag]["striped"]
                   else "the sequence whole")
        x = res[tag]
        log(f"  {part} serving mesh, {tag}, {spec} ({' '.join(args[:4])}"
            f"): {x['requests']} requests in {x['ticks']} ticks, "
            f"flash_decode {per} a tick on every rank ({striped}), digests "
            f"equal; tokens equal the run alone's for "
            f"{same:.1%} of the requests; tick ms "
            + " ".join(f"{t:.2f}" for t in x["tick_ms_median"])
            + f" (alone, admissions included: {x['alone_tick_ms']:.2f}), "
            f"prefills {x['prefill_s']:.1f} s, "
            f"{share:.1%} of rank 0's tick in collectives, "
            f"{x['moved_per_tick']:,} B a tick a rank handed to them; peak "
            + ", ".join(f"{b / 2 ** 20:.1f}" for b in x["peak_bytes"])
            + " MiB; wall " + " ".join(f"{w:.1f}" for w in x["wall_s"])
            + f" s (alone {x['alone_wall_s']:.1f})")
        if bad:
            raise AssertionError(f"serving mesh {tag}: " + "; ".join(bad))
    return res


def tp_against_alone(ranks: list, tdir: str, alone: dict) -> dict:
    """Phase 20 (c)'s gates: the ranks' losses equal; every replicated
    leaf bit-identical across the ranks; one ``norms_flat`` and one
    ``apply_flat`` a step a rank on the global rows (checked in the
    ranks); the gathered final params against the run alone (``alone``:
    (a)'s smollm run at one microbatch: its result, init and final
    params) within TP_PARAM_RTOL, its losses within ZERO_MESH_RTOL.
    Step ms, the share in collectives, bytes a step and the peaks
    logged."""
    import torch
    r0 = ranks[0]
    for r, rk in enumerate(ranks):
        if rk["losses"] != r0["losses"]:
            raise AssertionError(f"tp rank {r} losses {rk['losses']} != "
                                 f"rank 0's {r0['losses']}")
        if rk["replicated"] != r0["replicated"]:
            bad = sorted(k for k in r0["replicated"]
                         if rk["replicated"][k] != r0["replicated"][k])
            raise AssertionError(f"tp rank {r}: replicated leaves {bad} "
                                 "differ from rank 0's")
        if rk["rows"] != TP_ROWS:
            raise AssertionError(f"tp rank {r}: {rk['rows']} rows")
    base = alone["result"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                  base["losses"]))
    params = torch.load(os.path.join(tdir, "tp_params.pt"),
                        map_location="cuda")
    drift = param_drift(params, alone["final"], alone["init"])
    drift["worst_leaf_path"] = base["leaf_paths"][
        drift.pop("worst_leaf_index")]
    del params
    share = statistics.median(c / t for c, t in zip(r0["collective_ms"],
                                                    r0["step_ms"]))
    res = {"losses": r0["losses"], "rel_to_alone": rel, "drift": drift,
           "step_ms": [rk["step_ms"] for rk in ranks],
           "collective_share": share, "moved": r0["moved"][-1],
           "staged": r0["staged"][-1],
           "peak_bytes": [rk["peak_bytes"] for rk in ranks],
           "alone_peak_bytes": base["peak_bytes"],
           "alone_losses": base["losses"], "split": r0["split"],
           "replicated": sorted(r0["replicated"])}
    log("\n      ".join([
        f"  (c) tensor parallelism, {TP_RANKS} ranks on a 1x{TP_RANKS} "
        f"mesh (smollm-135m whole; split: {', '.join(r0['split'])}; "
        f"replicated, bit-identical across the ranks: "
        f"{', '.join(sorted(r0['replicated']))})",
        "losses " + " ".join(f"{x:.5f}" for x in r0["losses"])
        + f" (equal on every rank) vs alone rel {rel:.3g} (limit "
        f"{ZERO_MESH_RTOL:g})",
        f"params against the run alone: {drift['whole']:.4g} of its "
        f"change (worst leaf {drift['worst_leaf']:.3g} "
        f"{drift['worst_leaf_path']}; limit {TP_PARAM_RTOL:g}, an "
        "unchanged state 1.0)",
        f"launches a rank: 1 norms_flat + 1 apply_flat a step on "
        f"{TP_ROWS} rows",
        "step ms " + "; ".join(
            f"rank{r} " + " ".join(f"{t:.2f}" for t in rk["step_ms"])
            for r, rk in enumerate(ranks))
        + f" (the run alone: {statistics.median(base['step_ms']):.2f}), "
        f"{share:.1%} of rank 0's in collectives (three ranks share one "
        "card: the transport, not a scaling)",
        "bytes a step a rank: " + ", ".join(
            f"{k} {v:,}" for k, v in r0["moved"][-1].items())
        + f"; staged {r0['staged'][-1]}",
        "peak a rank " + ", ".join(
            f"{rk['peak_bytes'] / 2**20:.1f}" for rk in ranks)
        + f" MiB (alone {base['peak_bytes'] / 2**20:.1f})"]))
    if not rel <= ZERO_MESH_RTOL:
        raise AssertionError(f"tp: losses rel {rel} against the run alone")
    if not drift["whole"] <= TP_PARAM_RTOL:
        raise AssertionError(f"tp: params {drift} of the run alone's "
                             "change from their init")
    return res


def zero_nccl_start(workdir: str) -> tuple:
    """Phase 20 (b), started with (a)'s and (c)'s ranks:
    ``launch.train --mesh 1x1 --zero`` under
    ``torchrun --standalone --nproc-per-node 1`` (NCCL: the step's
    reduce-scatter and loss all-reduce go through the backend on one
    rank). Mostly process start; its few steps are a reduced model's.
    Returns (process, its log file, start time)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    log_f = open(os.path.join(workdir, "nccl.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.train"]
        + ZERO_NCCL_ARGS + ["--mesh", "1x1", "--zero", "--checkpoint",
                            os.path.join(workdir, "nccl.npz")],
        env=env, stdout=log_f, stderr=subprocess.STDOUT)
    return proc, log_f, time.perf_counter()


def zero_nccl_finish(train, workdir: str, started: tuple) -> dict:
    """Phase 20 (b): wait for the torchrun run, then the same run without
    a mesh in this process; the two checkpoints must hold the same
    arrays, member for member."""
    import zipfile
    proc, log_f, t0 = started
    try:
        rc = proc.wait(timeout=ZERO_JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_f.close()
    wall = time.perf_counter() - t0
    with open(os.path.join(workdir, "nccl.log")) as f:
        text = f.read()
    if rc:
        log(text[-3000:])
        raise AssertionError(f"torchrun exit {rc}")
    mine = os.path.join(workdir, "plain.npz")
    summary = train.main(ZERO_NCCL_ARGS + ["--checkpoint", mine])

    def members(path):
        with zipfile.ZipFile(path) as z:
            return [(n, z.read(n)) for n in z.namelist()]
    same = members(mine) == members(os.path.join(workdir, "nccl.npz"))
    line = next((s for s in text.splitlines() if "mesh=" in s), "")
    done = next((s for s in text.splitlines() if s.startswith("done:")), "")
    log(f"  (b) torchrun, one rank, NCCL: {line.strip()}\n      {done}\n"
        f"      checkpoint identical to the run without a mesh: {same} "
        f"(torchrun {wall:.1f} s from its start to its end)")
    if not same or "zero=True" not in line:
        raise AssertionError("the one-rank NCCL run differs")
    return {"identical": same, "losses": summary["losses"],
            "wall_s": wall}


def zero_alone(name: str, rows_seen: list) -> dict:
    """Phase 20 (a)'s run ``name`` alone in this process, at one
    microbatch (its result, init and final params) and split into
    ``ZERO_RANKS`` microbatches as the ranks split the batch (its result
    and final params), for :func:`zero_against_alone`."""
    alone, init, final = zero_run(name, None, False, rows_seen)
    split, _, split_final = zero_run(name, None, False, rows_seen,
                                     accum=ZERO_RANKS)
    return {"result": alone, "init": init, "final": final, "split": split,
            "split_final": split_final}


def zero_against_alone(name: str, ranks: list, zdir: str, runs: dict
                       ) -> dict:
    """Phase 20 (a)'s gates on one run: ZeRO against replicated on each
    rank, the ranks' params against each other, and both against the
    same run alone in this process (``runs``: :func:`zero_alone`'s), at
    one microbatch (losses within ``ZERO_MESH_RTOL``) and split into
    ``ZERO_RANKS`` microbatches as the ranks split the batch (params
    within ``ZERO_PARAM_RTOL``); slot bytes, peaks, step ms and the share
    in collectives logged."""
    import torch
    alone, init, final = runs["result"], runs["init"], runs["final"]
    split, split_final = runs["split"], runs["split_final"]
    res = {"alone": {k: alone[k] for k in (
        "losses", "peak_bytes", "slot_bytes", "rows")},
           "split": {"losses": split["losses"]}}
    # the gate's reading of an unchanged state
    res["unchanged_drift"] = param_drift(init, split_final, init)
    params = [torch.load(os.path.join(
        zdir, f"params_{name}_rank{r}.pt"), map_location="cuda")
        for r in range(ZERO_RANKS)]
    for r, rank in enumerate(ranks):
        got = rank[name]
        if not got["identical"]:
            log(f"  {name} rank {r}: ZeRO and replicated differ "
                f"(max param gap {got['max_param_gap']}; losses "
                f"{got['zero']['losses']} vs "
                f"{got['replicated']['losses']})")
            raise AssertionError(f"{name}: ZeRO != replicated")
        if not all(torch.equal(a, b)
                   for a, b in zip(params[r], params[0])):
            raise AssertionError(f"{name}: rank {r}'s params "
                                 "differ from rank 0's")
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            got["zero"]["losses"], alone["losses"]))
        drift = param_drift(params[r], split_final, init)
        drift["bit_identical"] = all(
            torch.equal(a, b) for a, b in zip(params[r],
                                              split_final))
        whole = param_drift(params[r], final, init)
        for d in (drift, whole):
            d["worst_leaf_path"] = alone["leaf_paths"][
                d.pop("worst_leaf_index")]
        if not rel <= ZERO_MESH_RTOL:
            raise AssertionError(f"{name} rank {r}: rel {rel} "
                                 "against the run alone")
        if not drift["whole"] <= ZERO_PARAM_RTOL:
            raise AssertionError(
                f"{name} rank {r}: params {drift} of the split "
                f"run's change from their init (an unchanged "
                f"state reads {res['unchanged_drift']['whole']})")
        z = got["zero"]
        if z["slot_bytes"] * ZERO_RANKS != z["whole_slot_bytes"]:
            raise AssertionError(f"{name}: slot bytes "
                                 f"{z['slot_bytes']}")
        res[f"rank{r}"] = dict(got, rel_to_alone=rel,
                               drift_to_split=drift,
                               drift_to_alone=whole)
    del params
    z0 = ranks[0][name]["zero"]
    share = statistics.median(
        c / t for c, t in zip(z0["collective_ms"], z0["step_ms"]))
    res["collective_share"] = share
    rep = ranks[0][name]["replicated"]
    launched = ", ".join(
        f"rank{r} " + " ".join(
            f"{k} {n} on {rk[name]['zero']['launch_rows'][k]}"
            for k, n in rk[name]["zero"]["launches"].items() if n)
        for r, rk in enumerate(ranks))

    def drifts(key):
        return "; ".join(
            f"rank{r} {d['whole']:.3g} (worst leaf "
            f"{d['worst_leaf']:.3g} {d['worst_leaf_path']}"
            + (f"; bit-identical {d['bit_identical']}"
               if "bit_identical" in d else "") + ")"
            for r, d in ((r, res[f"rank{r}"][key])
                         for r in range(ZERO_RANKS)))
    log("\n      ".join([
        f"  {name}: {ZERO_RANKS} ranks, {z0['rows']} of "
        f"{z0['total_rows']} rows a rank ({z0['pad_rows']} pad "
        f"rows, inert: {ranks[-1][name]['zero']['pad_inert']}); "
        f"ZeRO == replicated bit for bit; launches {launched}",
        "losses " + " ".join(f"{x:.5f}" for x in z0["losses"][:3])
        + " ... vs alone rel " + " ".join(
            f"{res[f'rank{r}']['rel_to_alone']:.3g}"
            for r in range(ZERO_RANKS)),
        "params against the run alone split as the ranks split "
        f"({ZERO_RANKS} microbatches): {drifts('drift_to_split')}"
        f" (limit {ZERO_PARAM_RTOL:g} on the whole vector; an "
        f"unchanged state {res['unchanged_drift']['whole']:.3g})",
        "params against the run alone at one microbatch (not "
        f"gated): {drifts('drift_to_alone')}",
        f"slot bytes a rank {z0['slot_bytes']:,} of "
        f"{z0['whole_slot_bytes']:,} (replicated "
        f"{rep['slot_bytes']:,}); peak rank0 "
        f"{z0['peak_bytes'] / 2**20:.1f} MiB, rank1 "
        f"{ranks[1][name]['zero']['peak_bytes'] / 2**20:.1f} MiB "
        f"(replicated {rep['peak_bytes'] / 2**20:.1f}, alone "
        f"{alone['peak_bytes'] / 2**20:.1f})",
        f"step ms {statistics.median(z0['step_ms']):.2f} "
        f"(replicated {statistics.median(rep['step_ms']):.2f}), "
        f"{share:.1%} of it in collectives; staged per step "
        f"{z0['staged'][-1]}"]))
    return res


def kept_slots(box: dict, experts: int):
    """(n, E) bool: which (token, expert) slots a first routing kept."""
    import torch
    kept = torch.zeros(box["ids"].shape[0], experts, dtype=torch.bool)
    return kept.scatter_(1, box["ids"].long(), box["keep"])


def moe_mesh_alone(rows_seen: list) -> dict:
    """Phase 20 (f)'s runs alone on the card, in this process: the
    MOE_MESH_TRAIN run (its result and first routing) and each
    MOE_MESH_SERVE run through ``launch.serve`` without ``--mesh``
    (:func:`serve_alone`)."""
    import torch
    with first_routing({}) as box:
        alone, init, final = zero_run("granite_f32", None, False, rows_seen)
    del init, final
    torch.cuda.empty_cache()
    return {"result": alone, "box": box,
            "serve": serve_alone(MOE_MESH_SERVE.values())}


def serve_alone(runs) -> dict:
    """Each ``launch.serve`` argument list of ``runs`` without a mesh on
    the card, the ``flash_decode`` counts set to 0 just before it and
    read just after: {tuple(args): (report, launches)}."""
    import torch
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.launch import serve
    done = {}
    for args in runs:
        fdk.reset_launch_counts()
        done[tuple(args)] = (serve.main(list(args)), dict(fdk.LAUNCHES))
        torch.cuda.synchronize()
    return done


def moe_mesh_against_alone(ranks: list, zdir: str, alone_runs: dict
                           ) -> dict:
    """Phase 20 (f)'s gates, in the parent once (a)'s ranks have ended,
    against :func:`moe_mesh_alone`'s runs: the share of the run alone's kept
    (token, expert) slots of step 0's layer 0 that the mesh's routing
    differs in (2x1: the two ranks' rows side by side; 1x2: both ranks'
    the same) under MOE_MESH_SLOT_SHARE, the ranks' losses equal and
    within MOE_MESH_LOSS_RTOL of the run alone's, the replicated leaves
    bit-identical across 1x2's ranks (one ``norms_flat`` and one
    ``apply_flat`` a step a rank was checked in the ranks); step ms,
    the share in collectives and the peaks printed. Then the serving
    runs against theirs alone (:func:`serve_mesh_against_alone`)."""
    import torch
    from repro_torch.configs import get_config
    experts = get_config(GRANITE).num_experts
    alone, box = alone_runs["result"], alone_runs["box"]
    want = kept_slots(box, experts)
    slots = box["keep"].numel()
    res = {"alone": {k: alone[k] for k in ("losses", "step_ms",
                                           "peak_bytes", "rows")},
           "alone_dropped_share": 1 - float(want.sum()) / slots}
    lines = [f"  (f) the moe family on meshes: granite-moe-3b-a800m at full "
             f"width, {MOE_MESH_LAYERS} layer, f32 LARS, "
             f"{MOE_MESH_TRAIN[2]} steps of {MOE_MESH_TRAIN[0]} x "
             f"{MOE_MESH_TRAIN[1]} tokens; alone: losses "
             + " ".join(f"{x:.5f}" for x in alone["losses"])
             + f", step 0 layer 0 drops {res['alone_dropped_share']:.4f} "
             f"of {slots:,} slots, step ms "
             f"{statistics.median(alone['step_ms']):.2f}, peak "
             f"{alone['peak_bytes'] / 2**20:.1f} MiB"]
    bad = []
    for tag in MOE_MESHES:
        got = [rk["moe"][tag] for rk in ranks]
        boxes = [torch.load(os.path.join(zdir, f"moe_keep_{tag}_rank{r}.pt"))
                 for r in range(len(ranks))]
        if tag.startswith("1x"):
            if not all(torch.equal(b["keep"], boxes[0]["keep"])
                       and torch.equal(b["ids"], boxes[0]["ids"])
                       for b in boxes):
                bad.append(f"{tag}: the model ranks routed apart")
            mine = kept_slots(boxes[0], experts)
        else:
            mine = torch.cat([kept_slots(b, experts) for b in boxes])
        differ = float((mine ^ want).sum()) / float(want.sum())
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"],
                                                      alone["losses"]))
        share = statistics.median(c / t for c, t in zip(
            got[0]["collective_ms"], got[0]["step_ms"]))
        res[tag] = {"losses": got[0]["losses"], "rel_to_alone": rel,
                    "kept_differ_share": differ,
                    "step_ms": [g["step_ms"] for g in got],
                    "collective_share": share,
                    "peak_bytes": [g["peak_bytes"] for g in got],
                    "split": got[0].get("split"),
                    "replicated": sorted(got[0].get("replicated", {}))}
        if any(g["losses"] != got[0]["losses"] for g in got):
            bad.append(f"{tag}: the ranks' losses differ")
        if tag.startswith("1x") and any(
                g["replicated"] != got[0]["replicated"] for g in got):
            bad.append(f"{tag}: a replicated leaf differs across the ranks")
        if not differ < MOE_MESH_SLOT_SHARE:
            bad.append(f"{tag}: {differ:.4%} of the kept slots differ")
        if not rel <= MOE_MESH_LOSS_RTOL:
            bad.append(f"{tag}: losses rel {rel} against the run alone")
        steps = "; ".join(f"rank{r} " + " ".join(
            f"{t:.2f}" for t in g["step_ms"]) for r, g in enumerate(got))
        split = "" if not got[0].get("split") else (
            f"; split {', '.join(got[0]['split'])}; replicated, "
            "bit-identical across the ranks: "
            + ", ".join(sorted(got[0]["replicated"])))
        lines.append(
            f"{tag}: losses "
            + " ".join(f"{x:.5f}" for x in got[0]["losses"])
            + f" (equal on both ranks) vs alone rel {rel:.3g} (limit "
            f"{MOE_MESH_LOSS_RTOL:g}); step 0 layer 0's kept (token, "
            f"expert) slots differ from the run alone's in {differ:.4%} "
            f"(limit {MOE_MESH_SLOT_SHARE:.0%}); 1 norms_flat + 1 "
            f"apply_flat a step a rank on {got[0]['rows']} rows; step ms "
            f"{steps}, {share:.1%} of rank 0's in collectives; peak a "
            "rank " + ", ".join(f"{g['peak_bytes'] / 2**20:.1f}"
                                for g in got) + " MiB" + split)
    log("\n      ".join(lines))
    if bad:
        raise AssertionError("moe on meshes: " + "; ".join(bad))
    res["serve"] = serve_mesh_against_alone(
        [rk["moe"]["serve"] for rk in ranks], zdir,
        runs={f"{name}_{tag}": (args, tag)
              for name, args in MOE_MESH_SERVE.items() for tag in MOE_MESHES},
        part="(f)", alone=alone_runs["serve"])
    return res


def mla_mesh_against_alone(ranks: list, zdir: str, alone: dict) -> dict:
    """Phase 20 (g)'s gates, in the parent once the ranks have ended,
    against phase 15's runs (``alone``, :func:`mla_alone`'s ``keep``, with
    the reduced serving run alone added): both ranks routed step 0 layer
    0 alike, and its kept (token, expert) slots differ from the run
    alone's in under MOE_MESH_SLOT_SHARE; the ranks' losses equal and
    within MOE_MESH_LOSS_RTOL of the run alone's first MLA_MESH_STEPS;
    every step of every rank one ``norms_flat`` and one ``apply_flat`` on
    the global rows (the run alone's); the replicated leaves (``q_down``,
    ``q_norm``, ``kv_down``, ``kv_norm``, the router, the norms among
    them) bit-identical across the ranks; step ms, the share in
    collectives, the bytes handed to them and the peaks printed. Then the
    serving runs against theirs alone (:func:`serve_mesh_against_alone`)."""
    import torch
    cfg = deepseek_cfg()
    train_alone = alone["train"]
    want = kept_slots(train_alone["box"], cfg.num_experts)
    got = [rk["mla"] for rk in ranks]
    boxes = [torch.load(os.path.join(zdir, f"mla_keep_rank{r}.pt"))
             for r in range(len(ranks))]
    bad = []
    if not all(torch.equal(b["keep"], boxes[0]["keep"])
               and torch.equal(b["ids"], boxes[0]["ids"]) for b in boxes):
        bad.append("the model ranks routed apart")
    differ = float((kept_slots(boxes[0], cfg.num_experts) ^ want).sum()) \
        / float(want.sum())
    ref = train_alone["losses"][:MLA_MESH_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], ref))
    rows = train_alone["rows"]
    step = [("norms_flat", rows), ("apply_flat", rows)]
    per = {"norms_flat": 1, "apply_flat": 1, "apply_flat_q8": 0}
    if any(g["losses"] != got[0]["losses"] for g in got):
        bad.append("the ranks' losses differ")
    if any(g["replicated"] != got[0]["replicated"] for g in got):
        bad.append("a replicated leaf differs across the ranks")
    named = ("q_down", "q_norm", "kv_down", "kv_norm")
    if not all(f"layers/attn/{n}" in got[0]["replicated"] for n in named) \
            or "layers/moe/router" not in got[0]["replicated"]:
        bad.append(f"not replicated: {sorted(got[0]['replicated'])}")
    for r, g in enumerate(got):
        if len(g["steps"]) != MLA_MESH_STEPS or g["rows"] != rows or any(
                st["launches"] != per or [tuple(x) for x in st["rows"]]
                != step for st in g["steps"]):
            bad.append(f"rank {r}: launches "
                       f"{[st['launches'] for st in g['steps']]} on rows "
                       f"{[st['rows'] for st in g['steps']]}, want {per} on "
                       f"{rows} rows a step")
    if not differ < MOE_MESH_SLOT_SHARE:
        bad.append(f"{differ:.4%} of the kept slots differ")
    if not rel <= MOE_MESH_LOSS_RTOL:
        bad.append(f"losses rel {rel} against the run alone")
    share = statistics.median(st["collective_ms"] / st["ms"]
                              for st in got[0]["steps"])
    res = {"losses": got[0]["losses"], "alone_losses": ref,
           "rel_to_alone": rel, "kept_differ_share": differ,
           "rows": rows, "launches": [
               {k: sum(st["launches"][k] for st in g["steps"]) for k in per}
               for g in got], "split": got[0]["split"],
           "replicated": sorted(got[0]["replicated"]),
           "step_ms": [[st["ms"] for st in g["steps"]] for g in got],
           "collective_share": share,
           "moved_per_step": [st["moved"] for st in got[0]["steps"]],
           "staged_per_step": [st["staged"] for st in got[0]["steps"]],
           "peak_bytes": [g["peak_bytes"] for g in got],
           "alone_peak_bytes": train_alone["peak_bytes"],
           "alone_step_ms": train_alone["step_ms"]}
    moved = got[0]["steps"][-1]["moved"]
    log(f"  (g) MLA on {MLA_MESH}: {DEEPSEEK} at full width, "
        f"{DEEPSEEK_LAYERS} layer, {cfg.num_experts} routed experts, "
        f"f32 LARS, {MLA_MESH_STEPS} steps of {DEEPSEEK_BATCH} x 4096 "
        f"tokens: losses " + " ".join(f"{x:.5f}" for x in got[0]["losses"])
        + " (equal on both ranks) vs phase 15's " + " ".join(
            f"{x:.5f}" for x in ref) + f", rel {rel:.3g} (limit "
        f"{MOE_MESH_LOSS_RTOL:g}); step 0 layer 0's kept (token, expert) "
        f"slots differ from phase 15's in {differ:.4%} (limit "
        f"{MOE_MESH_SLOT_SHARE:.0%}); 1 norms_flat + 1 apply_flat a step a "
        f"rank on the global {rows:,} rows; step ms " + "; ".join(
            f"rank{r} " + " ".join(f"{t:.2f}" for t in ms)
            for r, ms in enumerate(res["step_ms"]))
        + f" (phase 15's run alone: {train_alone['step_ms']:.2f} a step, "
        f"its first included), {share:.1%} of rank 0's in collectives; "
        f"bytes handed a step (rank 0): " + ", ".join(
            f"{k} {v:,}" for k, v in moved.items() if v)
        + "; peak a rank " + ", ".join(
            f"{b / 2**20:.1f}" for b in res["peak_bytes"])
        + f" MiB (alone {train_alone['peak_bytes'] / 2**20:.1f}; the card "
        f"had {got[0]['free_bytes_at_start'] / 2**30:.1f} GiB free at "
        f"rank 0's start); split "
        f"{', '.join(res['split'])}; replicated, bit-identical across the "
        f"ranks: {', '.join(res['replicated'])}")
    if bad:
        raise AssertionError("MLA on meshes: " + "; ".join(bad))
    res["serve"] = serve_mesh_against_alone(
        [g["serve"] for g in got], zdir,
        runs={tag: (args, MLA_MESH) for tag, args in MLA_MESH_SERVE.items()},
        part="(g)", alone=alone["serve"])
    return res


def zero_phase(train, lk, bw: float, flops: float, floor: float,
               workdir: str, mla_keep: dict) -> dict:
    """Phase 20: data parallelism, ZeRO, tensor, expert and MLA's head
    parallelism on the card. (a)'s two ranks (then (f) in them), (c)'s
    three and (b)'s torchrun start together (each mesh its own process
    group), and this process runs (a)'s and (f)'s runs alone and (e)'s and
    (g)'s reduced serving run alone beside them, for the script's time
    limit: the step times each logs were taken beside the others'
    processes. (g)'s two ranks start once those have ended (each needs
    ~37 GiB); its other runs alone are phase 15's (``mla_keep``,
    :func:`mla_alone`). The gates come once the ranks have ended."""
    import torch
    out = {"two_ranks": {}, "wall_s": {}}
    zdir, tdir, gdir = (os.path.join(workdir, d)
                        for d in ("zero", "tp", "mla"))
    for d in (zdir, tdir, gdir):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zprocs = start_ranks(zdir)
    tprocs = start_ranks(tdir, "--tp-rank", TP_RANKS)
    nccl = zero_nccl_start(zdir)
    rows_seen: list = []
    saved = record_rows(lk, rows_seen)
    try:
        # the runs alone, while the ranks run (their step ms are taken
        # beside the ranks' processes; no gate reads a time)
        torch.backends.cudnn.deterministic = True
        with shared_inits():        # one host draw of each model's init
            runs = {name: zero_alone(name, rows_seen) for name in ZERO_RUNS}
            moe_alone = moe_mesh_alone(rows_seen)
        serve_runs = serve_alone(list(SERVE_MESH_ARGS.values())
                                 + [MLA_MESH_SERVE["mla_reduced"]])
        mla_keep["serve"].update(serve_runs)
        out["wall_s"]["alone_beside_ranks"] = time.perf_counter() - t0
        ranks = join_ranks(zdir, zprocs, t0)
        out["wall_s"]["two_ranks"] = time.perf_counter() - t0
        tp_ranks = join_ranks(tdir, tprocs, t0)
        out["wall_s"]["tp_ranks"] = time.perf_counter() - t0
    except BaseException:
        stop_ranks(zprocs)
        stop_ranks(tprocs)
        nccl[0].kill()
        nccl[0].wait()
        nccl[1].close()
        torch.backends.cudnn.deterministic = False
        for k, fn in saved.items():
            setattr(lk, k, fn)
        raise
    t0 = time.perf_counter()
    try:
        for name in ZERO_RUNS:
            out["two_ranks"][name] = zero_against_alone(name, ranks, zdir,
                                                        runs[name])
        out["moe_mesh"] = moe_mesh_against_alone(ranks, zdir, moe_alone)
        out["tensor_parallel"] = tp_against_alone(tp_ranks, tdir,
                                                  runs["smollm_f32"])
        runs.clear()
        t1 = time.perf_counter()
        out["serve_mesh"] = serve_mesh_against_alone(
            [rk["serve"] for rk in tp_ranks], tdir, alone=serve_runs)
        out["wall_s"]["serve_mesh_alone"] = time.perf_counter() - t1
        # (g)'s two ranks need most of the card: they start once every
        # other process of the phase has ended and this one has freed it
        t1 = time.perf_counter()
        free_card()
        mla_ranks = spawn_ranks(gdir, "--mla-mesh-rank", ZERO_RANKS)
        out["wall_s"]["mla_ranks"] = time.perf_counter() - t1
        out["mla_mesh"] = mla_mesh_against_alone(mla_ranks, gdir, mla_keep)
    except BaseException:
        nccl[0].kill()
        nccl[0].wait()
        nccl[1].close()
        raise
    finally:
        torch.backends.cudnn.deterministic = False
        for k, fn in saved.items():
            setattr(lk, k, fn)
    out["wall_s"]["alone"] = time.perf_counter() - t0
    out["nccl"] = zero_nccl_finish(train, zdir, nccl)
    out["wall_s"]["nccl_after"] = time.perf_counter() - t0 - \
        out["wall_s"]["alone"]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20)
    out["kernel_rows"] = {"smollm": kernel_rows(
        lk, ZERO_SHARD_ROWS["smollm"], 512, gen, bw, flops)}
    log(f"  (d) the kernels on a ZeRO shard, smollm-135m's "
        f"{ZERO_LM_ROWS} rows over {ZERO_RANKS}:")
    log_kernel_rows({k: [v] for k, v in out["kernel_rows"]["smollm"].items()},
                    floor)
    out["kernel_rows"]["qwen3"] = large_kernel_rows(
        lk, None, 21, bw, flops, floor, rows=ZERO_SHARD_ROWS["qwen3"])
    out["wall_s"]["kernels"] = time.perf_counter() - t0
    log("  phase 20 parts, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["wall_s"].items()))
    return out


def mla_mesh_phase_main() -> int:
    """``chip_smoke.py --phase-20g``: phase 20 (g) alone on the card (the
    kernels built, then :func:`mla_mesh_phase` in ``build/mla_mesh``), its
    result logged. Not the smoke run: the whole script stays the proof
    that the port starts on the card."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, flash_decode as fdk
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch import serve, train
    torch.cuda.init()
    build.build_all()
    t0 = time.perf_counter()
    res = mla_mesh_phase(train, serve, lk, fdk,
                         os.path.join(ROOT, "build", "mla_mesh"))
    log(f"phase 20 (g) alone: {time.perf_counter() - t0:.1f} s")
    log(json.dumps(res))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    # the large steps (zamba2's f32 LARS at 24 layers) fit the card only
    # without the allocator's fragmentation (set before CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    # phase 3's flex_attention compiles through inductor and Triton: keep
    # their caches in the checkout's build directory
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(ROOT, "build", "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
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
    fd_lse = fd_lse_phase(fdk, bw, flops, fd_rows)

    phase("== 4. main path: lenet-mnist, batch 8192, 20 steps")
    runs = main_phase(train, lk, fdk)

    phase("== 5. card against CPU: 5 LARS steps at batch 32")
    card_cpu = card_vs_cpu_phase(train)

    phase("== 6. checkpoint: 10 + 10 steps against 20, large-batch path")
    ckpt = checkpoint_phase(os.path.join(ROOT, "build"))

    phase("== 7. profile of main-path steps")
    prof = {path: profile_phase(path) for path in ("f32", "large_batch")}

    phase("== 8. serve: smollm-135m at full width, 32 slots, 32 requests")
    served = serve_phase(serve, fdk, lk)

    phase("== 9. serve, card against CPU: reduced smollm in f32, plain, "
          "with a window and with the softcap")
    serve_cpu = {"plain": serve_card_vs_cpu_phase(fdk)}
    for mask, changes in SERVE_MASKS.items():
        log(f"  {mask} {changes}:")
        serve_cpu[mask] = serve_card_vs_cpu_phase(fdk, "smollm-135m", changes)

    phase("== 10. serve profile: 5 decode ticks at full width")
    serve_prof = serve_profile_phase(fdk)

    phase("== 11. experiments: lars_vs_sgd_smoke and int8_parity_smoke")
    exp = experiment_phase(os.path.join(ROOT, "build"), lk)

    phase("== 12. LM training: smollm-135m at full width, lm_smoke")
    lm = lm_phase(train, lk, fdk, bw, flops, floor,
                  os.path.join(ROOT, "build"))

    # from here on a model's runs, sessions and serving in one phase share
    # one draw of its init
    phase("== 13. the memory-lean LM path: smollm-135m's knobs, qwen3-14b "
          "at full width")
    with shared_inits():
        lean = lean_phase(train, lk, fdk, bw, flops, floor)

    phase(f"== 14. the MoE family: {GRANITE} trained at full width and "
          f"{GRANITE_LAYERS} layers, trained and served")
    with shared_inits():
        granite = granite_phase(train, serve, lk, fdk, bw, flops, floor)

    phase(f"== 15. MLA and masks: {DEEPSEEK} trained at every width, "
          f"{DEEPSEEK_LAYERS} layer and 16 routed experts, served with all "
          f"160 at "
          f"{DEEPSEEK_SERVE_LAYERS}; sliding windows and the softcap in "
          f"training")
    mla_keep: dict = {}            # what phase 20 (g) is held against
    with shared_inits():
        mla = mla_phase(train, serve, lk, fdk, bw, flops, floor,
                        lm["runs"]["lars"]["tokens_per_s"], mla_keep)

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

    phase("== 19. the serve stack: smollm-135m at full width with SLO "
          "tiers, chunked prefill and the prefix store (a session run, the "
          "bursty scenario, a window); each serve family reduced, card "
          "against CPU; the serve SLO grid")
    stack = serve_stack_phase(serve, fdk, lk, served,
                              os.path.join(ROOT, "build"))

    phase(f"== 20. data parallelism, ZeRO, tensor and expert parallelism: "
          f"{ZERO_RANKS} ranks on the card over gloo (LeNet, smollm-135m at "
          f"full width; then granite-moe-3b-a800m at full width and "
          f"{MOE_MESH_LAYERS} layer trained and served on 2x1 and 1x2; then "
          f"{DEEPSEEK}'s MLA at full width trained and served on "
          f"{MLA_MESH}), one "
          f"rank over NCCL under torchrun, {TP_RANKS} ranks on a "
          f"1x{TP_RANKS} mesh (smollm-135m whole, trained and served by the "
          "serving mesh), the LARS kernels on a shard's rows")
    zero = zero_phase(train, lk, bw, flops, floor,
                      os.path.join(ROOT, "build"), mla_keep)
    mla_keep.clear()
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
            "device_ms_in_lm_step": None if int8 else lm["profile"]["f32"][
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
        # a ZeRO shard's rows: smollm's over 2 ranks, qwen3's over 2
        entry["zero_shard_rows"] = {
            tag: dict({k: v for k, v in r.items() if k.startswith("max_")},
                      rows=r["rows"], ms=r["ms"], bound_ms=r["bound_ms"],
                      bound_by=r["bound_by"], plain_ms=r["plain_ms"],
                      library_ms=r["library_ms"],
                      dispatch_ms=r["dispatch_ms"])
            for tag, r in ((t, zero["kernel_rows"][t][kname])
                           for t in ("smollm", "qwen3"))}
        entry["shapes"] += [zero["kernel_rows"][t][kname]
                            for t in ("smollm", "qwen3")]
        if not int8:
            # phase 20 (g): each rank of deepseek's 1x2 mesh, on the
            # global rows
            entry["launches_by_mla_mesh_rank"] = {
                "rows": zero["mla_mesh"]["rows"],
                "launches": [n[kname] for n in zero["mla_mesh"]["launches"]]}
        # each rank's launches over its ZeRO run and the rows they took
        entry["launches_by_zero_run"] = {
            run: {f"rank{i}": {
                "launches": r[f"rank{i}"]["zero"]["launches"][kname],
                "rows": r[f"rank{i}"]["zero"]["launch_rows"][kname]}
                for i in range(ZERO_RANKS)}
            for run, r in zero["two_ranks"].items()}
        entries.append(entry)
    serve_row = fd_rows[0]                  # the serve path's shape
    cap_row = fd_rows[-1]                   # the same, capped
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
        "softcap_row": {k: cap_row[k] for k in (
            "shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "library", "library_max_abs_err", "library_compile_s",
            "dispatch_ms", "max_abs_err", "splits", "capped_checks",
            "nan_past_length_identical")},
        "ptxas": {k: v for k, v in build.ptxas_usage("flash_decode").items()},
        "launches_by_serve_stack_run": {
            run: {"launches": stack[run]["stats"]["flash_decode_launches"],
                  "decode_ticks": stack[run]["stats"]["decode_steps"],
                  "outside_ticks": stack[run]["stats"][
                      "flash_decode_outside_ticks"]}
            for run in ("session", "bursty")},
        "window_serve_launches": stack["window"]["launches"]["flash_decode"],
        "window_serve_launches_per_tick": stack["window"]["launches"][
            "flash_decode"] / stack["window"]["decode_steps"],
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
        # the lse instances (the serving mesh's stripes): timed rows with
        # their bounds, checks against the plain version, three stripes
        # merged against the whole cache, NaN past a stripe's length; the
        # launches a tick a rank of phase 20 (e)'s full-width run
        "lse_rows": [{k: r[k] for k in (
            "shape", "ms", "without_lse_ms", "bound_ms", "bound_by",
            "plain_ms", "library_ms", "library", "dispatch_ms",
            "max_abs_err", "splits", "ctas")} for r in fd_lse["rows"]],
        "lse_checks": fd_lse["checks"],
        "stripe_merge": fd_lse["stripe_merge"],
        "lse_nan_past_length_identical": fd_lse["poison"],
        "serve_mesh_launches_per_tick": zero["serve_mesh"]["full"][
            "launches_per_tick"],
        "serve_mesh_first_tick_vs_plain": {
            tag: r["first_merge"] for tag, r in zero["serve_mesh"].items()},
        "shapes": fd_rows + [granite["flash_decode_row"],
                             ssm["flash_decode_row"]]
        + fam["flash_decode_rows"] + fd_lse["rows"]})
    main_path = {tag: {k: r[k] for k in ("steps_per_s", "examples_per_s",
                                        "eval_accuracy", "train_s")}
                 for tag, r in runs.items()}
    log(json.dumps({"main_path": main_path, "card_vs_cpu_rel": card_cpu,
                    "checkpoint": ckpt, "profile": prof, "serve": served,
                    "serve_card_vs_cpu": serve_cpu,
                    "serve_profile": serve_prof, "experiments": exp,
                    "lm": lm, "lean": lean, "granite": granite,
                    "mla": mla, "ssm": ssm, "families": fam,
                    "tree": tree, "serve_stack": stack, "zero": zero,
                    "phase_wall_s": phase_s}))
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)          # as nvidia-smi gives it, unstamped
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--zero-rank"]:        # phase 20's ranks
        zero_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--serve-mesh-rank"]:
        serve_mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--moe-mesh-rank"]:
        moe_mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--mla-mesh-rank"]:
        mla_mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--phase-20g"]:      # (g) alone; not the contract
        sys.exit(mla_mesh_phase_main())
    sys.exit(main())
