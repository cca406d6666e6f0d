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
             wrapper's per-call dispatch time: ``norms_flat`` (per row),
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
             LARS and the large-batch path): the device's busy share, time
             by kernel, and the hand kernels' own device time in a step;
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
             time and launches in a tick.

It then prints nvidia-smi's line, a ``{"kernels": [...]}`` line (all four
kernels, each with the launch floor as ``floor_ms``) and, last,
``{"ok": true, "device": {...}}``. It imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SHAPES = [(272, 512), (65536, 512)]   # LeNet's packed buffer; HBM-sized
GRAPH_CALLS = {272: 100, 65536: 10}   # calls per timed CUDA graph
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
FD_CALLS = {4096: 20, 32768: 5}       # calls per timed CUDA graph
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


def kernel_phase(lk, bw: float, flops: float) -> tuple[dict, float]:
    """Phase 3: the launch floor, then each kernel against its plain
    version at SHAPES. Returns (rows by kernel, floor ms)."""
    import torch
    dev = torch.device("cuda")
    floor = floor_ms(GRAPH_CALLS[MAIN_ROWS])
    log(f"  launch floor (one-element zero_(), {GRAPH_CALLS[MAIN_ROWS]} "
        f"calls per graph): {floor:.5f} ms")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {k: [] for k in KERNELS}
    for rows, lane in SHAPES:
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
        vn = lambda x: torch.linalg.vector_norm(x, dim=1)
        out["norms_flat"].append(_row(
            rows, lane, err, rel,
            timings(lambda: lk.norms_flat(w, g, block_rows=1), calls),
            device_ms(lambda: lk.norms_flat_plain(w, g, block_rows=1),
                      calls=calls),
            device_ms(lambda: (vn(w), vn(g)), calls=calls),
            nbytes, nops, bw, flops))

        w2, m2 = lk.apply_flat(w, g, m, lr, momentum=0.9, weight_decay=1e-4)
        pw2, pm2 = lk.apply_flat_plain(w, g, m, lr, momentum=0.9,
                                       weight_decay=1e-4)
        torch.cuda.synchronize()
        err = max((w2 - pw2).abs().max().item(), (m2 - pm2).abs().max().item())
        if not err <= APPLY_ATOL:
            raise AssertionError(f"apply_flat {rows}x{lane}: abs err {err} "
                                 f"> {APPLY_ATOL}")
        nbytes = 3 * n * 4 + (rows // 8) * 4 + 2 * n * 4
        nops = 6 * n
        out["apply_flat"].append(_row(
            rows, lane, err, 0.0,
            timings(lambda: lk.apply_flat(w, g, m, lr, momentum=0.9,
                                          weight_decay=1e-4), calls),
            device_ms(lambda: lk.apply_flat_plain(w, g, m, lr, momentum=0.9,
                                                  weight_decay=1e-4),
                      calls=calls),
            None, nbytes, nops, bw, flops))
        out["apply_flat_q8"].append(q8_row(lk, w, g, m, lr, bw, flops))
        del w, g, m, lr, w2, m2, pw2, pm2
        torch.cuda.empty_cache()
    for name, rows in out.items():
        for r in rows:
            log(f"  {name:10s} {r['rows']:6d}x{r['lane']}  kernel "
                f"{r['ms']:.5f} ms (floor {floor:.5f}; dispatch "
                f"{r['dispatch_ms']:.4f})  "
                f"plain {r['plain_ms']:.5f} ms  library "
                f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
                f"max abs err {r['max_abs_err']:.3g}  rel {r['max_rel_err']:.3g}")
    return out, floor


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
    from repro_torch.launch.train import to_device
    x, y, _, _ = synthetic_mnist(batch, 8)
    it = batch_iterator(x, y, batch=batch, seed=0)
    return [to_device(next(it), device) for _ in range(n)]


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


def profile_phase(path: str, batch: int = 8192, steps: int = 5) -> dict:
    """Phase 7: device busy share and time by kernel over main-path steps
    at batch 8192 (``path``: "f32" LARS or the "large_batch" path), after
    two warm-up steps."""
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
    from repro_torch.data import batch_iterator, synthetic_mnist
    from repro_torch.launch.train import to_device
    x, y, _, _ = synthetic_mnist(batch, 8)
    it = batch_iterator(x, y, batch=batch, seed=0)
    for _ in range(2):
        state, _ = pipe(state, to_device(next(it), dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = pipe(state, to_device(next(it), dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    ours = {k: sum(ms for n, ms in kernels.items() if f"{k}_kernel" in n)
            / steps for k in KERNELS}
    log(f"  {path}, {steps} steps: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%)" if busy else
        f"  {path}: device time not measured (the profiler recorded no "
        "CUDA events)")
    for name, ms in top:
        log(f"    {ms / steps:9.4f} ms/step  {name[:90]}")
    log(f"  hand kernels, device ms/step: {ours}")
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps if busy else None,
            "hand_kernel_device_ms_per_step": ours,
            "top_kernels_ms_per_step": [[n[:90], ms / steps] for n, ms in top]}


def fd_inputs(B, S, Hkv, G, D, lengths, dtype, gen):
    """q, k, v and lengths on the card for flash_decode, drawn from
    ``gen``; ``lengths`` is "drawn" (1..S), "full" (S) or a list."""
    import torch
    dev = torch.device("cuda")
    q = torch.randn(B, Hkv, G, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
    if lengths == "drawn":
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
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
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    for D, Hkv, G in ((64, 3, 3), (128, 8, 5)):
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v, lens = fd_inputs(8, 4096, Hkv, G, D, "drawn", dt, gen)
            lens[0], lens[1], lens[2] = 0, 1, 4096 + 7
            err, rel = _fd_err(fdk, q, k, v, lens, name)
            log(f"  flash_decode {name} D={D} G={G}: max abs err {err:.3g} "
                f"(rel {rel:.3g}); lengths 0, 1, S+7 included")
    rows = []
    for B, S, Hkv, G, D, lengths in FD_SHAPES:
        q, k, v, lens = fd_inputs(B, S, Hkv, G, D, lengths, torch.bfloat16,
                                  gen)
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
                                                  scale=scale,
                                                  enable_gqa=True)
        plan = fdk.plan(q, k)
        row = _row(B, S, err, rel, timings(
            lambda: fdk.flash_decode(q, k, v, lens, scale=scale), calls),
            device_ms(lambda: fdk.flash_decode_plain(q, k, v, lens,
                                                     scale=scale),
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
        rows.append(row)
        del q, k, v, lens, kt, vt, mask, qs
        torch.cuda.empty_cache()
    return rows


def serve_phase(serve, fdk, lk) -> dict:
    """Phase 8: the serve entry point at full width. Every launch count is
    set to 0 just before it and read just after."""
    import torch
    lk.reset_launch_counts()
    fdk.reset_launch_counts()
    rep = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = dict(fdk.LAUNCHES)
    lars = dict(lk.LAUNCHES)
    ticks = rep["decode_steps"]
    want = rep["num_layers"] * ticks
    log(f"  {rep['requests']} requests, {rep['tokens']} tokens, "
        f"{rep['tok_per_s']:.1f} tok/s, {ticks} decode ticks, "
        f"{rep['admit_calls']} admissions; flash_decode launches "
        f"{launches['flash_decode']} (want {want}); LARS kernels {lars}; "
        f"logits finite {rep['logits_finite']}")
    if launches["flash_decode"] != want or ticks == 0:
        raise AssertionError(f"serve: {launches} flash_decode launches for "
                             f"{ticks} ticks of {rep['num_layers']} layers")
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
    return dict({k: rep[k] for k in keys}, launches=launches)


def _reduced_lm(device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), device)


def serve_card_vs_cpu_phase(fdk) -> dict:
    """Phase 9: reduced smollm (f32) on the CPU (plain) and the card."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.treepath import tree_map
    cfg, model, params = _reduced_lm("cpu")
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
        want = cfg.num_layers * len(feed) if dev == "cuda" else 0
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
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, flash_decode as fdk
    from repro_torch.kernels import lars_kernels as lk
    from repro_torch.launch import serve, train

    log("== 1. device")
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

    log("== 2. build")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    log("== 3. kernels against their plain versions")
    kern, floor = kernel_phase(lk, bw, flops)
    fd_rows = flash_decode_phase(fdk, bw, flops)

    log("== 4. main path: lenet-mnist, batch 8192, 20 steps")
    runs = main_phase(train, lk, fdk)

    log("== 5. card against CPU: 5 LARS steps at batch 32")
    card_cpu = card_vs_cpu_phase(train)

    log("== 6. checkpoint: 10 + 10 steps against 20, large-batch path")
    ckpt = checkpoint_phase(os.path.join(ROOT, "build"))

    log("== 7. profile of main-path steps")
    prof = {path: profile_phase(path) for path in ("f32", "large_batch")}

    log("== 8. serve: smollm-135m at full width, 32 slots, 64 requests")
    served = serve_phase(serve, fdk, lk)

    log("== 9. serve, card against CPU: reduced smollm in f32")
    serve_cpu = serve_card_vs_cpu_phase(fdk)

    log("== 10. serve profile: 5 decode ticks at full width")
    serve_prof = serve_profile_phase(fdk)

    replaces = {"norms_flat": "src/repro/kernels/lars_kernels.py:49",
                "apply_flat": "src/repro/kernels/lars_kernels.py:86",
                "apply_flat_q8": "src/repro/kernels/lars_kernels.py:139"}
    entries = []
    for kname, rows in kern.items():
        main_row = next(r for r in rows if r["rows"] == MAIN_ROWS)
        # the run on the kernel's own main path: f32 LARS for norms_flat
        # and apply_flat, the large-batch int8 path for apply_flat_q8
        int8 = kname == "apply_flat_q8"
        run = runs["lars_int8_bf16_accum8" if int8 else "lars"]
        in_step = prof["large_batch" if int8 else "f32"]
        launches = run["launches"][kname]
        entries.append({
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
                kname],
            "shapes": rows})
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
        "shapes": fd_rows})
    main_path = {tag: {k: r[k] for k in ("steps_per_s", "examples_per_s",
                                        "eval_accuracy", "train_s")}
                 for tag, r in runs.items()}
    log(json.dumps({"main_path": main_path, "card_vs_cpu_rel": card_cpu,
                    "checkpoint": ckpt, "profile": prof, "serve": served,
                    "serve_card_vs_cpu": serve_cpu,
                    "serve_profile": serve_prof}))
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
