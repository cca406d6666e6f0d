#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — the CUDA kernels, from the sources in the repository;
3. kernels — every kernel of the main path (``norms_flat``, ``apply_flat``)
             against its plain PyTorch version on the card, at LeNet's
             packed shape (272, 512) and at (65536, 512), with the
             kernel's, the plain version's and a library call's device
             time (calls replayed from a CUDA graph between CUDA events)
             beside the least time the card could take (its HBM bound),
             and the kernel wrapper's per-call dispatch time;
4. main    — ``repro_torch.launch.train``'s ``main`` on the card:
             lenet-mnist at batch 8192 for 20 steps with LARS (exactly one
             launch of each kernel per step), with SGD (none), and with
             LARS again, warm;
5. card vs CPU — 5 LARS steps at batch 32 from one seeded init, on the CPU
             with the plain versions and on the card with the kernels: the
             two loss trajectories must agree (TF32 off);
6. profile — a short ``torch.profiler`` window over main-path steps: the
             device's busy share, time by kernel, and the hand kernels'
             own device time inside a step.

It then prints nvidia-smi's line, a ``{"kernels": [...]}`` line and, last,
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
# norms_flat sums 4096 squares per block in another order than torch.sum:
# f32 relative error ~ sqrt(4096) * 2^-24 ~ 4e-6 for such sums.
NORMS_RTOL = 1e-5
# apply_flat is built with -fmad=false and does the plain version's
# operations in its order: the two must agree bit for bit.
APPLY_ATOL = 0.0
# 5 LARS steps at b32, card (cuDNN convs, kernels) vs CPU (plain): only
# f32 summation orders differ; the golden b32 pin holds 1e-4 over 20 steps.
CARD_CPU_RTOL = 1e-4

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


def timings(fn, calls: int) -> tuple[float, float]:
    """(device ms per call from a CUDA graph, dispatch ms per call)."""
    return device_ms(fn, calls=calls), dispatch_ms(fn)


def kernel_phase(lk, bw: float, flops: float) -> dict:
    """Phase 3: each kernel against its plain version at SHAPES."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"norms_flat": [], "apply_flat": []}
    for rows, lane in SHAPES:
        n = rows * lane
        w = torch.randn(rows, lane, generator=gen, device=dev)
        g = torch.randn(rows, lane, generator=gen, device=dev) * 1e-2
        m = torch.randn(rows, lane, generator=gen, device=dev) * 1e-3
        lr = torch.rand(rows // 8, 1, generator=gen, device=dev) * 1e-2

        wsq, gsq = lk.norms_flat(w, g)
        pw, pg = lk.norms_flat_plain(w, g)
        torch.cuda.synchronize()
        err = max((wsq - pw).abs().max().item(), (gsq - pg).abs().max().item())
        rel = max(((wsq - pw).abs() / pw).max().item(),
                  ((gsq - pg).abs() / pg).max().item())
        if not rel <= NORMS_RTOL:
            raise AssertionError(f"norms_flat {rows}x{lane}: rel err {rel} "
                                 f"> {NORMS_RTOL}")
        nbytes = 2 * n * 4 + 2 * (rows // 8) * 4
        nops = 4 * n
        calls = GRAPH_CALLS[rows]
        vn = lambda x: torch.linalg.vector_norm(x.view(rows // 8, -1), dim=1)
        out["norms_flat"].append(_row(
            rows, lane, err, rel, timings(lambda: lk.norms_flat(w, g), calls),
            device_ms(lambda: lk.norms_flat_plain(w, g), calls=calls),
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
        del w, g, m, lr, w2, m2, pw2, pm2
        torch.cuda.empty_cache()
    for name, rows in out.items():
        for r in rows:
            log(f"  {name:10s} {r['rows']:6d}x{r['lane']}  kernel "
                f"{r['ms']:.5f} ms (dispatch {r['dispatch_ms']:.4f})  "
                f"plain {r['plain_ms']:.5f} ms  library "
                f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
                f"max abs err {r['max_abs_err']:.3g}  rel {r['max_rel_err']:.3g}")
    return out


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


def main_phase(train, lk) -> dict:
    """Phase 4: the port's entry point at batch 8192: LARS (the counted
    run, first in the process, so it pays cuDNN's and cuBLAS's warm-up),
    SGD, then LARS again for a warm timing."""
    runs = {}
    for tag, opt in (("lars", "lars"), ("sgd", "sgd"), ("lars_warm", "lars")):
        lk.reset_launch_counts()
        summary = train.main(MAIN_ARGS + ["--optimizer", opt])
        counts = dict(lk.LAUNCHES)
        losses = summary["losses"]
        if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{tag}: losses {losses}")
        want = MAIN_STEPS if opt == "lars" else 0
        if counts != {"norms_flat": want, "apply_flat": want}:
            raise AssertionError(f"{tag}: launches {counts}, want {want} each")
        runs[tag] = dict(summary, launches=counts)
        log(f"  {tag}: {summary['steps_per_s']:.3f} steps/s  "
            f"{summary['examples_per_s']:.1f} examples/s  eval accuracy "
            f"{summary['eval_accuracy']:.4f}  launches {counts}  "
            f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    return runs


def card_vs_cpu_phase(train) -> float:
    """Phase 5: the same 5 LARS steps on the CPU (plain) and the card."""
    args = ["--arch", "lenet-mnist", "--optimizer", "lars", "--batch", "32",
            "--steps", "5", "--lr", "0.05", "--log-every", "0"]
    cpu = train.main(args + ["--device", "cpu"])["losses"]
    card = train.main(args + ["--device", "cuda"])["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"  cpu  {cpu}\n  card {card}\n  max rel diff {rel:.3g} "
        f"(tolerance {CARD_CPU_RTOL})")
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"card vs CPU loss rel diff {rel}")
    return rel


def profile_phase(batch: int = 8192, steps: int = 5) -> dict:
    """Phase 6: device busy share and time by kernel over main-path steps
    (LARS, batch 8192), after two warm-up steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.data import batch_iterator, synthetic_mnist
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.train import create_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    opt = lars(0.01)
    state = create_train_state(model, opt, torch.Generator().manual_seed(0),
                               device=dev)
    step = make_train_step(model, opt, cfg)
    x, y, _, _ = synthetic_mnist(batch, 8)
    it = batch_iterator(x, y, batch=batch, seed=0)
    for _ in range(2):
        state, _ = step(state, to_device(next(it), dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, to_device(next(it), dev))
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
            / steps for k in ("norms_flat", "apply_flat")}
    log(f"  {steps} steps: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%)" if busy else
        "  device time: not measured (the profiler recorded no CUDA events)")
    for name, ms in top:
        log(f"    {ms / steps:9.4f} ms/step  {name[:90]}")
    log(f"  hand kernels, device ms/step: {ours}")
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps if busy else None,
            "hand_kernel_device_ms_per_step": ours,
            "top_kernels_ms_per_step": [[n[:90], ms / steps] for n, ms in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, lars_kernels as lk
    from repro_torch.launch import train

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
    kern = kernel_phase(lk, bw, flops)

    log("== 4. main path: lenet-mnist, batch 8192, 20 steps")
    runs = main_phase(train, lk)

    log("== 5. card against CPU: 5 LARS steps at batch 32")
    card_cpu = card_vs_cpu_phase(train)

    log("== 6. profile of main-path steps")
    prof = profile_phase()

    replaces = {"norms_flat": "src/repro/kernels/lars_kernels.py:49",
                "apply_flat": "src/repro/kernels/lars_kernels.py:86"}
    entries = []
    for kname, rows in kern.items():
        main_row = next(r for r in rows if r["rows"] == MAIN_ROWS)
        launches = runs["lars"]["launches"][kname]
        entries.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lars_kernels.cu",
            "replaces": replaces[kname], "launches": launches,
            "launches_per_step": launches / MAIN_STEPS,
            "launches_sgd": runs["sgd"]["launches"][kname],
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "dispatch_ms": main_row["dispatch_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms_in_step": prof["hand_kernel_device_ms_per_step"][kname],
            "shapes": rows})
    main_path = {opt: {k: r[k] for k in ("steps_per_s", "examples_per_s",
                                        "eval_accuracy", "train_s")}
                 for opt, r in runs.items()}
    log(json.dumps({"main_path": main_path, "card_vs_cpu_rel": card_cpu,
                    "profile": prof}))
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
