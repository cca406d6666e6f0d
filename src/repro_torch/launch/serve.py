"""Serving launcher of the port: continuous-batching decode over
synthetic traffic. Port of ``repro/launch/serve.py`` (FIFO, one device).

Drives :class:`repro_torch.serve.ServeEngine` with a stream of staggered
heterogeneous requests (prompt/output lengths drawn from ranges, Poisson
arrivals in engine-step time) and reports per-request latency/TTFT
percentiles plus aggregate throughput, slot occupancy, the decode-tick
count and the ``flash_decode`` kernel launches.

Examples (on the card; ``--device cpu`` runs on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --slots 32 --capacity 4096 --requests 64 --prompt-min 256 \
        --prompt-max 2048 --new-min 32 --new-max 256 --arrival-every 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --sampler top_k:40:0.8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --set num_layers=2 --slots 32 \
        --capacity 4096
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-7b --reduced --device cpu

Weights are random, drawn from ``--seed`` (the port's own init at the
reference's distributions). ``--set FIELD=VALUE`` overrides a config
field after ``--reduced``, as in the reference. The reference's mesh,
scenario, SLO, session, chunked-prefill and prefix-store options are
not yet ported and raise. As in the reference, the encdec and vlm
archs (whisper-base, paligemma-3b) raise too: ``ServeEngine`` does not
serve their families (:class:`repro_torch.serve.DecodeEngine` does).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch.overrides import apply_overrides
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine, parse_sampler


def synth_requests(cfg, args, rng):
    """[(arrival_step, prompt, max_new)] with staggered Poisson arrivals."""
    out, t = [], 0
    for _ in range(args.requests):
        t += int(rng.poisson(args.arrival_every))
        plen = int(rng.integers(args.prompt_min, args.prompt_max + 1))
        new = int(rng.integers(args.new_min, args.new_max + 1))
        out.append((t, rng.integers(0, cfg.vocab_size, (plen,)), new))
    return out


def serve_traffic(engine: ServeEngine, traffic) -> dict:
    """Drive the engine step-by-step, injecting requests mid-flight."""
    finished, pending, tick = [], list(traffic), 0
    t0 = time.perf_counter()
    while pending or engine.scheduler.has_work():
        while pending and pending[0][0] <= tick:
            _, prompt, new = pending.pop(0)
            engine.submit(prompt, new)
        finished.extend(engine.step())
        tick += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    return dict(_aggregate(finished, wall, engine), finished=finished)


def _aggregate(finished, wall, engine) -> dict:
    lat = np.asarray([f.latency for f in finished])
    ttft = np.asarray([f.ttft for f in finished])
    toks = int(sum(f.tokens.size for f in finished))

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else 0.0

    return {
        "requests": len(finished), "tokens": toks, "wall_s": wall,
        "tok_per_s": toks / wall if wall else 0.0,
        "occupancy": engine.occupancy,
        "latency_mean_s": float(lat.mean()) if len(lat) else 0.0,
        "latency_p50_s": pct(lat, 50), "latency_p90_s": pct(lat, 90),
        "latency_p99_s": pct(lat, 99),
        "ttft_mean_s": float(ttft.mean()) if len(ttft) else 0.0,
        "ttft_p50_s": pct(ttft, 50), "ttft_p90_s": pct(ttft, 90),
        "ttft_p99_s": pct(ttft, 99),
        "decode_steps": engine.stats["decode_steps"],
        "admit_calls": engine.stats["admit_calls"],
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (CPU-scale) variant")
    ap.add_argument("--slots", type=int, default=8,
                    help="resident decode batch (slot count)")
    ap.add_argument("--capacity", type=int, default=256,
                    help="per-slot cache capacity (prompt + new tokens)")
    ap.add_argument("--sampler", default="greedy",
                    help="greedy | temperature:T | top_k:K[:T] | "
                    "top_p:P[:T]")
    ap.add_argument("--prefill-bucket", type=int, default=16,
                    help="round prompt buffers up to a multiple of this "
                    "(groups admissions of similar length)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--arrival-every", type=float, default=2.0,
                    help="mean engine steps between arrivals (Poisson)")
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=24)
    ap.add_argument("--new-min", type=int, default=4)
    ap.add_argument("--new-max", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="config override, e.g. --set num_layers=2")
    # the reference's options for paths the port does not cover yet
    ap.add_argument("--mesh", default="none")
    ap.add_argument("--scenario", default="")
    ap.add_argument("--slos", default="")
    ap.add_argument("--session", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefix-entries", type=int, default=0)
    ap.add_argument("--min-slots", type=int, default=0)
    return ap.parse_args(argv)


def _check_ported(args) -> None:
    unported = {f"--mesh {args.mesh}": args.mesh != "none",
                "--scenario": bool(args.scenario), "--slos": bool(args.slos),
                "--session": bool(args.session),
                "--prefill-chunk": bool(args.prefill_chunk),
                "--prefix-entries": bool(args.prefix_entries),
                "--min-slots": bool(args.min_slots)}
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch.launch.serve")


def main(argv=None) -> dict:
    """Serve synthetic traffic; returns the report (latency and TTFT
    percentiles, tokens/s, occupancy, decode ticks, kernel launches)."""
    args = parse_args(argv)
    _check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "serve on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = apply_overrides(cfg, args.set)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), device)
    engine = ServeEngine(model, params, cfg, slots=args.slots,
                         capacity=args.capacity,
                         sampler=parse_sampler(args.sampler),
                         prefill_bucket=args.prefill_bucket, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    traffic = synth_requests(cfg, args, rng)
    launches0 = fd.LAUNCHES["flash_decode"]
    rep = serve_traffic(engine, traffic)
    rep.update(arch=cfg.name, device=str(device), slots=args.slots,
               capacity=args.capacity, num_layers=cfg.num_layers,
               use_mla=cfg.use_mla,
               flash_decode_per_tick=model.flash_decode_per_step(),
               flash_decode_launches=fd.LAUNCHES["flash_decode"] - launches0,
               logits_finite=engine.logits_finite)

    print(f"\n{cfg.name} ({cfg.family}) — slots={args.slots} "
          f"capacity={args.capacity} sampler={args.sampler} "
          f"device={device}")
    print(f"  {rep['requests']} requests, {rep['tokens']} tokens in "
          f"{rep['wall_s']:.2f}s -> {rep['tok_per_s']:.0f} tok/s, "
          f"occupancy {rep['occupancy']:.2f}")
    print(f"  latency mean {rep['latency_mean_s']*1e3:.0f} ms / p50 "
          f"{rep['latency_p50_s']*1e3:.0f} / p90 "
          f"{rep['latency_p90_s']*1e3:.0f} / p99 "
          f"{rep['latency_p99_s']*1e3:.0f} ms")
    print(f"  TTFT    mean {rep['ttft_mean_s']*1e3:.0f} ms / p50 "
          f"{rep['ttft_p50_s']*1e3:.0f} / p90 "
          f"{rep['ttft_p90_s']*1e3:.0f} / p99 "
          f"{rep['ttft_p99_s']*1e3:.0f} ms")
    print(f"  decode ticks {rep['decode_steps']}, admissions "
          f"{rep['admit_calls']} — flash_decode kernel launches "
          f"{rep['flash_decode_launches']} ("
          f"{rep['flash_decode_per_tick']} per tick on the card, 0 "
          f"on the CPU); logits finite: {rep['logits_finite']}")
    for f in rep["finished"][:8]:
        print(f"    req {f.request.rid:3d}: prompt {f.request.prompt_len:3d} "
              f"-> {f.tokens.size:3d} tok, latency "
              f"{f.latency*1e3:7.1f} ms, ttft {f.ttft*1e3:7.1f} ms")
    return rep


if __name__ == "__main__":
    main()
