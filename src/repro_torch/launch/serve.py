"""Serving launcher of the port: continuous-batching decode over
synthetic traffic. Port of ``repro/launch/serve.py``, on one device or
on a serving mesh of ranks (``--mesh``).

Drives :class:`repro_torch.serve.ServeEngine` with a stream of staggered
heterogeneous requests (prompt/output lengths drawn from ranges, Poisson
arrivals in engine-step time) and reports per-request latency/TTFT
percentiles plus aggregate throughput, slot occupancy, the decode-tick
count and the ``flash_decode`` kernel launches (in the ticks, and
outside them: none).

``--session N`` switches to multi-turn session traffic: N concurrent
sessions, ``--turns`` turns each, every turn extending its session's
history (shared system prompt + prior turns + prior outputs). With
``--prefix-entries`` the radix prefix index serves each turn's history
from the prefix store, so only the new user tokens are prefilled — the
per-turn prefix hit count is reported. ``--prefill-chunk`` admits
prompts one chunk a tick while the resident slots keep decoding.

``--mesh DATAxMODEL`` (or ``auto``) serves on a ``(data, model)`` mesh
of the ranks of a ``torch.distributed`` process group (``torchrun``;
NCCL for ``cuda``, gloo for ``--device cpu``), as ``launch.train
--mesh`` does: the slots over ``data``, the params and the KV cache's
sequence over ``model`` (the dense family, and the moe family, whose
experts split over ``model``, deepseek's MLA included: its latent cache
striped, its heads split; a ``model`` axis of 1 serves every family).
The moe family routes every slot of the mesh together at each tick, and
each ``data`` rank prefills a whole admitted group, as the reference's
one engine does. Every rank runs the same traffic; only
rank 0 prints. Without a process group the process is one rank, so
``--mesh 2x1`` fails with the reference's message. Chunked prefill, the
prefix store and preemption on a mesh (queue 1 item 4c-ii), and the
ssm and hybrid families on a ``model`` axis above 1 (4b-ii), are not
yet ported and raise::

    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --mesh 1x2 --requests 6
    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --reduced --device cpu --mesh 2x1 \
        --requests 6 --set num_experts=8 --set experts_per_token=2 \
        --set capacity_factor=0.5
    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --reduced --device cpu --mesh 1x2 \
        --requests 6 --set q_lora_rank=48

``--scenario NAME`` replays a scenario-library traffic shape (steady /
bursty / diurnal / heavy_tail, priority-tiered; or the port's
``bursty_32``, the bursty mix sized to fill a 32-slot engine) through
the engine and prints the per-class report. Combine with ``--slos`` to
enable the priority scheduler (tier-aware admission + SLO-driven
preemption), ``--reserve-slots`` and ``--min-slots`` (slot
autoscaling).

Examples (on the card; ``--device cpu`` runs on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --slots 32 --capacity 4096 --requests 64 --prompt-min 256 \
        --prompt-max 2048 --new-min 32 --new-max 256 --arrival-every 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --sampler top_k:40:0.8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --reduced --device cpu --session 4 --turns 3 --shared-prefix 64 \
        --prefix-entries 16 --prefill-chunk 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --reduced --device cpu --scenario bursty --slos 0:0.05:2,1:5:60 \
        --prefill-chunk 8 --prefix-entries 32 --reserve-slots 1 \
        --time-scale 1.0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --set sliding_window=16 --prompt-max 40

Weights are random, drawn from ``--seed`` (the port's own init at the
reference's distributions). ``--set FIELD=VALUE`` overrides a config
field after ``--reduced``, as in the reference (a sliding window serves
from a ring cache, the logit softcap is applied at decode). As in the
reference, the encdec and vlm
archs (whisper-base, paligemma-3b) raise too: ``ServeEngine`` does not
serve their families (:class:`repro_torch.serve.DecodeEngine` does).
``--use-flash`` asks for the ``flash_decode`` kernel, so it needs the
card (the engine's ``use_flash=True``); without it the kernel runs on
the card and its plain version on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch.mesh import init_distributed, mesh_from_spec, world
from repro_torch.launch.overrides import apply_overrides
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine, parse_sampler
from repro_torch.serve.scheduler import TierSLO


def synth_requests(cfg, args, rng):
    """[(arrival_step, prompt, max_new)] with staggered Poisson arrivals."""
    out, t = [], 0
    for _ in range(args.requests):
        t += int(rng.poisson(args.arrival_every))
        plen = int(rng.integers(args.prompt_min, args.prompt_max + 1))
        new = int(rng.integers(args.new_min, args.new_max + 1))
        out.append((t, rng.integers(0, cfg.vocab_size, (plen,)), new))
    return out


def _sync(engine: ServeEngine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


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
    _sync(engine)
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


def run_sessions(engine: ServeEngine, cfg, args, rng) -> dict:
    """Multi-turn session traffic: every turn submits each session's
    full history (system prompt + turns + outputs) and drains; with a
    prefix store, the history is restored from the radix index and only
    the fresh user tokens are prefilled."""
    sys_prompt = rng.integers(0, cfg.vocab_size,
                              (args.shared_prefix,)).astype(np.int32)
    hist = [sys_prompt.copy() for _ in range(args.session)]
    finished_all, per_turn = [], []
    t0 = time.perf_counter()
    for _turn in range(args.turns):
        hits0 = engine.stats["prefix_hits"]
        hit_toks0 = engine.stats["prefix_hit_tokens"]
        rids = []
        for s in range(args.session):
            user = rng.integers(
                0, cfg.vocab_size,
                (int(rng.integers(args.prompt_min, args.prompt_max + 1)),)
            ).astype(np.int32)
            hist[s] = np.concatenate([hist[s], user])
            new = int(rng.integers(args.new_min, args.new_max + 1))
            rids.append(engine.submit(hist[s], new))
        by_rid = {f.request.rid: f for f in engine.run([])}
        for s, rid in enumerate(rids):
            f = by_rid[rid]
            hist[s] = np.concatenate([hist[s], f.tokens.astype(np.int32)])
            finished_all.append(f)
        per_turn.append({
            "prefix_hits": engine.stats["prefix_hits"] - hits0,
            "prefix_hit_tokens":
                engine.stats["prefix_hit_tokens"] - hit_toks0,
            "submitted": len(rids)})
    _sync(engine)
    wall = time.perf_counter() - t0
    rep = dict(_aggregate(finished_all, wall, engine),
               finished=finished_all, per_turn=per_turn)
    if engine.pool is not None:
        rep["prefix"] = dict(engine.pool.stats,
                             hit_rate=engine.pool.hit_rate)
    return rep


def parse_slos(spec: str):
    """``tier:ttft_s[:latency_s]`` comma list -> {tier: TierSLO}."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise ValueError(f"bad SLO {part!r}: want tier:ttft[:latency]")
        tier = int(fields[0])
        out[tier] = TierSLO(float(fields[1]),
                            float(fields[2]) if len(fields) == 3
                            else float("inf"))
    return out


def run_library_scenario(engine: ServeEngine, cfg, args) -> dict:
    """Replay a scenario-library shape and print the per-class row.

    run_scenario builds its own engine from spec kwargs; here the CLI
    already built one from its flags, so drive it directly. One warm
    pass with every arrival immediate: the reference replays the timed
    schedule too, to compile its shapes; eager PyTorch compiles
    nothing."""
    from repro_torch.serve.report import (_drive_wave, format_scenarios,
                                          scenario_waves, summarize)
    waves = scenario_waves(args.scenario, cfg.vocab_size, seed=args.seed)
    for wave in waves:                       # warmup: every request once
        _drive_wave(engine, wave, 0.0)
    engine.reset_stats()
    finished, classes = [], {}
    t0 = time.perf_counter()
    for wave in waves:
        finished.extend(_drive_wave(engine, wave, args.time_scale,
                                    classes))
    _sync(engine)
    wall = time.perf_counter() - t0
    row = summarize(finished, wall, engine, classes)
    row.update(_aggregate(finished, wall, engine), finished=finished,
               wall_s=wall)
    print(format_scenarios({args.scenario: row}))
    return row


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
    ap.add_argument("--mesh", default="none",
                    help="none, auto or DATAxMODEL: a (data, model) mesh "
                    "over the ranks of the process group (torchrun); "
                    "MODEL > 1 splits the dense and moe families (MLA "
                    "included)")
    ap.add_argument("--use-flash", action="store_true",
                    help="ask for the flash_decode kernel (needs the card; "
                    "default: the kernel on the card, its plain version "
                    "on the CPU)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: advance each admission by "
                    "this many tokens per engine tick (0 = monolithic)")
    ap.add_argument("--prefix-entries", type=int, default=0,
                    help="prefix-store entries for the radix prefix "
                    "index (0 = disabled)")
    ap.add_argument("--prefix-min-tokens", type=int, default=4,
                    help="shortest prefix worth snapshotting")
    ap.add_argument("--scenario", default="",
                    help="replay a scenario-library traffic shape "
                    "(steady | bursty | diurnal | heavy_tail | bursty_32)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="scenario traffic window in seconds "
                    "(with --scenario)")
    ap.add_argument("--slos", default="",
                    help="per-tier SLOs 'tier:ttft_s[:latency_s],...' — "
                    "enables the priority scheduler (tier-aware "
                    "admission, SLO-driven preemption)")
    ap.add_argument("--min-slots", type=int, default=0,
                    help="slot-autoscaling floor (0 = autoscaling off)")
    ap.add_argument("--reserve-slots", type=int, default=0,
                    help="free-slot headroom tier > 0 may never take "
                    "(with --slos)")
    ap.add_argument("--session", type=int, default=0,
                    help="N concurrent multi-turn sessions sharing a "
                    "system prompt (0 = plain synthetic traffic)")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per session (with --session)")
    ap.add_argument("--shared-prefix", type=int, default=64,
                    help="shared system-prompt length (with --session)")
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
                    help="config override, e.g. --set sliding_window=64")
    return ap.parse_args(argv)


def _pct_ms(row: dict) -> str:
    f = [row.get(k) for k in ("p50", "p99")]
    return "/".join("-" if v is None else f"{1e3 * v:.1f}" for v in f)


def main(argv=None) -> dict:
    """Serve synthetic, session or scenario traffic; returns the report
    (latency and TTFT percentiles, tokens/s, occupancy, decode ticks,
    kernel launches, the engine's counters)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "serve on the CPU")
    mesh = None
    if args.mesh != "none":
        device = init_distributed(device)
        mesh = mesh_from_spec(args.mesh, device=device)
        if mesh is None:
            print(f"rank {world()[0]} lies past --mesh {args.mesh}: idle")
            return {"rank": world()[0], "mesh": None}
    torch.backends.cuda.matmul.allow_tf32 = False
    # only the mesh's rank 0 prints
    quiet = mesh is not None and mesh.rank != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet \
            else contextlib.nullcontext():
        return _serve(args, device, mesh)


def _serve(args, device: torch.device, mesh) -> dict:
    """:func:`main` on ``device``, on ``mesh`` (None: one device)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = apply_overrides(cfg, args.set)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), device)
    engine = ServeEngine(
        model, params, cfg, slots=args.slots, capacity=args.capacity,
        sampler=parse_sampler(args.sampler),
        use_flash=True if args.use_flash else None,
        prefill_bucket=args.prefill_bucket,
        prefill_chunk=args.prefill_chunk or None,
        prefix_entries=args.prefix_entries,
        prefix_min_tokens=args.prefix_min_tokens, seed=args.seed,
        slos=parse_slos(args.slos), min_slots=args.min_slots or None,
        reserve_slots=args.reserve_slots, mesh=mesh)

    rng = np.random.default_rng(args.seed)
    launches0 = fd.LAUNCHES["flash_decode"]
    head = (f"\n{cfg.name} ({cfg.family}) — slots={args.slots} "
            f"capacity={args.capacity} sampler={args.sampler} "
            f"device={device}"
            + (f" prefill_chunk={args.prefill_chunk}"
               if args.prefill_chunk else "")
            + (f" prefix_entries={args.prefix_entries}"
               if args.prefix_entries else "")
            + (f" slos={args.slos}" if args.slos else " (fifo)")
            + (f" min_slots={args.min_slots}" if args.min_slots else "")
            + (f" reserve={args.reserve_slots}"
               if args.reserve_slots else "")
            + (f" mesh={mesh.shape['data']}x{mesh.shape['model']}"
               if mesh is not None else ""))
    if args.scenario:
        print(head + f" — scenario {args.scenario}")
        rep = run_library_scenario(engine, cfg, args)
    elif args.session:
        rep = run_sessions(engine, cfg, args, rng)
    else:
        rep = serve_traffic(engine, synth_requests(cfg, args, rng))
    rep.update(arch=cfg.name, device=str(device), slots=args.slots,
               capacity=args.capacity, num_layers=cfg.num_layers,
               use_mla=cfg.use_mla,
               flash_decode_per_tick=model.flash_decode_per_step(),
               flash_decode_launches=fd.LAUNCHES["flash_decode"] - launches0,
               logits_finite=engine.logits_finite,
               stats=dict(engine.stats),
               mesh=None if mesh is None else dict(mesh.shape),
               ranks_agree=engine.ranks_agree())
    if engine.pool is not None:
        rep.setdefault("prefix", dict(engine.pool.stats,
                                      hit_rate=engine.pool.hit_rate))

    if not args.scenario:
        print(head)
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
    for cls, row in rep.get("by_class", {}).items():
        print(f"  {cls}: {row['requests']} requests, TTFT p50/p99 "
              f"{_pct_ms(row['ttft'])} ms, latency p50/p99 "
              f"{_pct_ms(row['latency'])} ms")
    st = rep["stats"]
    print(f"  decode ticks {rep['decode_steps']} ({st['decode_calls']} "
          f"decode_step calls), admissions {rep['admit_calls']}, chunks "
          f"{st['chunk_calls']}, restores {st['restore_calls']}, snapshots "
          f"{st['snap_calls']}, preemptions {st['preemptions']} — "
          f"flash_decode kernel launches {rep['flash_decode_launches']} "
          f"({rep['flash_decode_per_tick']} per tick on the card, 0 "
          f"on the CPU; {st['flash_decode_outside_ticks']} outside the "
          f"ticks); logits finite: {rep['logits_finite']}")
    if mesh is not None:
        print(f"  mesh {mesh.shape['data']}x{mesh.shape['model']}: the "
              f"ranks' scheduler digests agree: {rep['ranks_agree']}")
    if args.session:
        for t, row in enumerate(rep["per_turn"]):
            print(f"  turn {t}: {row['submitted']} requests, "
                  f"{row['prefix_hits']} prefix hits "
                  f"({row['prefix_hit_tokens']} tokens served from the "
                  f"prefix store)")
    if "prefix" in rep:
        pre = rep["prefix"]
        print(f"  prefix hit rate {pre['hit_rate']:.2f} ({pre['hits']}/"
              f"{pre['hits'] + pre['misses']} lookups, "
              f"{pre['evictions']} evictions)")
    for f in rep["finished"][:8]:
        print(f"    req {f.request.rid:3d}: prompt {f.request.prompt_len:3d} "
              f"-> {f.tokens.size:3d} tok, latency "
              f"{f.latency*1e3:7.1f} ms, ttft {f.ttft*1e3:7.1f} ms")
    return rep


if __name__ == "__main__":
    main()
