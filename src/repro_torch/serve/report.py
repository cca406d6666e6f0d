"""Serve-side experiment path of the port: declarative traffic scenarios
-> per-scenario TTFT/latency percentiles + throughput. Port of
``repro/serve/report.py`` (host-side Python over the port's
:class:`~repro_torch.serve.engine.ServeEngine`).

A :class:`ServeScenario` names an engine configuration plus traffic as
WAVES of requests (the engine drains between waves — wave 2 can hit
prefix snapshots wave 1 left behind). Within a wave each request carries
a fractional arrival offset; :func:`run_scenario` replays offsets
against a wall-clock ``time_scale`` (by default the scenario's own
warmup wall), so "a short request lands while a long prefill is in
flight" reproduces across hardware speeds. Warmup runs the full traffic
once on the same engine (on the card it builds the kernels and warms
the allocator; it also leaves the prefix pool warm — measured numbers
are steady-state).

Reported per scenario: request count, useful tok/s, wall, occupancy,
TTFT/latency percentiles (p50/p90/p99/mean/max, overall and per traffic
class — a class with zero completions gets an explicit empty row),
preemption counters, prefix-pool hit stats, and the decode contract's
counts: ``decode_calls`` against ``decode_steps`` (one ``decode_step``
call per decode tick), the ``flash_decode`` launches in those ticks
against ``flash_decode_per_step`` a tick, and the launches outside them
(none). The reference reports its jit trace count there instead.

The SLO scenario library (:data:`SCENARIO_LIBRARY`: steady / bursty /
diurnal / heavy_tail) builds priority-tiered traffic for the
``PriorityScheduler`` sweep in ``experiments/serve_grid.py``; the
traffic functions are the reference's, so one seed gives both packages
the same requests.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.engine import ServeEngine


@dataclasses.dataclass
class TrafficItem:
    """One request: ``at`` is the fractional arrival offset within the
    wave (0 = wave start, scaled by ``time_scale`` seconds); ``tier``
    is the priority tier handed to the scheduler (0 = highest)."""

    tokens: np.ndarray
    max_new: int
    at: float = 0.0
    cls: str = ""        # traffic class for per-class percentiles
    tier: int = 0


@dataclasses.dataclass
class ServeScenario:
    """Engine configuration + traffic. ``engine`` holds ServeEngine
    kwargs (slots, capacity, prefill_chunk, prefix_entries, ...)."""

    name: str
    engine: dict
    waves: list[list[TrafficItem]]

    def total_requests(self) -> int:
        return sum(len(w) for w in self.waves)


# ------------------------------------------------------------- traffic

def shared_prefix_traffic(vocab: int, *, sessions: int = 3,
                          per_session: int = 3, prefix_len: int = 160,
                          suffix_len: int = 8, max_new: int = 8,
                          seed: int = 0) -> list[list[TrafficItem]]:
    """Session-style traffic: each session's requests share a long
    system-prompt prefix and differ in a short suffix. Wave 1 carries
    one primer per session (cold — its chunk-boundary snapshots seed
    the prefix store); wave 2 carries the followers."""
    rng = np.random.default_rng(seed)
    primers, followers = [], []
    for s in range(sessions):
        prefix = rng.integers(1, vocab, size=prefix_len).astype(np.int32)
        for r in range(per_session):
            suffix = rng.integers(1, vocab, size=suffix_len).astype(np.int32)
            item = TrafficItem(np.concatenate([prefix, suffix]), max_new)
            (primers if r == 0 else followers).append(item)
    return [primers, followers]


def mixed_length_traffic(vocab: int, *, n_long: int = 3, n_short: int = 9,
                         long_len: int = 192, short_len: int = 8,
                         long_new: int = 8, short_new: int = 8,
                         seed: int = 0) -> list[list[TrafficItem]]:
    """Concurrent-decode TTFT workload: long-prompt requests spread over
    the first 60% of the (scaled) wave window, short requests arriving
    densely over the prefill-heavy first half — shorts land while long
    prefills are in flight, which is exactly what monolithic admission
    makes them wait for."""
    rng = np.random.default_rng(seed)
    wave = []
    for i in range(n_long):
        p = rng.integers(1, vocab, size=long_len).astype(np.int32)
        wave.append(TrafficItem(p, long_new, cls="long",
                                at=0.6 * i / max(1, n_long)))
    for i in range(n_short):
        p = rng.integers(1, vocab, size=short_len).astype(np.int32)
        wave.append(TrafficItem(p, short_new, cls="short",
                                at=0.5 * i / n_short))
    return [sorted(wave, key=lambda t: t.at)]


# ----------------------------------------------------- scenario library
#
# SLO-bench traffic shapes. All of them emit two uniform classes so the
# sweep's claim code can compare across scenarios:
#   * ``tier0_interactive`` — tier 0, short prompt / short decode;
#   * ``tier1_batch``       — tier 1, longer prompt / long decode
#     (decode-heavy on purpose: they hold slots, which is exactly what
#     makes them preemptable when a tier-0 deadline is at risk).

def bursty_tier_traffic(vocab: int, *, interactive: int = 10,
                        burst: int = 8, burst_at: float = 0.35,
                        interactive_len: int = 32, interactive_new: int = 6,
                        burst_len: int = 64, burst_new: int = 48,
                        steady: bool = False,
                        seed: int = 0) -> list[list[TrafficItem]]:
    """Tier-0 interactive requests spread over the wave window, plus a
    tier-1 long-decode batch that lands all at once at ``burst_at`` —
    the flash crowd that makes FIFO miss tier-0 TTFT deadlines. With
    ``steady=True`` the same batch load is spread evenly instead: the
    steady-state baseline the SLO claim compares against.

    Tier-0 arrivals come in PAIRS at the same offset: one of the pair
    can always ride a reserved-headroom slot, the other exercises the
    preemption path whenever the batch load holds the rest."""
    rng = np.random.default_rng(seed)
    wave = []
    for i in range(interactive):
        p = rng.integers(1, vocab, size=interactive_len).astype(np.int32)
        wave.append(TrafficItem(p, interactive_new, tier=0,
                                cls="tier0_interactive",
                                at=0.9 * (i - i % 2) / max(1, interactive)))
    for i in range(burst):
        p = rng.integers(1, vocab, size=burst_len).astype(np.int32)
        at = (0.9 * (i + 0.5) / max(1, burst) if steady
              else burst_at + 0.005 * i)
        wave.append(TrafficItem(p, burst_new, tier=1, cls="tier1_batch",
                                at=at))
    return [sorted(wave, key=lambda t: t.at)]


def steady_tier_traffic(vocab: int, **kw) -> list[list[TrafficItem]]:
    """The bursty mix with its batch load spread evenly over the wave —
    identical request population, steady-state arrival process."""
    return bursty_tier_traffic(vocab, steady=True, **kw)


def diurnal_tier_traffic(vocab: int, *, n: int = 24, cycles: int = 2,
                         amplitude: float = 0.8, prompt_len: int = 16,
                         max_new: int = 10, tier0_every: int = 3,
                         seed: int = 0) -> list[list[TrafficItem]]:
    """Arrivals follow a sinusoidal day/night rate profile: offsets are
    the inverse-CDF of ``1 + amplitude*sin(2*pi*cycles*t)``, so requests
    cluster at the peaks. Every ``tier0_every``-th request is tier-0
    interactive (half-length prompt/decode), the rest tier-1."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 1.0, 512)
    rate = 1.0 + amplitude * np.sin(2 * np.pi * cycles * grid)
    cdf = np.cumsum(rate)
    cdf /= cdf[-1]
    wave = []
    for i in range(n):
        at = float(np.interp((i + 0.5) / n, cdf, grid)) * 0.95
        if i % tier0_every == 0:
            p = rng.integers(1, vocab,
                             size=max(1, prompt_len // 2)).astype(np.int32)
            wave.append(TrafficItem(p, max(1, max_new // 2), tier=0,
                                    cls="tier0_interactive", at=at))
        else:
            p = rng.integers(1, vocab, size=prompt_len).astype(np.int32)
            wave.append(TrafficItem(p, max_new, tier=1, cls="tier1_batch",
                                    at=at))
    return [sorted(wave, key=lambda t: t.at)]


def heavy_tail_tier_traffic(vocab: int, *, n: int = 18, zipf_a: float = 1.4,
                            unit_len: int = 6, max_prompt: int = 120,
                            base_new: int = 4, max_new_cap: int = 48,
                            seed: int = 0) -> list[list[TrafficItem]]:
    """Zipf prompt/output lengths: request i draws ``k ~ Zipf(zipf_a)``
    and gets a ``k``-unit prompt and decode budget (capped). The many
    1-unit draws are tier-0 interactive; the rare heavy tail is tier-1
    batch — the mix where one elephant can starve a herd of mice."""
    rng = np.random.default_rng(seed)
    ks = rng.zipf(zipf_a, size=n)
    wave = []
    for i, k in enumerate(ks):
        k = int(k)
        plen = int(min(k * unit_len, max_prompt))
        mnew = int(min(base_new * k, max_new_cap))
        tier = 0 if k <= 1 else 1
        cls = "tier0_interactive" if tier == 0 else "tier1_batch"
        p = rng.integers(1, vocab, size=plen).astype(np.int32)
        wave.append(TrafficItem(p, mnew, tier=tier, cls=cls,
                                at=0.9 * i / max(1, n)))
    return [sorted(wave, key=lambda t: t.at)]


SCENARIO_LIBRARY = {
    "steady": steady_tier_traffic,
    "bursty": bursty_tier_traffic,
    "diurnal": diurnal_tier_traffic,
    "heavy_tail": heavy_tail_tier_traffic,
}


# The port's own shapes beside the reference's library. ``bursty_32`` is
# the bursty mix sized for a 32-slot engine at full width: a flash crowd
# of 31 tier-1 requests (512-token prompts, 128 new tokens) at the
# window's start fills every slot but a reserved one, while 4 tier-0
# pairs arrive over the window and must preempt.
SIZED_SCENARIOS = {
    "bursty_32": functools.partial(bursty_tier_traffic, interactive=8,
                                   burst=31, burst_at=0.0, burst_len=512,
                                   burst_new=128),
}


def scenario_waves(name: str, vocab: int, **kw) -> list[list[TrafficItem]]:
    """Build a named traffic shape: the scenario library's or one of
    :data:`SIZED_SCENARIOS`."""
    make = SCENARIO_LIBRARY.get(name) or SIZED_SCENARIOS.get(name)
    if make is None:
        raise ValueError(f"unknown scenario {name!r}; have "
                         f"{sorted(SCENARIO_LIBRARY) + sorted(SIZED_SCENARIOS)}")
    return make(vocab, **kw)


# -------------------------------------------------------------- runner

def _drive_wave(engine: ServeEngine, wave: Sequence[TrafficItem],
                time_scale: float, classes: Optional[dict] = None) -> list:
    """Submit the wave's items at their scaled arrival offsets while
    stepping the engine; drain before returning. ``classes`` collects
    rid -> traffic class for per-class percentiles. The arrivals are
    replayed by the engine's clock (on a serving mesh rank 0's, so that
    every rank submits the same requests at the same tick)."""
    finished = []
    items = sorted(wave, key=lambda t: t.at)
    i, t0 = 0, engine.clock()
    while i < len(items) or engine.scheduler.has_work():
        now = engine.clock() - t0
        while i < len(items) and items[i].at * time_scale <= now:
            rid = engine.submit(items[i].tokens, items[i].max_new,
                                tier=items[i].tier)
            if classes is not None and items[i].cls:
                classes[rid] = items[i].cls
            i += 1
        if not engine.scheduler.has_work():
            nxt = items[i].at * time_scale - now
            if nxt > 0:
                time.sleep(nxt)
            continue
        finished.extend(engine.step())
    return finished


def _pct(vals: list) -> dict:
    """Percentile row. Zero samples (a starved/cancelled traffic class)
    returns an EXPLICIT empty row — ``count: 0`` with null percentiles —
    rather than crashing or reporting an indistinguishable 0.0."""
    if not vals:
        return {"count": 0, "empty": True, "p50": None, "p90": None,
                "p99": None, "mean": None, "max": None}
    a = np.asarray(vals, np.float64)
    return {"count": len(vals),
            "p50": round(float(np.percentile(a, 50)), 5),
            "p90": round(float(np.percentile(a, 90)), 5),
            "p99": round(float(np.percentile(a, 99)), 5),
            "mean": round(float(a.mean()), 5),
            "max": round(float(a.max()), 5)}


def summarize(finished: list, wall: float, engine: ServeEngine,
              classes: Optional[dict] = None) -> dict:
    tokens = int(sum(f.tokens.size for f in finished))
    out = {
        "requests": len(finished),
        "tokens": tokens,
        "wall_s": round(wall, 4),
        "tok_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
        "occupancy": round(engine.occupancy, 4),
        "ttft": _pct([f.ttft for f in finished]),
        "latency": _pct([f.latency for f in finished]),
        "decode_steps": int(engine.stats["decode_steps"]),
        "decode_calls": int(engine.stats["decode_calls"]),
        "flash_decode_per_step": engine.model.flash_decode_per_step(),
        "flash_decode_launches": int(engine.stats["flash_decode_launches"]),
        "flash_decode_outside_ticks":
            int(engine.stats["flash_decode_outside_ticks"]),
        "device": engine.device.type,
        "chunk_calls": engine.stats["chunk_calls"],
        "preemptions": int(engine.stats.get("preemptions", 0)),
        "replayed_tokens": int(engine.stats.get("replayed_tokens", 0)),
    }
    if engine.min_slots is not None:
        ticks = max(1, int(engine.stats.get("ticks", 0)))
        out["slot_target_mean"] = round(
            float(engine.stats.get("slot_target_sum", 0.0)) / ticks, 3)
    if classes:
        by_class = {}
        for cls in sorted(set(classes.values())):
            fs = [f for f in finished if classes.get(f.request.rid) == cls]
            by_class[cls] = {"requests": len(fs),
                             "ttft": _pct([f.ttft for f in fs]),
                             "latency": _pct([f.latency for f in fs])}
        out["by_class"] = by_class
    if engine.pool is not None:
        out["prefix"] = dict(engine.pool.stats,
                             hit_rate=round(engine.pool.hit_rate, 4))
    return out


def run_scenario(model, params, scenario: ServeScenario, *,
                 warmup: bool = True,
                 time_scale: Optional[float] = None,
                 repeats: int = 1) -> dict:
    """Execute a scenario; returns its summary row. ``time_scale``
    (seconds) stretches fractional arrival offsets — pass the SAME
    value to two scenarios to compare them under identical traffic
    timing; None uses the scenario's own warmup wall (or 0 when warmup
    is off: all arrivals immediate). ``repeats`` replays the measured
    traffic that many times (draining in between) and pools the
    samples, steadying the tail percentiles.

    Warmup drives the traffic once with every arrival immediate (it
    warms the allocator and the library handles, and leaves the prefix
    pool warm). The reference then replays the staggered schedule as
    often as the measurement will, to compile the admission shapes its
    jit meets under timed arrivals; eager PyTorch compiles nothing, so
    the port leaves those replays out. A second untimed pass calibrates
    the scale only when ``time_scale`` is None."""
    engine = ServeEngine(model, params, **scenario.engine)
    warm_wall = 0.0
    staggered = any(t.at > 0 for w in scenario.waves for t in w)
    if warmup:
        t0 = time.perf_counter()
        for wave in scenario.waves:
            _drive_wave(engine, wave, 0.0)
        warm_wall = time.perf_counter() - t0
        if staggered and time_scale is None:
            # calibration pass: a warm busy wall, so arrivals in the
            # measured run land inside the busy window rather than
            # spreading over one inflated by the first pass's set-up
            t0 = time.perf_counter()
            for wave in scenario.waves:
                _drive_wave(engine, wave, 0.0)
            warm_wall = time.perf_counter() - t0
        engine.reset_stats()
    scale = time_scale if time_scale is not None else warm_wall
    finished, classes = [], {}
    t0 = time.perf_counter()
    for _ in range(max(1, repeats)):
        for wave in scenario.waves:
            finished.extend(_drive_wave(engine, wave, scale, classes))
    wall = time.perf_counter() - t0
    row = summarize(finished, wall, engine, classes)
    row["warmup_wall_s"] = round(warm_wall, 4)
    row["time_scale_s"] = round(scale, 4)
    row["engine"] = {k: v for k, v in scenario.engine.items()
                     if isinstance(v, (int, float, str, bool, type(None)))}
    return row


# -------------------------------------------------------------- report

def write_serve_report(path: str, payload: dict) -> dict:
    """Write ``payload`` under the ``serve`` key of ``path``, keeping
    any other top-level keys already in the file."""
    import json
    import os

    # deferred: the experiments package imports the serve grid, which
    # imports this module
    from repro_torch.experiments.record import atomic_write_json
    existing = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            existing = {}
    existing["serve"] = payload
    atomic_write_json(path, existing)
    return existing


def _fmt_pct(row: dict, key: str) -> str:
    v = row.get(key)
    return f"{v:9.4f}" if v is not None else f"{'-':>9s}"


def format_scenarios(scenarios: dict) -> str:
    """Human-readable scenario table for CLI output. Empty-sample
    percentile rows print '-' instead of a misleading 0.0."""
    lines = [f"{'scenario':>14s} {'req':>4s} {'tok/s':>8s} {'occ':>6s} "
             f"{'ttft p50':>9s} {'ttft p99':>9s} {'lat p99':>9s} "
             f"{'hit rate':>9s}"]
    for name, r in scenarios.items():
        hit = r.get("prefix", {}).get("hit_rate")
        lines.append(
            f"{name:>14s} {r['requests']:4d} {r['tok_per_s']:8.1f} "
            f"{r['occupancy']:6.2f} "
            f"{_fmt_pct(r['ttft'], 'p50')} "
            f"{_fmt_pct(r['ttft'], 'p99')} "
            f"{_fmt_pct(r['latency'], 'p99')} "
            f"{hit if hit is not None else '-':>9}")
    return "\n".join(lines)
