"""SLO experiment grids for the port's serve engine: scenario-library
traffic (steady / bursty / diurnal / heavy-tail, priority-tiered) swept
across scheduler policy x slot count x sampler into
``EXPERIMENTS_torch_serve.json`` with claim checks. Port of
``repro/experiments/serve_grid.py`` on one device (the card unless the
caller asks for the CPU).

The headline claims the smoke grid checks (the SLO contract under a
flash crowd), the reference's:

  * **A1** — with the :class:`PriorityScheduler`, tier-0 p99 TTFT under
    the bursty scenario stays within 2x its steady-state p99;
  * **A2** — plain FIFO under the identical traffic misses by > 4x;
  * **A3** — the priority engine actually preempted under burst;
  * **contract** (the key ``contract_one_decode_trace_per_cell``, kept
    from the reference, where it means one jit trace of the decode step
    per cell) — in the port: in every cell each decode tick made exactly
    one ``decode_step`` call (``decode_calls == decode_steps``); on the
    card those calls launched ``flash_decode_per_step()`` kernels each
    (none on the CPU, where the kernel's plain version runs); and
    admission, chunks, restores and snapshots launched none.

A1–A3 are the experiment's outcome on the hardware that ran it, not
gates. Every cell of a grid runs under the SAME ``time_scale`` so "burst
at t=0.35" means the same wall-clock instant in every cell — cells
differ only in policy, not traffic timing. The weights are the port's
own random init (seed 1, the reference's seed for its own init).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.experiments.record import atomic_write_json
from repro_torch.serve.report import (ServeScenario, run_scenario,
                                      scenario_waves)
from repro_torch.serve.sampling import parse_sampler
from repro_torch.serve.scheduler import TierSLO

SCHEDULERS = ("fifo", "priority")


@dataclasses.dataclass(frozen=True)
class ServeCellSpec:
    """One serve-sweep point: scenario x scheduler x slots x sampler."""

    grid: str
    scenario: str                  # SCENARIO_LIBRARY name
    scheduler: str                 # "fifo" | "priority"
    slots: int
    sampler: str = "greedy"        # parse_sampler() string
    min_slots: Optional[int] = None   # slot autoscaling floor (None=off)
    seed: int = 0                  # traffic seed

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"have {SCHEDULERS}")

    @property
    def cell_id(self) -> str:
        base = (f"{self.scenario}-{self.scheduler}-s{self.slots}"
                f"-{self.sampler.replace(':', '_')}")
        if self.min_slots is not None:
            base += f"-min{self.min_slots}"
        if self.seed:
            base += f"-t{self.seed}"
        return base


@dataclasses.dataclass(frozen=True)
class ServeGridSpec:
    """A serve study: explicit cells + the shared engine protocol.

    ``slos`` is ((tier, ttft_s, latency_s), ...) — tuple-of-tuples so
    the spec stays frozen/hashable; priority cells materialize it into
    {tier: TierSLO}."""

    name: str
    cells: tuple[ServeCellSpec, ...]
    arch: str = "qwen3-14b"
    capacity: int = 256
    prefill_chunk: int = 8
    # large enough that every tier-1 prompt and preemption snapshot
    # stays resident — preempted decodes always replay as a one-token
    # suffix prefill instead of depending on LRU luck
    prefix_entries: int = 32
    # ... but tier-0 prompts (32 tokens) sit BELOW min_tokens, so their
    # admission always prefills from scratch: the tier-0 TTFT floor is
    # the same deterministic 4-chunk prefill in every cell, and the
    # preemption detour (trigger + evict + re-admit) adds only a tick
    # or two on top — which is exactly what claim A1 bounds
    prefix_min_tokens: int = 40
    # at most 2 admissions per tick: a flash crowd cannot fill every
    # slot with mid-prefill rows (which are never preemption victims),
    # so a deadline-risk tier-0 always finds an evictable decode
    admit_limit: Optional[int] = 2
    # tier-0 preemption triggers at preempt_at * ttft_s = 5 ms — below
    # one engine tick, so a tier-0 request stuck behind the burst evicts
    # a tier-1 decode on the very next tick
    slos: tuple = ((0, 0.05, 2.0), (1, 5.0, 60.0))
    aging_s: float = 1.0
    preempt_at: float = 0.1
    # one slot is headroom tier-1 may never take: the first of a tier-0
    # arrival pair admits instantly even while the burst is mid-prefill
    # (mid-prefill rows are not preemptable); preemption covers the
    # second of the pair
    reserve_slots: int = 1
    # fixed traffic window (seconds): every cell and every rerun replays
    # the same wall-clock arrival schedule; None = calibrate from the
    # reference cell's warmup wall
    time_scale_s: Optional[float] = 1.0
    # measured replays pooled per cell: tail percentiles sit on
    # repeats x requests samples instead of one replay's worst tick
    repeats: int = 2
    reference_scenario: str = "bursty"   # time_scale calibration cell
    claim_slots: int = 4                 # slots coordinate of the quartet
    report_name: str = ""

    @property
    def report_file(self) -> str:
        return self.report_name or f"EXPERIMENTS_torch_{self.name}.json"

    def engine_kwargs(self, cell: ServeCellSpec) -> dict:
        kw = dict(slots=cell.slots, capacity=self.capacity,
                  prefill_chunk=self.prefill_chunk,
                  prefix_entries=self.prefix_entries,
                  prefix_min_tokens=self.prefix_min_tokens,
                  admit_limit=self.admit_limit,
                  sampler=parse_sampler(cell.sampler), seed=0)
        if cell.min_slots is not None:
            kw["min_slots"] = cell.min_slots
        if cell.scheduler == "priority":
            kw["slos"] = {t: TierSLO(ttft, lat)
                          for t, ttft, lat in self.slos}
            kw["aging_s"] = self.aging_s
            kw["preempt_at"] = self.preempt_at
            kw["reserve_slots"] = self.reserve_slots
        return kw

    def scenario_for(self, cell: ServeCellSpec, vocab: int
                     ) -> ServeScenario:
        waves = scenario_waves(cell.scenario, vocab, seed=cell.seed)
        return ServeScenario(cell.cell_id, self.engine_kwargs(cell),
                             waves)

    def find_cell(self, cell_id: str) -> ServeCellSpec:
        for cell in self.cells:
            if cell.cell_id == cell_id:
                return cell
        raise KeyError(f"no cell {cell_id!r} in grid {self.name!r}; "
                       f"have {[c.cell_id for c in self.cells]}")

    def fingerprint(self) -> dict:
        import json
        return json.loads(json.dumps(dataclasses.asdict(self)))


def _smoke_cells(grid: str, slots: int = 4) -> tuple[ServeCellSpec, ...]:
    """Claim quartet (steady/bursty x fifo/priority), the remaining
    library scenarios under priority, and sweep extras across the slot
    and sampler axes plus one autoscaling variant."""
    cells = [ServeCellSpec(grid, scen, sched, slots)
             for scen in ("steady", "bursty")
             for sched in ("fifo", "priority")]
    cells += [ServeCellSpec(grid, scen, "priority", slots)
              for scen in ("heavy_tail", "diurnal")]
    cells += [
        ServeCellSpec(grid, "bursty", "priority", slots + 2),
        ServeCellSpec(grid, "bursty", "priority", slots,
                      sampler="top_k:8:0.8"),
        ServeCellSpec(grid, "bursty", "priority", slots, min_slots=2),
    ]
    return tuple(cells)


SERVE_GRIDS: dict[str, ServeGridSpec] = {
    # the smoke sweep: 9 cells on reduced qwen3-14b; the committed
    # EXPERIMENTS_torch_serve.json is this grid's output on the card
    "serve_slo_smoke": ServeGridSpec(
        name="serve_slo_smoke",
        cells=_smoke_cells("serve_slo_smoke"),
        report_name="EXPERIMENTS_torch_serve.json"),
}


def get_serve_grid(name: str, **overrides) -> ServeGridSpec:
    if name not in SERVE_GRIDS:
        raise KeyError(f"unknown serve grid {name!r}; have "
                       f"{sorted(SERVE_GRIDS)}")
    grid = SERVE_GRIDS[name]
    if overrides:
        grid = dataclasses.replace(grid, **overrides)
    return grid


# --------------------------------------------------------------- runner

def _tier0_p99(row: Optional[dict]) -> Optional[float]:
    if row is None:
        return None
    return (row.get("by_class", {}).get("tier0_interactive", {})
               .get("ttft", {}).get("p99"))


def decode_contract(row: dict) -> bool:
    """One cell's decode contract (the module docstring's)."""
    want = (row.get("flash_decode_per_step", 0) * row.get("decode_steps", 0)
            if row.get("device") == "cuda" else 0)
    return (row.get("decode_calls") == row.get("decode_steps")
            and row.get("flash_decode_launches") == want
            and row.get("flash_decode_outside_ticks") == 0)


def slo_claims(grid: ServeGridSpec, rows: dict) -> dict:
    """Boolean claim checks + the numbers behind them (the
    ``_claims`` idiom of :mod:`repro_torch.experiments.report`)."""
    def cid(scen, sched):
        return ServeCellSpec(grid.name, scen, sched,
                             grid.claim_slots).cell_id

    pb = _tier0_p99(rows.get(cid("bursty", "priority")))
    ps = _tier0_p99(rows.get(cid("steady", "priority")))
    fb = _tier0_p99(rows.get(cid("bursty", "fifo")))
    fs = _tier0_p99(rows.get(cid("steady", "fifo")))
    have = None not in (pb, ps, fb, fs) and 0 not in (ps, fs)
    bursty_pri = rows.get(cid("bursty", "priority"), {})
    claims = {
        "tier0_p99_ttft_priority_steady_s": ps,
        "tier0_p99_ttft_priority_bursty_s": pb,
        "tier0_p99_ttft_fifo_steady_s": fs,
        "tier0_p99_ttft_fifo_bursty_s": fb,
        "priority_burst_over_steady_x":
            round(pb / ps, 3) if have else None,
        "fifo_burst_over_steady_x":
            round(fb / fs, 3) if have else None,
        "A1_priority_burst_ttft_le_2x_steady":
            bool(have and pb <= 2.0 * ps),
        "A2_fifo_burst_ttft_ge_4x_steady":
            bool(have and fb >= 4.0 * fs),
        "A3_priority_preempts_under_burst":
            bool(bursty_pri.get("preemptions", 0) >= 1),
        "contract_one_decode_trace_per_cell":
            bool(rows) and all(decode_contract(r) for r in rows.values()),
    }
    return claims


def run_serve_grid(grid: ServeGridSpec, *,
                   time_scale: Optional[float] = None,
                   log=print, device="cuda") -> dict:
    """Run every cell (reference cell first to calibrate the shared
    ``time_scale``) on ``device``, aggregate rows + claims into the
    report payload."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    device = torch.device(device)
    cfg = get_config(grid.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device)

    ref = next((c for c in grid.cells
                if c.scenario == grid.reference_scenario
                and c.scheduler == "fifo"
                and c.slots == grid.claim_slots), grid.cells[0])
    ordered = [ref] + [c for c in grid.cells if c is not ref]
    rows: dict[str, dict] = {}
    scale = time_scale if time_scale is not None else grid.time_scale_s
    for cell in ordered:
        scen = grid.scenario_for(cell, cfg.vocab_size)
        row = run_scenario(model, params, scen, time_scale=scale,
                           repeats=grid.repeats)
        row["cell"] = dataclasses.asdict(cell)
        rows[cell.cell_id] = row
        if scale is None:
            scale = row["time_scale_s"]     # calibrated by the ref cell
        log(f"  {cell.cell_id}: tok/s={row['tok_per_s']}, "
            f"tier0 p99 ttft={_tier0_p99(row)}, "
            f"preemptions={row['preemptions']}, decode ticks "
            f"{row['decode_steps']} in {row['decode_calls']} decode_step "
            f"calls, flash_decode {row['flash_decode_launches']} "
            f"(+{row['flash_decode_outside_ticks']} outside the ticks)")
    return {
        "grid": grid.name,
        "fingerprint": grid.fingerprint(),
        "arch": grid.arch,
        "backend": device.type,
        "time_scale_s": scale,
        "slos": {str(t): {"ttft_s": ttft, "latency_s": lat}
                 for t, ttft, lat in grid.slos},
        "cells": rows,
        "claims": slo_claims(grid, rows),
    }


def write_serve_experiments(path: str, payload: dict) -> dict:
    """EXPERIMENTS_torch_serve.json: the SLO study under ``serve_slo``."""
    out = {"serve_slo": payload}
    atomic_write_json(path, out)
    return out


def format_serve_grid(payload: dict) -> str:
    lines = [f"serve grid {payload['grid']} on {payload['arch']} "
             f"[{payload['backend']}], time_scale="
             f"{payload['time_scale_s']}s"]
    lines.append(f"{'cell':>34s} {'tok/s':>8s} {'occ':>6s} "
                 f"{'t0 p99 ttft':>12s} {'preempt':>8s} {'ticks':>6s} "
                 f"{'calls':>6s} {'fd':>6s}")
    for cid, r in payload["cells"].items():
        t0 = _tier0_p99(r)
        lines.append(
            f"{cid:>34s} {r['tok_per_s']:8.1f} {r['occupancy']:6.2f} "
            f"{t0 if t0 is not None else '-':>12} "
            f"{r['preemptions']:8d} {r['decode_steps']:6d} "
            f"{r['decode_calls']:6d} {r['flash_decode_launches']:6d}")
    lines.append("claims:")
    for k, v in payload["claims"].items():
        lines.append(f"  {k}: {v}")
    return "\n".join(lines)
