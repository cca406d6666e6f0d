"""Aggregation: completed-cell rows -> the study's metric-vs-batch
table + claim checks, written as the grid's report file
(``EXPERIMENTS_torch_<study>.json``). Port of
``repro/experiments/report.py``: the same tables and claims from the
same rows, and the PBT block (``pbt_section``, ``write_pbt_report``)
from the population controller's manifest.

CNN grids mirror the paper's Figures 2-4: final test accuracy, train
accuracy and generalization error per (optimizer, global batch),
averaged over replicate seeds, plus the claim checks the repo tracks:

  C1 both optimizers are comparable at small batch;
  C3 LARS holds >= SGD test accuracy at the largest batch;
  C4 SGD's generalization error grows faster than LARS's.

LM grids (the paper's §6 future work, run through the same protocol)
report eval perplexity per (optimizer, global batch) and the
layer-wise-vs-generic claim checks at matched batch:

  L1 the four optimizers are comparable at the smallest batch
     (within 25% relative perplexity of the best);
  L2 LAMB holds <= AdamW eval perplexity at the largest batch
     (the trust ratio earns its keep where AdamW's fixed rate
     destabilizes);
  L3 LARS holds <= SGD eval perplexity at the largest batch;
  L4 the best layer-wise optimizer beats the best generic one at the
     largest batch (the Nado et al. question, answered empirically at
     this scale).
"""

from __future__ import annotations

import os
import statistics
from typing import Optional

from repro_torch.experiments.record import (atomic_write_json, load_json,
                                            read_trajectory)
from repro_torch.experiments.spec import GridSpec, cell_from_json


def _mean(vals: list) -> Optional[float]:
    """Replicate-seed mean; ``None`` entries (a diverged cell's nulled
    metric) are skipped rather than poisoning the aggregate."""
    vals = [v for v in vals if v is not None]
    return round(statistics.fmean(vals), 4) if vals else None


# Per-family metric schema: (table key, row metric columns, the headline
# metric, whether lower is better).
FAMILY_METRICS = {
    "cnn": ("accuracy_vs_batch",
            ("test_acc", "train_acc", "gen_error"), "test_acc", False),
    "lm": ("perplexity_vs_batch",
           ("eval_ppl", "eval_loss", "eval_acc"), "eval_ppl", True),
}


def aggregate(grid: GridSpec, manifest: dict) -> dict:
    """Manifest (possibly partial) -> report payload.

    Rows group by (optimizer, batch) and average over replicate seeds.
    When the grid varies the lr-schedule axis (the warmup ablation),
    the schedule joins the optimizer label (``lars@poly_warmup``) so
    ablation cells stay separate columns instead of being averaged
    into fake replicates — the pair claims then need the plain labels
    and are skipped, which is correct: an ablation grid answers a
    different question.

    When the grid varies the opt-state-dtype axis (the int8 parity
    study), only the NON-default dtype joins the label (``lars@int8``)
    — f32 twins keep plain labels so the family claims still compute
    on the f32 baseline, and the parity claims (P*) compare each
    ``opt@int8`` column against its plain twin at matched batch."""
    table_key, columns, headline, lower_better = FAMILY_METRICS[grid.family]
    multi_sched = len(set(grid.lr_schedules)) > 1
    multi_dtype = len(set(grid.opt_state_dtypes)) > 1
    rows = [manifest["cells"][c.cell_id] for c in grid.cells()
            if c.cell_id in manifest["cells"]]
    by_cell: dict[tuple[str, int], list[dict]] = {}
    for row in rows:
        label = row["optimizer"]
        if multi_sched:
            label += "@" + row.get("lr_schedule", "inverse_time")
        if multi_dtype and row.get("opt_state_dtype", "f32") != "f32":
            label += "@" + row["opt_state_dtype"]
        by_cell.setdefault((label, row["batch"]), []).append(row)

    table: dict[str, dict[str, dict[str, float]]] = {}
    for (opt, batch), group in sorted(by_cell.items(),
                                      key=lambda kv: (kv[0][1], kv[0][0])):
        entry = {col: _mean([r.get(col) for r in group])
                 for col in columns}
        entry["replicates"] = len(group)
        table.setdefault(str(batch), {})[opt] = entry

    claims = (_cnn_claims(table) if grid.family == "cnn"
              else _lm_claims(table))
    if multi_dtype:
        claims.update(_parity_claims(table, headline, lower_better))
    slim_rows = [{k: v for k, v in row.items() if k != "layer_stats"}
                 for row in rows]
    return {
        "grid": grid.fingerprint(),
        "family": grid.family,
        "completed_cells": len(rows),
        "total_cells": len(grid.cells()),
        table_key: table,
        "claims": claims,
        "rows": slim_rows,
    }


def _cnn_claims(table: dict) -> dict:
    out: dict = {}
    batches = sorted(int(b) for b in table)
    # a claim needs both optimizers present with a NON-None metric (a
    # fully-diverged replicate group aggregates to None — skip, don't
    # crash the report)
    t = lambda b, o, k: table[str(b)][o].get(k)  # noqa: E731
    both = [b for b in batches
            if {"sgd", "lars"} <= set(table[str(b)])
            and t(b, "lars", "test_acc") is not None
            and t(b, "sgd", "test_acc") is not None]
    if not both:
        return out
    small, large = both[0], both[-1]
    out["smallest_batch"] = small
    out["largest_batch"] = large
    out["C1_comparable_at_small_batch"] = bool(
        abs(t(small, "lars", "test_acc") - t(small, "sgd", "test_acc"))
        <= 0.05)
    out["lars_test_acc_at_largest"] = t(large, "lars", "test_acc")
    out["sgd_test_acc_at_largest"] = t(large, "sgd", "test_acc")
    out["C3_lars_ge_sgd_at_largest_batch"] = bool(
        t(large, "lars", "test_acc") >= t(large, "sgd", "test_acc"))
    gen_vals = (t(large, "sgd", "gen_error"), t(small, "sgd", "gen_error"),
                t(large, "lars", "gen_error"), t(small, "lars", "gen_error"))
    if small != large and None not in gen_vals:
        sgd_growth = gen_vals[0] - gen_vals[1]
        lars_growth = gen_vals[2] - gen_vals[3]
        out["C4_sgd_gen_error_grows_faster"] = bool(
            sgd_growth >= lars_growth)
    return out


# The LM claim checks compare layer-wise optimizers against their
# generic counterparts at MATCHED batch (LAMB vs AdamW share the Adam
# direction; LARS vs SGD share the momentum direction — each pair
# isolates the trust ratio as the only differing ingredient). Each pair
# claim is emitted whenever ITS pair is complete at some batch, so
# partial grids (e.g. a lamb-vs-adamw-only sweep) still get their
# computable claims.
LM_PAIRS = (("lamb", "adamw", "L2_lamb_le_adamw_at_largest_batch"),
            ("lars", "sgd", "L3_lars_le_sgd_at_largest_batch"))
LM_OPTS = ("lamb", "adamw", "lars", "sgd")


def _lm_claims(table: dict) -> dict:
    out: dict = {}
    batches = sorted(int(b) for b in table)
    ppl = lambda b, o: table[str(b)][o].get("eval_ppl")  # noqa: E731
    # present AND non-None (diverged replicate groups drop out of the
    # claims instead of crashing them)
    has = lambda b, o: (o in table[str(b)]               # noqa: E731
                        and ppl(b, o) is not None)
    # comparability is judged where >= 2 optimizers coexist
    multi = [b for b in batches
             if sum(has(b, o) for o in LM_OPTS) >= 2]
    if not multi:
        return out
    small, large = multi[0], multi[-1]
    out["smallest_batch"] = small
    out["largest_batch"] = large
    at_small = [o for o in LM_OPTS if has(small, o)]
    at_large = [o for o in LM_OPTS if has(large, o)]
    for opt in at_large:
        out[f"{opt}_eval_ppl_at_largest"] = ppl(large, opt)
    best_small = min(ppl(small, o) for o in at_small)
    out["L1_comparable_at_small_batch"] = bool(
        max(ppl(small, o) for o in at_small) <= 1.25 * best_small)
    for layerwise, generic, key in LM_PAIRS:
        pair_batches = [b for b in batches
                        if has(b, layerwise) and has(b, generic)]
        if pair_batches:
            b = pair_batches[-1]
            out[key] = bool(ppl(b, layerwise) <= ppl(b, generic))
    if set(LM_OPTS) <= set(at_large):
        lw = min(ppl(large, "lamb"), ppl(large, "lars"))
        gen = min(ppl(large, "adamw"), ppl(large, "sgd"))
        out["L4_best_layerwise_beats_best_generic_at_largest"] = bool(
            lw <= gen)
    return out


# Parity bars for quantized optimizer states: int8 slots must land
# within replicate-seed noise of their f32 twins. Accuracy metrics use
# an absolute bar (2 points — the spread the smoke grids show between
# replicate seeds), perplexity a relative one (5%).
PARITY_ACC_ATOL = 0.02
PARITY_PPL_RTOL = 0.05


def _parity_claims(table: dict, headline: str, lower_better: bool) -> dict:
    """int8-vs-f32 parity: every ``opt@int8`` column is checked against
    its plain f32 twin at every batch where both exist. Emits the paired
    headline metrics plus one aggregate ``P1`` bool (all pairs within
    the family's parity bar)."""
    out: dict = {}
    pairs = []
    for batch in sorted(table, key=int):
        cells = table[batch]
        for label in sorted(cells):
            if not label.endswith("@int8"):
                continue
            base = label[:-len("@int8")]
            if base not in cells:
                continue
            f32_v = cells[base].get(headline)
            q8_v = cells[label].get(headline)
            if f32_v is None or q8_v is None:
                continue
            if lower_better:
                ok = q8_v <= f32_v * (1.0 + PARITY_PPL_RTOL)
            else:
                ok = q8_v >= f32_v - PARITY_ACC_ATOL
            pairs.append(ok)
            out[f"{base}_b{batch}_{headline}_f32"] = f32_v
            out[f"{base}_b{batch}_{headline}_int8"] = q8_v
    if pairs:
        out["P1_int8_matches_f32"] = bool(all(pairs))
    return out


def write_report(path: str, grid: GridSpec, manifest: dict,
                 backend: Optional[str] = None,
                 device: Optional[str] = None) -> dict:
    """Aggregate ``manifest`` and write it to ``path``. ``backend`` is
    ``"cuda"`` or ``"cpu"``; ``device`` names the card the run trained
    on (nvidia-smi's name and power limit)."""
    payload = aggregate(grid, manifest)
    if backend is not None:
        payload["backend"] = backend
    if device is not None:
        payload["device"] = device
    existing = load_json(path)
    if isinstance(existing, dict) and "pbt" in existing:
        # a PBT study of the same report file rides along under its own
        # key — a static-grid rerun refreshes the grid section without
        # discarding it
        payload["pbt"] = existing["pbt"]
    atomic_write_json(path, payload)
    return payload


# -------------------------------------------------------- PBT reporting

# "Tuned SGD closes the gap" bar: the same comparability tolerance the
# static grid's C1 uses for the small-batch sanity check.
PBT_GAP_ATOL = 0.05


def pbt_section(grid: GridSpec, pbt: dict,
                out_dir: Optional[str] = None) -> dict:
    """PBT controller manifest -> the report's ``pbt`` block: per-member
    outcome + hyperparameter schedule (the init/exploit event chain),
    per-group best member with its loss curve and final tuned hypers,
    and the tuned-gap claims (does the TUNED generic optimizer close the
    large-batch gap the static grid shows?)."""
    _, columns, headline, lower_better = FAMILY_METRICS[grid.family]
    members_out: dict = {}
    by_group: dict = {}
    counts = {"exploit": 0, "kill": 0, "early_stop": 0}
    for lineage in sorted(pbt["members"]):
        m = pbt["members"][lineage]
        cell = cell_from_json(m["cell"])
        row = m.get("row") or {}
        # the lineage's hyperparameter schedule: every point where its
        # effective (base_lr, trust_coef) changed, lineage-tagged
        schedule = [{"round": e.get("round"), "step": e.get("step"),
                     "event": e["event"], "from": e.get("from"),
                     "generation": e.get("generation", 0),
                     "base_lr": e.get("base_lr"),
                     "trust_coef": e.get("trust_coef")}
                    for e in m.get("events", ())
                    if e["event"] in ("init", "exploit")]
        for e in m.get("events", ()):
            if e["event"] in counts:
                counts[e["event"]] += 1
        entry = {"cell_id": cell.cell_id, "status": m["status"],
                 "reason": m.get("reason"), "steps": m.get("step", 0),
                 "generation": cell.generation,
                 "base_lr": cell.cell_base_lr,
                 "trust_coef": cell.cell_trust_coef,
                 "schedule": schedule}
        for col in ("loss",) + columns:
            if col in row:
                entry[col] = row[col]
        members_out[lineage] = entry
        by_group.setdefault((cell.optimizer, cell.batch),
                            []).append((lineage, m, cell))

    groups_out: dict = {}
    for (opt, batch), group in sorted(by_group.items()):
        done = [(lin, m, c) for lin, m, c in group
                if m["status"] == "done"
                and (m.get("row") or {}).get(headline) is not None]
        g = {"members": len(group), "finished": len(done),
             "killed": sum(m["status"] == "killed" for _, m, _ in group),
             "early_stopped": sum(m["status"] == "early_stopped"
                                  for _, m, _ in group)}
        if done:
            pick = min if lower_better else max
            lin, m, cell = pick(done, key=lambda t: t[1]["row"][headline])
            best = {"lineage": lin, "cell_id": cell.cell_id,
                    "generation": cell.generation,
                    "base_lr": cell.cell_base_lr,
                    "trust_coef": cell.cell_trust_coef,
                    headline: m["row"][headline]}
            if out_dir is not None:
                traj = os.path.join(out_dir, lin, "trajectory.jsonl")
                if os.path.exists(traj):
                    best["loss_curve"] = [
                        r.get("loss") for r in read_trajectory(traj)
                        if "event" not in r]
            g["best"] = best
        groups_out[f"{opt}-b{batch}"] = g

    # the controller's trust-coefficient map at run end (which eta each
    # trust-ratio lineage converged to — the paper's sensitive knob)
    trust_map = {lin: cell.cell_trust_coef
                 for group in by_group.values()
                 for lin, _m, cell in group
                 if cell.optimizer in ("lars", "lamb")}

    claims: dict = {}
    for batch in sorted({b for (_, b) in by_group}):
        lars = (groups_out.get(f"lars-b{batch}") or {}).get("best")
        sgd = (groups_out.get(f"sgd-b{batch}") or {}).get("best")
        if not (lars and sgd):
            continue
        gap = round(lars[headline] - sgd[headline], 4)
        if lower_better:
            gap = -gap
        claims[f"b{batch}_best_lars_{headline}"] = lars[headline]
        claims[f"b{batch}_best_tuned_sgd_{headline}"] = sgd[headline]
        claims[f"b{batch}_gap"] = gap
        claims[f"P1_tuned_sgd_closes_gap_b{batch}"] = bool(
            gap <= PBT_GAP_ATOL)
    return {"protocol": pbt.get("controller", {}),
            "rounds": pbt.get("round", 0),
            "events": counts, "members": members_out,
            "groups": groups_out, "final_trust_coef": trust_map,
            "claims": claims}


def write_pbt_report(path: str, grid: GridSpec, pbt: dict,
                     out_dir: Optional[str] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> dict:
    """Merge the PBT block into the study's report file UNDER its own
    ``pbt`` key (the static grid's tables and claims in the same file
    stay untouched). ``backend`` and ``device`` as in
    :func:`write_report`, inside the block."""
    section = pbt_section(grid, pbt, out_dir=out_dir)
    if backend is not None:
        section["backend"] = backend
    if device is not None:
        section["device"] = device
    existing = load_json(path)
    payload = existing if isinstance(existing, dict) else {}
    payload["pbt"] = section
    atomic_write_json(path, payload)
    return payload


def format_table(payload: dict) -> str:
    """Human-readable metric-vs-batch table for CLI output."""
    if payload.get("family", "cnn") == "lm":
        lines = [f"{'batch':>7s} {'opt':6s} {'eval_ppl':>9s} "
                 f"{'eval_loss':>10s} {'eval_acc':>9s}"]
        for batch in sorted(payload["perplexity_vs_batch"], key=int):
            cells = payload["perplexity_vs_batch"][batch]
            for opt, m in sorted(cells.items()):
                lines.append(f"{batch:>7s} {opt:6s} {m['eval_ppl']:9.3f} "
                             f"{m['eval_loss']:10.4f} {m['eval_acc']:9.4f}")
        return "\n".join(lines)
    lines = [f"{'batch':>7s} {'opt':6s} {'train':>7s} {'test':>7s} "
             f"{'gen_err':>8s}"]
    for batch in sorted(payload["accuracy_vs_batch"], key=int):
        for opt, m in sorted(payload["accuracy_vs_batch"][batch].items()):
            lines.append(f"{batch:>7s} {opt:6s} {m['train_acc']:7.4f} "
                         f"{m['test_acc']:7.4f} {m['gen_error']:8.4f}")
    return "\n".join(lines)
