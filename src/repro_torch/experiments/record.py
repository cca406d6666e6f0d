"""Structured JSONL trajectory recording for experiment cells (port of
``repro/experiments/record.py``; the same files).

One line per training step::

    {"step": 0, "loss": 2.41, "aux_loss": 0.0,
     "trust": {"trust_min": ..., "trust_max": ..., ...},
     "wall_s": 0.41}

Everything except ``wall_s`` is a pure function of (grid, cell) — the
golden/resume tests compare trajectories with timing keys stripped via
:func:`read_trajectory`. Records are flushed line-by-line so a killed
sweep leaves a readable prefix, and :func:`truncate_trajectory` rewinds
a partial file to the step a restored checkpoint corresponds to.

Two hardening rules every writer/reader here follows:

* **Strict JSON only.** A diverging cell produces NaN/Inf losses, and
  ``json.dumps`` would happily emit the non-standard ``NaN`` /
  ``Infinity`` tokens — invalid strict JSON that poisons committed
  ``EXPERIMENTS_*.json`` files and every downstream parser. Non-finite
  floats are serialized as ``null`` and the enclosing record gains a
  ``"diverged": true`` flag (the PBT controller's kill rule consumes
  it); both writers pass ``allow_nan=False`` so the class of bug cannot
  regress silently.
* **Contiguous steps.** Trajectories interleave per-step records
  (``"step": i`` with i == the record's index among step records) with
  PBT *event* records (``"event": ...`` — exploit/mutation markers that
  carry the boundary step they were applied at). ``truncate_trajectory``
  validates the step records are exactly ``0, 1, 2, ...`` during its
  scan and fails loudly on a gap or duplicate — a gapped prefix would
  otherwise pass the resume ``kept == start`` check with corrupted
  history.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.bridge import tensor_to_numpy

# Per-record keys that are NOT deterministic functions of the cell spec
# (compared runs strip these): wall clock and the LM cells' token
# throughput derived from it.
TIMING_KEYS = ("wall_s", "tokens_per_s")


def to_jsonable(x: Any) -> Any:
    """Tensors (on any device) / numpy values -> plain JSON values
    (recursive)."""
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    arr = tensor_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


def null_nonfinite(x: Any) -> tuple[Any, bool]:
    """Replace non-finite floats with ``None`` recursively; returns the
    sanitized value and whether anything non-finite was found. Run on
    already-jsonable payloads (after :func:`to_jsonable`)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None, True
    if isinstance(x, dict):
        found = False
        out = {}
        for k, v in x.items():
            out[k], f = null_nonfinite(v)
            found = found or f
        return out, found
    if isinstance(x, (list, tuple)):
        found = False
        out = []
        for v in x:
            sv, f = null_nonfinite(v)
            out.append(sv)
            found = found or f
        return out, found
    return x, False


class TrajectoryRecorder:
    """Append-only JSONL writer with per-record flush.

    Non-finite floats in a record are serialized as ``null`` and the
    record is flagged ``"diverged": true`` — trajectory files stay
    strict JSON even when the cell's loss goes NaN/Inf."""

    def __init__(self, path: str, *, append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a" if append else "w")

    def record(self, entry: dict) -> None:
        entry, diverged = null_nonfinite(to_jsonable(entry))
        if diverged:
            entry["diverged"] = True
        self._f.write(json.dumps(entry, allow_nan=False) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory(path: str, *, strip_timing: bool = False
                    ) -> list[dict]:
    """Load a JSONL trajectory; ``strip_timing`` drops the wall-clock
    keys so two runs of the same cell compare exactly equal."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if strip_timing:
                for key in TIMING_KEYS:
                    rec.pop(key, None)
            records.append(rec)
    return records


def truncate_trajectory(path: str, *, keep_below_step: int) -> int:
    """Drop records at/after ``keep_below_step`` (resume rewinds to the
    last checkpoint; the re-run steps re-record identically). Returns
    the number of STEP records kept. Tolerates a torn final line from a
    kill mid-write.

    The scan validates contiguity as it goes: the kept step records
    must be exactly ``step == 0, 1, 2, ...`` — a gap or duplicate below
    the truncation point means the run directory is corrupted (a resume
    from it would stitch a wrong-history prefix onto a correct suffix),
    so it fails loudly naming the first bad record instead of trusting
    the file. PBT *event* records (``"event": ...``, carrying the
    boundary step they were applied at) are kept when their step is at
    or below the truncation point and don't count toward contiguity."""
    if not os.path.exists(path):
        return 0
    kept = []
    n_steps = 0
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail from an interrupted write
            if "event" in rec:
                # applied at a boundary: kept iff the resume point is
                # at/after it (an event AT the checkpointed step still
                # governs the steps that follow the restore)
                if rec.get("step", 0) > keep_below_step:
                    break
                kept.append(line)
                continue
            step = rec.get("step", -1)
            if step >= keep_below_step:
                break
            if step != n_steps:
                raise ValueError(
                    f"corrupted run directory: {path} line {lineno} has "
                    f"step {step}, expected {n_steps} (step records must "
                    "be contiguous below the checkpointed step — delete "
                    "the run directory and restart the cell)")
            n_steps += 1
            kept.append(line)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for line in kept:
            f.write(line + "\n")
    os.replace(tmp, path)
    return n_steps


def atomic_write_json(path: str, payload: Any) -> None:
    """Crash-safe STRICT-JSON write (manifest updates between cells).

    Non-finite floats (a diverged cell's summary row) become ``null``;
    ``allow_nan=False`` then guarantees the committed file parses under
    every strict JSON reader — the tier-1 lint re-checks this."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload, _ = null_nonfinite(to_jsonable(payload))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, allow_nan=False)
    os.replace(tmp, path)


def load_json(path: str) -> Optional[Any]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
