"""``--set FIELD=VALUE`` config-override parsing (port of
``repro/launch/overrides.py``). Side-effect free: it touches no device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable


def parse_val(v: str) -> Any:
    """"true"/"false" -> bool, then int, then float, else the raw string."""
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for t in (int, float):
        try:
            return t(v)
        except ValueError:
            pass
    return v


def parse_overrides(pairs: Iterable[str]) -> dict[str, Any]:
    """["a=1", "b=true"] -> {"a": 1, "b": True} (first '=' splits)."""
    out = {}
    for s in pairs:
        if "=" not in s:
            raise ValueError(f"--set expects FIELD=VALUE, got {s!r}")
        k, v = s.split("=", 1)
        out[k] = parse_val(v)
    return out


def apply_overrides(cfg, pairs: Iterable[str]):
    """Return ``cfg`` with the parsed ``--set`` pairs replaced in."""
    overrides = parse_overrides(pairs)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
