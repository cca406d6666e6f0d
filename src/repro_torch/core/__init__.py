"""Core contribution: layer-wise adaptive-rate optimizers (LARS — the
paper's technique; SGD — its baseline; LAMB — its stated future work;
AdamW — LAMB's non-layer-wise baseline), LR schedules and large-batch
scaling policies, on the flat-packed substrate and the per-leaf tree
engine."""

from repro_torch.core.optim_base import (LayerwiseRule, Optimizer,  # noqa: F401
                                         OptState, PackedGrads,
                                         make_optimizer)
from repro_torch.core.packing import PackedLayout, build_layout  # noqa: F401
from repro_torch.core.sgd import sgd
from repro_torch.core.lars import lars
from repro_torch.core.lamb import lamb
from repro_torch.core.adamw import adamw
from repro_torch.core import (grad_stats, packing, schedules,  # noqa: F401
                              scaling, trust_ratio)

OPTIMIZERS = {"sgd": sgd, "lars": lars, "lamb": lamb, "adamw": adamw}


def get_optimizer(name: str, **kwargs):
    """Build an optimizer by name (config-system entry point)."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kwargs)
