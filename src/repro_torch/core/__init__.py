"""Core contribution: layer-wise adaptive-rate optimizers (LARS — the
paper's technique; SGD — its baseline), LR schedules and large-batch
scaling policies, on the flat-packed substrate."""

from repro_torch.core.optim_base import (LayerwiseRule, Optimizer,  # noqa: F401
                                         OptState, PackedGrads,
                                         make_optimizer)
from repro_torch.core.packing import PackedLayout, build_layout  # noqa: F401
from repro_torch.core.sgd import sgd
from repro_torch.core.lars import lars
from repro_torch.core import packing, schedules, scaling, trust_ratio  # noqa: F401

OPTIMIZERS = {"sgd": sgd, "lars": lars}
NOT_YET_PORTED = ("lamb", "adamw")


def get_optimizer(name: str, **kwargs):
    """Build an optimizer by name (config-system entry point)."""
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not yet ported to repro_torch")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kwargs)
