"""Model zoo of the port: plain functions over nested-dict params in the
JAX package's leaf layouts. The cnn family (LeNet) and the dense, MoE,
SSM (Mamba-1) and hybrid (Mamba-2 with a shared attention block) LM
families, with GQA or MLA attention (training, prefill and decode), are
ported so far."""

from repro_torch.models.lenet import LeNet  # noqa: F401
from repro_torch.models.lm import FAMILIES as LM_FAMILIES
from repro_torch.models.lm import LanguageModel  # noqa: F401


def build_model(cfg):
    """Config -> model object (LeNet: init/forward/stacked_marker; the
    dense, MoE, SSM and hybrid LMs: init/forward/prefill/prefill_at/
    decode_step/init_cache)."""
    if cfg.family == "cnn":
        return LeNet(cfg)
    if cfg.family in LM_FAMILIES:
        return LanguageModel(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not yet ported to repro_torch")
