"""Model zoo of the port: plain functions over nested-dict params in the
JAX package's leaf layouts. Every family of the reference is ported: the
cnn family (LeNet), the encdec family (an encoder-decoder transformer)
and the dense, MoE, SSM (Mamba-1), hybrid (Mamba-2 with a shared
attention block) and vlm (an image prefix) LM families, with GQA or MLA
attention (training, prefill and decode)."""

from repro_torch.models.encdec import EncDecModel  # noqa: F401
from repro_torch.models.lenet import LeNet  # noqa: F401
from repro_torch.models.lm import LanguageModel  # noqa: F401


def build_model(cfg):
    """Config -> model object, by family, as the reference's: LeNet
    (init/forward/stacked_marker), EncDecModel, or a LanguageModel
    (init/forward/prefill/decode_step/init_cache; ``prefill_at`` but for
    vlm), which raises on a family it does not know."""
    if cfg.family == "cnn":
        return LeNet(cfg)
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    return LanguageModel(cfg)
