"""Model zoo of the port: plain functions over nested-dict params in the
JAX package's leaf layouts. Only the cnn family is ported so far."""

from repro_torch.models.lenet import LeNet  # noqa: F401


def build_model(cfg):
    """Config -> model object with init/forward/stacked_marker."""
    if cfg.family == "cnn":
        return LeNet(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not yet ported to repro_torch")
