"""Config registry: ``--arch <id>`` resolution. The port registers the
architectures it runs; the JAX package's other archs are named here so
that asking for one says it is not yet ported rather than unknown.
"""

from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs import lenet_mnist

ARCHS: dict[str, ModelConfig] = {lenet_mnist.CONFIG.name: lenet_mnist.CONFIG}

# registered in repro.configs, not yet in the port
NOT_YET_PORTED = ("whisper-base", "deepseek-v2-236b", "zamba2-7b",
                  "smollm-135m", "minitron-8b", "falcon-mamba-7b",
                  "qwen3-14b", "qwen2-72b", "paligemma-3b",
                  "granite-moe-3b-a800m")


def get_config(name: str) -> ModelConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; have "
            f"{sorted(ARCHS)}")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
