"""Config registry: ``--arch <id>`` resolution. The port registers every
architecture of the JAX package; ``NOT_YET_PORTED`` names any that it
does not run yet, so that asking for one says so rather than unknown
(none is left).
"""

from repro_torch.configs.base import ModelConfig, param_count  # noqa: F401
from repro_torch.configs.shapes import (SHAPES, TRAIN_4K,  # noqa: F401
                                        PREFILL_32K, DECODE_32K, LONG_500K,
                                        LONG_CONTEXT_WINDOW, InputShape)
from repro_torch.configs import (deepseek_v2_236b, falcon_mamba_7b,
                                 granite_moe_3b_a800m, lenet_mnist,
                                 minitron_8b, paligemma_3b, qwen2_72b,
                                 qwen3_14b, smollm_135m, whisper_base,
                                 zamba2_7b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (lenet_mnist, smollm_135m, qwen3_14b,
                                      qwen2_72b, minitron_8b,
                                      granite_moe_3b_a800m,
                                      deepseek_v2_236b, falcon_mamba_7b,
                                      zamba2_7b, whisper_base, paligemma_3b)}

# registered in repro.configs, not yet in the port
NOT_YET_PORTED: tuple[str, ...] = ()


def get_config(name: str) -> ModelConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; have "
            f"{sorted(ARCHS)}")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise ValueError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
