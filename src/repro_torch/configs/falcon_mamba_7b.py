"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355].

64L, d_model=4096 (d_inner=8192), ssm_state=16, vocab=65024.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    ssm_variant="mamba1",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    act="silu",
    source="arXiv:2410.05355",
)
