"""lenet-mnist — the paper's own CNN (§3.1 Fig. 1): 2 conv + 3 FC,
trained on (synthetic) MNIST for the SGD-vs-LARS batch-size sweep.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="lenet-mnist",
    family="cnn",
    num_layers=5,
    d_model=0,
    vocab_size=10,          # num classes
    act="relu",
    dtype="float32",
    remat=False,
    scan_layers=False,
    source="Chowdhury et al. 2021 §3.1",
)
