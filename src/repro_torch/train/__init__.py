"""Training runtime of the port: TrainState, step factories,
losses/metrics and the host-side loop (cnn family)."""

from repro_torch.train.state import TrainState, create_train_state  # noqa: F401
from repro_torch.train.losses import (softmax_cross_entropy,  # noqa: F401
                                      classification_loss)
from repro_torch.train.metrics import accuracy, generalization_error  # noqa: F401
from repro_torch.train.step import make_train_step, make_eval_step  # noqa: F401
from repro_torch.train.loop import train_loop  # noqa: F401
