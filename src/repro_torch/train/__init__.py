"""Training runtime of the port: TrainState, step factories, the
large-batch TrainPipeline, losses/metrics and the host-side loop (cnn
and the dense, MoE, SSM and hybrid LM families)."""

from repro_torch.train.state import (TrainState,  # noqa: F401
                                     create_train_state,
                                     train_state_from_params)
from repro_torch.train.losses import (softmax_cross_entropy,  # noqa: F401
                                      classification_loss, lm_loss)
from repro_torch.train.metrics import accuracy, generalization_error  # noqa: F401
from repro_torch.train.step import make_train_step, make_eval_step  # noqa: F401
from repro_torch.train.loop import train_loop  # noqa: F401
from repro_torch.train.pipeline import (PRECISIONS, Precision,  # noqa: F401
                                        TrainPipeline, cast_floats,
                                        get_precision)
