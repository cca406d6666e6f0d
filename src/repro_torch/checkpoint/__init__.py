"""Checkpointing: the full TrainState (params + packed optimizer slots +
step) to and from npz, in the JAX package's format."""

from repro_torch.checkpoint.npz import (clone_checkpoint,  # noqa: F401
                                        restore_train_state,
                                        save_train_state)
