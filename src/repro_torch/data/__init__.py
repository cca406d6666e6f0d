"""Data pipeline: synthetic MNIST (rendered procedurally), synthetic
token-LM data, the host batch iterator, and the one-device host loader
that places batches on the device ahead of the consumer.
"""

from repro_torch.data.mnist import synthetic_mnist  # noqa: F401
from repro_torch.data.tokens import (TokenTaskConfig,  # noqa: F401
                                     token_batches, token_eval_set)
from repro_torch.data.loader import (Prefetcher, ShardedLoader,  # noqa: F401
                                     batch_iterator, place)
