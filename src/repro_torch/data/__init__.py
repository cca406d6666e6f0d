"""Data pipeline: synthetic MNIST (rendered procedurally) and the host
batch iterator — numpy on the host, placed on the device by the caller.
"""

from repro_torch.data.mnist import synthetic_mnist  # noqa: F401
from repro_torch.data.loader import batch_iterator  # noqa: F401
