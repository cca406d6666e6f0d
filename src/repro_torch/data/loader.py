"""Host-side batch iteration: the port's copy of
``repro/data/loader.batch_iterator`` (pure numpy, byte-equal batch order
for every seed). Device placement is the caller's job; the JAX
package's ``ShardedLoader``/``Prefetcher`` are not yet ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def batch_iterator(x: np.ndarray, y: np.ndarray, *, batch: int, seed: int = 0,
                   shuffle: bool = True) -> Iterator[dict[str, np.ndarray]]:
    """Epoch-cycling minibatch iterator over an in-memory dataset.

    Tail batches are wrapped (epoch boundary crossing) so every batch has
    the exact global batch size.
    """
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    order = np.arange(n)
    pos = 0
    while True:
        if shuffle and pos == 0:
            rng.shuffle(order)
        idx = order[pos:pos + batch]
        pos += batch
        if len(idx) < batch:
            shortfall = batch - len(idx)
            if shuffle:
                rng.shuffle(order)
            idx = np.concatenate([idx, order[:shortfall]])
            pos = shortfall
        if pos >= n:
            pos = 0
        yield {"x": x[idx], "y": y[idx]}
