"""The port's data pipeline and configs against the JAX package's: the
procedural MNIST and the batch order are byte-equal (tolerance: none —
both are the same numpy code on the same seeds)."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import batch_iterator as ref_batch_iterator
from repro.data import synthetic_mnist as ref_synthetic_mnist
from repro_torch.configs import get_config
from repro_torch.data import batch_iterator, synthetic_mnist


def test_synthetic_mnist_is_byte_equal():
    got = synthetic_mnist(64, 16, seed=0)
    want = ref_synthetic_mnist(64, 16, seed=0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("batch,shuffle", [(24, True), (64, True),
                                           (10, False)])
def test_batch_iterator_order_is_byte_equal(batch, shuffle):
    x, y, _, _ = ref_synthetic_mnist(40, 1, seed=3)
    got = batch_iterator(x, y, batch=batch, seed=5, shuffle=shuffle)
    want = ref_batch_iterator(x, y, batch=batch, seed=5, shuffle=shuffle)
    for _ in range(7):      # crosses several epoch wraps
        a, b = next(got), next(want)
        assert a["x"].tobytes() == b["x"].tobytes()
        assert a["y"].tobytes() == b["y"].tobytes()


def test_lenet_config_matches_reference():
    got = dataclasses.asdict(get_config("lenet-mnist"))
    want = dataclasses.asdict(ref_get_config("lenet-mnist"))
    assert got == want


def test_other_archs_are_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("smollm-135m")
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")
