"""The port's host loader (``repro_torch.data.loader``): ``Prefetcher``'s
order, exhaustion, error and close semantics (the reference's, case for
case), ``ShardedLoader`` on the CPU against the reference's loader on a
one-device mesh (values equal: both hand the host arrays over unchanged),
and training trajectories that are bit-identical with prefetch and
without. The CUDA path (pinned buffers, the side stream) is held in
``tests/test_torch_cuda.py``."""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.data import ShardedLoader as RefLoader
from repro_torch.configs import get_config
from repro_torch.core import lamb, lars
from repro_torch.data import (Prefetcher, ShardedLoader, TokenTaskConfig,
                              batch_iterator, synthetic_mnist, token_batches)
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JOIN_S = 10.0


def test_prefetcher_preserves_order_and_stops():
    pf = Prefetcher(iter(range(20)), transform=lambda x: x * x,
                    buffer_size=2)
    assert list(pf) == [x * x for x in range(20)]


def test_prefetcher_stays_exhausted():
    pf = Prefetcher(iter(range(3)))
    assert list(pf) == [0, 1, 2]
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(pf)


def test_prefetcher_propagates_source_errors():
    def bad():
        yield 1
        raise RuntimeError("boom")

    pf = Prefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_close_stops_an_infinite_source():
    pf = Prefetcher(itertools.count(), buffer_size=2)
    assert [next(pf) for _ in range(5)] == [0, 1, 2, 3, 4]
    pf.close()                          # must not hang
    pf._thread.join(timeout=JOIN_S)
    assert not pf._thread.is_alive()
    # drains what was buffered, then stops
    rest = list(pf)
    assert len(rest) <= 3 and rest == list(range(5, 5 + len(rest)))


def test_prefetcher_refuses_an_empty_buffer():
    with pytest.raises(ValueError, match="buffer_size"):
        Prefetcher(iter(()), buffer_size=0)


def _host_batches(n):
    for i in range(n):
        yield {"x": np.full((4, 2), i, np.float32),
               "tokens": np.arange(8, dtype=np.int32).reshape(2, 4) + i}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_sharded_loader_on_the_cpu_matches_the_reference(prefetch):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefLoader(_host_batches(3), mesh, P("data", None))
    want = list(ref)
    ref.close()
    loader = ShardedLoader(_host_batches(3), "cpu", prefetch=prefetch)
    got = list(loader)
    loader.close()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, v in a.items():
            assert v.device.type == "cpu"
            assert v.dtype == {np.float32: torch.float32,
                               np.int32: torch.int32}[b[k].dtype.type]
            assert np.array_equal(v.numpy(), np.asarray(b[k]))


def test_sharded_loader_close_ends_its_thread_mid_stream():
    loader = ShardedLoader(({"x": np.zeros(2, np.float32)}
                            for _ in itertools.count()), "cpu")
    next(loader)
    loader.close()
    thread = loader._it._thread
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive()


def test_sharded_loader_refuses_a_mesh():
    """Anything but a mesh is refused; on a one-rank 1x1 mesh (no process
    group) a batch comes back whole as a LocalBatch: this rank's rows
    are all of them (two ranks: tests/test_torch_zero.py)."""
    from repro_torch.distributed.sharding import LocalBatch
    from repro_torch.launch.mesh import mesh_from_spec
    with pytest.raises(TypeError, match="Mesh"):
        ShardedLoader(iter(()), "cpu", mesh=object())
    mesh = mesh_from_spec("1x1", device="cpu")
    host = [{"x": np.arange(8, dtype=np.float32).reshape(4, 2)}]
    loader = ShardedLoader(iter(host), "cpu", mesh=mesh)
    got = next(loader)
    loader.close()
    assert isinstance(got, LocalBatch) and got.global_rows == 4
    assert torch.equal(got["x"], torch.from_numpy(host[0]["x"]))


def _trajectory(pipe, host, prefetch, steps):
    loader = ShardedLoader(host, "cpu", prefetch=prefetch)
    state = pipe.init_state(torch.Generator().manual_seed(0), "cpu")
    losses = []
    try:
        for _ in range(steps):
            state, m = pipe(state, next(loader))
            losses.append(m["loss"])
    finally:
        loader.close()
    return [float(x) for x in losses], state


@pytest.mark.parametrize("family", ["cnn", "lm"])
def test_trajectory_is_bit_identical_with_and_without_prefetch(family):
    if family == "cnn":
        cfg = get_config("lenet-mnist")
        x, y, _, _ = synthetic_mnist(128, 8)
        host = lambda: batch_iterator(x, y, batch=32, seed=0)  # noqa: E731
        opt = lars(0.05)
    else:
        cfg = get_config("smollm-135m").reduced(max_layers=1)
        host = lambda: ({"tokens": t} for t in token_batches(  # noqa: E731
            TokenTaskConfig(vocab_size=cfg.vocab_size), batch=4,
            seq_len=16))
        opt = lamb(0.01)
    pipe = TrainPipeline(build_model(cfg), opt, cfg)
    a, sa = _trajectory(pipe, host(), 2, 3)
    b, sb = _trajectory(pipe, host(), 0, 3)
    assert a == b
    assert all(torch.equal(u, v) for u, v in zip(
        sa.opt_state.slots.values(), sb.opt_state.slots.values()))
