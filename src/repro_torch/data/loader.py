"""Host loader of the port: the epoch-cycling ``batch_iterator`` (a copy
of ``repro/data/loader.batch_iterator``, byte-equal batch order for
every seed), the background ``Prefetcher``, and ``ShardedLoader``, the
one-device counterpart of the reference's mesh-placing loader.

``ShardedLoader(it, device)`` runs the host iterator and the device
placement ``prefetch`` batches ahead of the consumer on a daemon thread,
so the host never sits on the device's critical path: while step ``i``
executes, batch ``i+1`` is already on its way to the card. On a CUDA
device each batch goes through pinned host memory and a ``non_blocking``
copy on a side stream; the consumer's stream waits on an event recorded
after the copy, and the device tensors are marked as used on the
consumer's stream (``record_stream``). A pinned buffer is kept alive
until its copy's event has completed. On the CPU a batch is a plain
``torch.from_numpy``.

``ShardedLoader(it, device, mesh=mesh, spec=specs)`` is the reference's
mesh placement on a data-parallel mesh: every rank runs the same host
iterator (the global batch, from the same seed), keeps its own rows of
each batch as ``spec`` — ``pipe.batch_specs(B)``, i.e. ``batch_pspecs``
— cuts them (all rows where the batch is replicated), and copies only
those to its device, yielding a
:class:`~repro_torch.distributed.sharding.LocalBatch`. Prefetch and the
copy ring are the same.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


class Prefetcher:
    """Run an iterator (plus an optional transform, e.g. device
    placement) on a daemon thread, ``buffer_size`` items ahead.

    The queue bound is the buffering depth: the thread blocks on ``put``
    once it is that far ahead, so host memory stays bounded. Exceptions
    in the source iterator are re-raised at the consuming ``next()``
    call; an exhausted source raises ``StopIteration`` as usual. The
    thread is a daemon, so abandoning the iterator mid-stream (infinite
    epoch-cycling sources) cannot hang interpreter exit.
    """

    _DONE = object()

    def __init__(self, it: Iterator[Any],
                 transform: Optional[Callable[[Any], Any]] = None,
                 buffer_size: int = 2):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False

        def run():
            try:
                for item in it:
                    out = transform(item) if transform is not None else item
                    while not self._stop.is_set():
                        try:
                            self._q.put(out, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        break
            except BaseException as e:  # surfaced at the consumer's next()
                self._err = e
            # best effort: the consumer may already have stopped draining,
            # so never block here — __next__ also detects a dead producer
            try:
                self._q.put_nowait(self._DONE)
            except queue.Full:
                pass

        self._thread = threading.Thread(
            target=run, name="repro-torch-prefetch", daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:          # iterator protocol: stay exhausted
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # the producer exited; it may have enqueued its last
                    # items (and the sentinel) between the timeout and
                    # the liveness check — drain before concluding
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        item = self._DONE
                    break
        if item is self._DONE:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer thread; subsequent ``next()`` drains what is
        already buffered, then raises ``StopIteration``. Joins briefly so
        an in-flight placement finishes before interpreter teardown."""
        self._stop.set()
        self._thread.join(timeout=10.0)


def place(batch: dict, device: torch.device | str) -> dict:
    """Host numpy batch -> tensors on ``device``: ``torch.from_numpy`` on
    the CPU, a blocking copy to a CUDA device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class _CudaCopier:
    """Placement of host batches on one CUDA device through pinned
    memory and a side stream. Returns ``(device batch, event, pinned
    buffers)``; the consumer waits on the event before using the batch
    and keeps the pinned buffers until the event has completed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch: dict):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            out = {k: p.to(self.device, non_blocking=True)
                   for k, p in pinned.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event, pinned


class ShardedLoader:
    """Wrap a host iterator of numpy batch dicts and yield them as
    tensors on ``device``, placed ``prefetch`` batches ahead (0: placed
    in the consumer's thread at ``next()``, with the same copies).

    ``mesh``: a data-parallel :class:`~repro_torch.launch.mesh.Mesh`;
    each batch is cut to this rank's rows per ``spec`` (a dict of
    ``PartitionSpec`` by key, default: dim 0 over ``data`` where it
    divides), as this rank's block of each of ``blocks`` equal row
    blocks (``TrainPipeline.row_blocks``: the moe family's microbatches;
    ``shard_rows``), and yielded as a ``LocalBatch``. Call :meth:`close`
    when done: it stops the thread and waits for every copy still in
    flight.
    """

    def __init__(self, it: Iterator[dict], device: torch.device | str, *,
                 mesh=None, spec: Optional[dict] = None,
                 prefetch: int = 2, blocks: int = 1):
        self.device = torch.device(device)
        self._copier = (_CudaCopier(self.device)
                        if self.device.type == "cuda" else None)
        place_fn = self._copier or (lambda b: place(b, self.device))
        self.mesh, self.spec, self.blocks = mesh, spec, blocks
        if mesh is not None:
            if not all(hasattr(mesh, a) for a in ("shape", "coords")):
                raise TypeError(f"mesh must be a repro_torch.launch.mesh."
                                f"Mesh, got {type(mesh).__name__}")
            inner = place_fn
            place_fn = lambda b: self._place_rows(b, inner)  # noqa: E731
        if prefetch:
            self._it: Iterator[Any] = Prefetcher(
                iter(it), transform=place_fn, buffer_size=prefetch)
        else:
            self._it = (place_fn(b) for b in it)
        self._inflight: collections.deque = collections.deque()

    def _place_rows(self, batch: dict, inner):
        """This rank's rows of a host batch, placed by ``inner``."""
        from repro_torch.distributed.sharding import (P, LocalBatch,
                                                      shard_rows, tree_named)
        n = next(iter(batch.values())).shape[0]
        spec = self.spec
        if spec is None:
            split = ("data",) if n % self.mesh.shape["data"] == 0 else None
            spec = {k: P(split, *([None] * (np.ndim(v) - 1)))
                    for k, v in batch.items()}
        cut = shard_rows(batch, tree_named(self.mesh, spec), self.blocks)
        placed = inner(dict(cut))
        wrap = lambda b: LocalBatch(b, global_rows=cut.global_rows,  # noqa
                                    sharded=cut.sharded, blocks=cut.blocks)
        if self._copier is None:
            return wrap(placed)
        out, event, pinned = placed
        return wrap(out), event, pinned

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = next(self._it)
        if self._copier is None:
            return item
        batch, event, pinned = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in batch.values():
            t.record_stream(stream)
        self._inflight.append((event, pinned))
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        return batch

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
            if self._copier is not None:
                # batches placed but never consumed: their copies too
                for _, event, pinned in self._it:
                    self._inflight.append((event, pinned))
        for event, _ in self._inflight:
            event.synchronize()
        self._inflight.clear()


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
