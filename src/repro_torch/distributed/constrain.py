"""Activation sharding constraints and the ambient mesh (port of
``repro/distributed/constrain.py``).

The reference pins activations to the batch axes at a few load-bearing
points so that GSPMD cannot resolve a sharding ambiguity by gathering
the batch. The port has no GSPMD: on a data-parallel mesh each rank
already holds only its own rows of the batch (``ShardedLoader(mesh=)``
or ``TrainPipeline`` cut them before the forward), every activation it
computes is of those rows, and nothing is ever gathered behind its back.
So :func:`shard_batch` and :func:`shard_spec` are the identity on the
tensors, with a mesh and without one, and the models may call them as
the reference's do.

On a mesh whose ``model`` axis has more than one rank (tensor
parallelism, the dense family) the port's model code does explicitly
what these constraints ask of GSPMD: ``shard_batch(logits,
last="model")`` in the reference's ``LanguageModel.logits`` means the
logits stay split over the vocabulary, and in the port they do — a
rank's logits ARE its block of the vocabulary (``LanguageModel.logits``
under a split unembedding), the loss is vocab-parallel
(:func:`repro_torch.train.losses.vocab_parallel_nll`) and evaluation
all-gathers them. The activations between the blocks are replicated
over ``model`` (each block ends in ``reduce_from_model``), which is what
the reference's ``shard_batch`` on the embedding's output pins.

The ambient mesh is the one entered last with ``with mesh:`` on this
thread (:meth:`repro_torch.launch.mesh.Mesh.__enter__`), as the
reference reads the legacy ``with mesh:`` context.

Beside it, :func:`rows_over_data` says that the batch of the forward
passes run in its block is this rank's block of the rows of a global
batch split over a mesh's ``data`` axis (``TrainPipeline`` enters it
where it cuts the batch): what the MoE block needs to route every token
as the global batch's (:mod:`repro_torch.models.moe`). GSPMD knows it
from the batch's sharding; the port's ranks hold only their rows.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

_LOCAL = threading.local()


def _stack() -> list:
    if not hasattr(_LOCAL, "meshes"):
        _LOCAL.meshes = []
    return _LOCAL.meshes


def push_mesh(mesh) -> None:
    _stack().append(mesh)


def pop_mesh(mesh) -> None:
    stack = _stack()
    if not stack or stack[-1] is not mesh:
        raise RuntimeError("mesh contexts must be left in the order they "
                           "were entered")
    stack.pop()


def current_mesh() -> Optional[object]:
    """The ambient mesh, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def rows_over_data(mesh):
    """Within the block, on this thread, the forward's batch rows are
    this rank's block of ``mesh``'s ``data`` axis (``mesh`` None: the
    whole batch)."""
    stack = _LOCAL.__dict__.setdefault("rows", [])
    stack.append(mesh)
    try:
        yield
    finally:
        stack.pop()


def data_rows() -> Optional[object]:
    """The mesh whose ``data`` axis splits the batch rows of the forward
    being run (:func:`rows_over_data`), or None where they are whole."""
    stack = _LOCAL.__dict__.get("rows")
    return stack[-1] if stack else None


def shard_batch(x, *, last: Optional[str] = None):
    """The reference constrains dim 0 to the batch axes (and dim -1 to
    ``last``); on the port's meshes ``x`` already holds this rank's rows
    (and, for ``last="model"``, its vocab block), so it is returned as
    it is."""
    del last
    return x


def shard_spec(x, *axes):
    """The reference constrains ``x`` to an explicit per-dim axis tuple;
    on the port's meshes every such constraint is already met by the
    model code (rows are this rank's; a split over ``model`` is made
    where the block computes it)."""
    del axes
    return x
