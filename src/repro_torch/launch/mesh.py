"""Device meshes over ``torch.distributed`` process groups (port of
``repro/launch/mesh.py``).

The reference's mesh is a grid of the devices of one JAX process. The
port's :class:`Mesh` is a grid of the RANKS of the default process group
that the caller initialised (``torchrun``, or a spawn helper that calls
``torch.distributed.init_process_group`` itself), one device each: the
axis names ``("data", "model")`` and their sizes, this rank's coordinate
on each axis, the process group of each axis and this rank's device.
Rank ``r`` sits at ``(r // model, r % model)``, the row-major order in
which ``jax.make_mesh`` lays out its devices. Where no process group is
initialised the process is one rank, so a ``1x1`` mesh (and ``auto``)
still works: every collective over it is the identity.

``torch.distributed.device_mesh.DeviceMesh`` is not used underneath: it
binds one device per rank and its NCCL groups refuse two ranks on one
card, which the one-card smoke run needs (gloo, see
:mod:`repro_torch.distributed.collectives`).

Like the reference, these are functions: importing this module touches
no device and no process group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import constrain

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``(data, model)`` grid of ranks.

    ``shape`` and ``axis_names`` are what the sharding rules read (as the
    reference's ``Mesh.shape`` / ``Mesh.axis_names``); ``groups`` holds
    the process group of each axis that has more than one rank (``None``
    for an axis of size 1, over which nothing is sent), and under
    ``("data", "model")`` the group of every rank of the mesh where both
    axes have more than one (a dim split over both: the serving mesh's
    context parallelism). ``with mesh:``
    makes it the ambient mesh that the packed substrate and the
    collectives find through :func:`repro_torch.distributed.constrain.
    current_mesh`, as ``with mesh:`` does in the reference.
    """

    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    axis_names: tuple = AXES

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    @property
    def rank(self) -> int:
        """This rank's index in the mesh (row-major over the axes)."""
        return self.coords["data"] * self.shape["model"] + \
            self.coords["model"]

    def group(self, axis):
        """The process group of ``axis``: an axis name, or a tuple of
        names (the group of the ranks that differ along those axes; where
        only one of them has more than one rank, its group)."""
        if isinstance(axis, tuple):
            wide = tuple(a for a in AXES if a in axis and self.shape[a] > 1)
            if len(wide) == 2:
                return self.groups.get(AXES)
            axis = wide[0] if wide else axis[0]
        return self.groups.get(axis)

    def __enter__(self) -> "Mesh":
        constrain.push_mesh(self)
        return self

    def __exit__(self, *exc) -> None:
        constrain.pop_mesh(self)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank {self.rank} at "
                f"{dict(self.coords)}, {self.device})")


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) where
    none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """A barrier over the default process group, where there is one."""
    if world()[1] > 1:
        dist.barrier()


def default_device() -> torch.device:
    """This rank's card: ``cuda:<LOCAL_RANK>`` (torchrun sets it; 0
    otherwise). Raises where CUDA is absent: a rank lands on the CPU only
    when the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "build a mesh of CPU ranks")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(data: int, model: int = 1, *,
              device: Optional[torch.device | str] = None) -> Mesh:
    """A ``(data, model)`` mesh over the leading ``data * model`` ranks of
    the default process group. Every rank must call it (the process
    groups of the axes are created collectively); a rank past the mesh
    gets ``None``."""
    rank, size = world()
    n = data * model
    if data < 1 or model < 1 or n > size:
        raise ValueError(f"mesh {data}x{model} needs {n} ranks, have {size}")
    device = torch.device(device) if device is not None \
        else default_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mine: dict = {}
    if dist.is_available() and dist.is_initialized():
        # new_group is collective over the default group: every rank makes
        # every group, in the same order, member or not. An axis of one
        # rank has no group, unless it is the whole process group (a
        # one-rank torchrun): its collectives then still go through the
        # backend
        for axis, lines in (
                ("data", [[d * model + m for d in range(data)]
                          for m in range(model)]),
                ("model", [[d * model + m for m in range(model)]
                           for d in range(data)])):
            for ranks in lines:
                if len(ranks) == size:
                    g = dist.group.WORLD
                elif len(ranks) == 1:
                    continue
                else:
                    g = dist.new_group(ranks)
                if rank in ranks:
                    mine[axis] = g
        if data > 1 and model > 1:
            mine[AXES] = dist.group.WORLD if n == size else \
                dist.new_group(list(range(n)))
    if rank >= n:
        return None
    groups = {a: mine.get(a) for a in AXES}
    if AXES in mine:
        groups[AXES] = mine[AXES]
    return Mesh(shape={"data": data, "model": model},
                coords={"data": rank // model, "model": rank % model},
                groups=groups, device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device | str] = None
                         ) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks; the port's mesh has
    no ``pod`` axis, so ``multi_pod`` (the reference's (2, 16, 16)) is
    refused. When the process group has more ranks than the mesh needs,
    the mesh takes the leading ones."""
    if multi_pod:
        raise NotImplementedError(
            "the pod axis (multi_pod=True) is not yet ported to "
            "repro_torch: its meshes are (data, model)")
    shape = (16, 16)
    n = shape[0] * shape[1]
    _, size = world()
    if size < n:
        raise RuntimeError(
            f"need {n} devices for mesh {dict(zip(AXES, shape))}, have "
            f"{size} — run under dryrun.py (XLA host-device flag)")
    return make_mesh(*shape, device=device)


def make_host_mesh(*, model: int = 1,
                   device: Optional[torch.device | str] = None) -> Mesh:
    """Every rank of the process group: ``(world // model, model)``."""
    _, size = world()
    return make_mesh(size // model, model, device=device)


def mesh_from_spec(spec: str, *, allow_none: bool = False,
                   device: Optional[torch.device | str] = None
                   ) -> Optional[Mesh]:
    """Shared ``--mesh`` parsing (train + serve launchers), with the
    reference's messages.

    ``DATAxMODEL`` (e.g. ``4x1``) -> an explicit (data, model) mesh over
    the leading D*M ranks; ``auto`` -> every rank on the data axis;
    ``none`` -> None when ``allow_none``. ``device`` is this rank's
    device (default :func:`default_device`, which raises without CUDA).
    """
    if allow_none and spec == "none":
        return None
    return make_mesh(*parse_spec(spec, allow_none=allow_none),
                     device=device)


def parse_spec(spec: str, *, allow_none: bool = False) -> tuple[int, int]:
    """``--mesh`` -> (data, model) for the ranks of the process group,
    with the reference's messages for a bad spec and for a spec with too
    few ranks. Builds nothing."""
    _, size = world()
    if spec == "auto":
        return size, 1
    try:
        data, model = (int(s) for s in spec.lower().split("x"))
    except ValueError:
        choices = "'auto'" + (", 'none'" if allow_none else "")
        raise SystemExit(f"--mesh expects {choices} or DATAxMODEL, "
                         f"got {spec!r}")
    if data * model > size:
        raise SystemExit(f"--mesh {spec} needs {data * model} devices, "
                         f"have {size}")
    return data, model


def init_distributed(device: torch.device | str, *,
                     backend: Optional[str] = None) -> torch.device:
    """Join the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``; a
    one-rank torchrun too) when none is initialised yet. The backend is
    NCCL for a CUDA device and gloo for the CPU unless ``backend`` is
    given. Returns this rank's device: ``cuda:<LOCAL_RANK>`` for a bare
    ``cuda``, the device as given otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         "0")))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method="env://")
    return device
