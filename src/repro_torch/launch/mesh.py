"""Meshes: the production fleet's shape, small test meshes, and the process
groups a mesh's axes span.

A live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` name its axes (``("data", "model")`` or ``("pod",
"data", "model")``). Every rank of the world runs the same program (SPMD),
and each collective names the group it runs over (:func:`axes_group`).
:class:`AbstractMesh` is a mesh's shape alone, axis names to sizes with no
process group: the placement rules (``launch/sharding.py``) and the cell
plans (``launch/steps.py::plan_cell``) take either, so a 16x16 or 2x16x16
fleet is planned inside one process.

The process-group backend is chosen by the caller, never quietly: ``nccl``
for a mesh on the card, ``gloo`` for a mesh on the CPU or where the caller
names it (several ranks sharing one card, whose collectives NCCL refuses).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names with no process group behind them (the
    port's ``jax.sharding.AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    if not mesh.mesh_dim_names:
        raise ValueError("a DeviceMesh of the port names its axes "
                         "(mesh_dim_names)")
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, of an :class:`AbstractMesh` or a DeviceMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (data parallel): ('pod','data') or ('data',)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, *names: str) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[n] for n in names if n in shape)


def production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The fleet's shape: 16x16 = 256 chips a pod; ``multi_pod`` adds a
    leading pod axis of 2."""
    return AbstractMesh(*PRODUCTION_SHAPES[multi_pod])


# ---------------------------------------------------------------------------
# live meshes
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost (for a world's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(backend: Optional[str] = None, *, rank: int = 0,
               world_size: int = 1, init_method: Optional[str] = None,
               device: DeviceLike = None) -> str:
    """Start this process's default process group and return its backend.
    ``backend=None`` follows ``device`` (the device rule: None is the card):
    ``nccl`` on the card, ``gloo`` on the CPU; pass ``"gloo"`` to run a
    card's collectives through gloo (several ranks on one card). A world of
    one may omit ``init_method`` (a free port on localhost); a larger world
    names the address every rank meets at (``tcp://localhost:<port>``)."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl runs collectives of CUDA tensors: pass a "
                         "CUDA device, or name backend='gloo'")
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs the "
                             "init_method every rank meets at")
        init_method = f"tcp://localhost:{free_port()}"
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev           # create the communicator now
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return backend


def make_test_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: DeviceLike = None,
                   backend: Optional[str] = None):
    """A DeviceMesh of ``shape`` over the whole world, its tensors on
    ``device`` (None: the card). A world of one is started here when none
    is (:func:`init_world`, ``backend`` as it takes it); a larger world is
    started by the caller, one process a rank, and must hold exactly
    ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {shape} mesh needs a world of {n} ranks "
                               "started by the caller (init_world)")
        init_world(backend, device=dev)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh over a world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The fleet's DeviceMesh (:func:`production_mesh`'s shape); raises
    unless the world holds 256 ranks (512 with ``multi_pod``). Plan a cell
    for the fleet from a smaller world with :func:`production_mesh`."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{n} ranks, this one has {have}")
    return make_test_mesh(shape, axes, device=device)


def is_live(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, AbstractMesh)


def _live(mesh):
    if not is_live(mesh):
        raise ValueError("this needs a live mesh (a DeviceMesh), not "
                         f"{mesh!r}")
    return mesh


def coordinate(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """Axis name -> coordinate of global ``rank`` (default: this rank)."""
    mesh = _live(mesh)
    if rank is None or rank == dist.get_rank():
        # this rank's, kept by the mesh: no tensor operation (a decode step
        # asks it in every layer)
        return dict(zip(axis_names(mesh), mesh.get_coordinate()))
    hit = (mesh.mesh == rank).nonzero()
    if hit.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(axis_names(mesh), (int(c) for c in hit[0])))


def shard_index(mesh, axes: Sequence[str],
                rank: Optional[int] = None) -> int:
    """This rank's (or ``rank``'s) shard of a dim split over ``axes``: its
    coordinates on them as one index, the first axis the slowest (as
    ``lax.axis_index`` over several axes)."""
    coord, shape = coordinate(mesh, rank), mesh_shape(mesh)
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[a]
    return idx


def is_writer(mesh) -> bool:
    """Whether this rank is the mesh's first (every coordinate 0): the one
    rank that writes what the whole mesh computed."""
    return not is_live(mesh) or not any(coordinate(mesh).values())


def world_of(mesh) -> int:
    """Ranks in the mesh (1 for no mesh)."""
    return mesh.size() if is_live(mesh) else 1


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank's fellows along ``axes`` (the ranks
    that differ from it on those axes only): ``mesh.get_group(axis)`` for
    one axis, else a group flattened over them, made at the first call for
    every combination of the other axes (every rank of the mesh must make
    that first call, in the same order, as ``new_group`` requires)."""
    mesh = _live(mesh)
    axes = tuple(axes)
    names = axis_names(mesh)
    if not axes or any(a not in names for a in axes):
        raise ValueError(f"axes {axes} not all in the mesh's {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # the mesh keeps its flattened groups: one a set of axes, made once
    groups = mesh.__dict__.setdefault("_flattened_groups", {})
    key = tuple(sorted(axes))
    if key not in groups:
        dims = [names.index(a) for a in names if a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        grid = mesh.mesh
        mine = None
        for others in itertools.product(*(range(grid.shape[d])
                                          for d in rest)):
            index = [slice(None)] * grid.ndim
            for d, c in zip(rest, others):
                index[d] = c
            ranks = sorted(int(r) for r in grid[tuple(index)].flatten())
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        groups[key] = mine
    return groups[key]


def mesh_group(mesh):
    """The group of every rank of the mesh."""
    return axes_group(mesh, axis_names(mesh))


def collective_device(group) -> torch.device:
    """Where a collective's tensors go for ``group``: the card for an
    ``nccl`` group, the host for a ``gloo`` group (gloo gathers host
    tensors; of CUDA tensors it reduces and broadcasts only)."""
    if "nccl" in str(dist.get_backend(group)):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def capturable(mesh) -> bool:
    """Whether the mesh's collectives can be captured in a CUDA graph: those
    of ``nccl`` can, those of ``gloo`` run on the host."""
    return not is_live(mesh) or "nccl" in str(
        dist.get_backend(mesh_group(mesh)))


def all_agree(flags: Sequence[bool], mesh) -> list:
    """Each flag true only where it is true on every rank of the mesh (one
    all-reduce); so that every rank takes the same branch."""
    if world_of(mesh) == 1 or not flags:
        return [bool(f) for f in flags]
    group = mesh_group(mesh)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return [bool(v) for v in t.tolist()]


def barrier(mesh) -> None:
    """Every rank of the mesh waits for the others."""
    if world_of(mesh) > 1:
        group = mesh_group(mesh)
        t = torch.zeros(1, device=collective_device(group))
        dist.all_reduce(t, group=group)


def all_gather_shards(t: torch.Tensor, mesh,
                      axes: Sequence[str]) -> torch.Tensor:
    """The whole of a dim-0 split over ``axes``: every rank passes its shard
    ``t`` (rank-local, all the same shape), and gets the shards concatenated
    in shard order (:func:`shard_index`), on ``t``'s device. The ranks that
    hold the same shard (they differ on the other axes) give equal shards.
    Gathers raw bytes, so any dtype crosses; through a ``gloo`` group the
    bytes go by the host."""
    if world_of(mesh) == 1:
        return t
    n, rest = t.shape[0], tuple(t.shape[1:])
    extent = axis_size(mesh, *axes)
    if not math.prod(rest):                 # every rank's shard is empty
        return t.new_empty((n * extent,) + rest)
    group = mesh_group(mesh)
    raw = t.contiguous().reshape(n, -1).view(torch.uint8).to(
        collective_device(group))
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    by_shard = {}
    for r, part in zip(dist.get_process_group_ranks(group), parts):
        by_shard.setdefault(shard_index(mesh, axes, r), part)
    whole = torch.cat([by_shard[i] for i in range(extent)]).to(t.device)
    return whole.view(t.dtype).reshape((n * extent,) + rest)
