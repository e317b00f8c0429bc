"""Distributed traversers: the paper's *MPI traverser* on ``torch.distributed``.

An MPI traverser (paper §4.1) is a regular traverser with one dimension — the
*ranking dimension* — bound to the MPI rank.  Here the communicator is a
:class:`Mesh`: a row-major grid of named axes laid over the processes of the
``torch.distributed`` world, one process per rank (real SPMD: every process
runs the same program and holds only its own tiles).  A ranking dimension
binds to one or more mesh axes, and its extent is deduced from the mesh if
left open (the paper's "set automatically to the communicator size").

Sub-communicators (``MPI_Comm_split``) are ``torch.distributed`` process
groups.  ``new_group`` is collective over the whole world, so every group a
traverser can use is created eagerly, on every rank and in one fixed order,
when the traverser is built; collectives only look groups up.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from .dims import LayoutError, mixed_radix_join, mixed_radix_split, prod
from .traverser import Traverser, set_length

__all__ = [
    "Mesh",
    "make_mesh",
    "init_world",
    "init_fake_world",
    "is_fake_world",
    "resolve_device",
    "DistTraverser",
    "mpi_traverser",
    "mpi_cart_traverser",
]

MeshAxes = tuple[str, ...]


def _as_axes(a) -> MeshAxes:
    if isinstance(a, str):
        return (a,)
    return tuple(a)


def is_fake_world() -> bool:
    """Whether this process runs a world of ``torch.distributed``'s ``fake``
    backend (:func:`init_fake_world`)."""
    return dist.is_initialized() and str(dist.get_backend()) == "fake"


def resolve_device(device: torch.device | str) -> torch.device:
    """The concrete device for ``device``; raises when CUDA is asked for and
    no GPU is present (entry points never fall back to the CPU silently).
    In a fake world (:func:`init_fake_world`) ``cuda`` is ``cuda:0`` with
    or without a GPU: its tensors are fake, nothing touches a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and is_fake_world():
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def _check_one_gpu_per_rank() -> None:
    if is_fake_world():
        return  # one process plays every rank, on fake tensors
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()
                                     if dist.is_initialized() else 1))
    if local_world > torch.cuda.device_count():
        raise RuntimeError(
            f"{local_world} ranks on this host but {torch.cuda.device_count()} GPU(s): "
            "NCCL needs one GPU per rank (run more ranks with device='cpu' and gloo)"
        )


def init_world(device: torch.device | str) -> torch.device:
    """Join the ``torch.distributed`` world for ``device`` and return the
    device this process computes on.

    Under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment) the env
    rendezvous is used; otherwise a world of size 1 is started in-process.
    The backend is NCCL for ``cuda`` and gloo for ``cpu``.  An already
    initialised world is kept, after checking its backend fits ``device``.
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if backend not in str(dist.get_backend()):
            raise RuntimeError(
                f"torch.distributed runs backend {dist.get_backend()!r}; "
                f"device {dev.type!r} needs {backend!r}"
            )
        if dev.type == "cuda":
            _check_one_gpu_per_rank()
        return dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            _check_one_gpu_per_rank()
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://")
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def init_fake_world(world_size: int, rank: int = 0,
                    device: torch.device | str = "cuda") -> torch.device:
    """Start a world of ``world_size`` ranks of ``torch.distributed``'s
    ``fake`` backend in this one process, playing rank ``rank``, and return
    the device its tensors name (``cuda:0`` for ``cuda``, with or without a
    GPU).  Every collective of a fake world returns at once and moves no
    data: it is for tracing one rank's program (under ``FakeTensorMode``,
    :mod:`repro_torch.launch.dryrun`), and values computed in it mean
    nothing.  Groups, meshes and every collective of the comm layer work
    on it as on a real world; :func:`init_world` refuses it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("init_fake_world: a torch.distributed world is already running")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    return resolve_device(device)


class Mesh:
    """A named row-major grid over the processes of the ``torch.distributed``
    world (the communicator of the paper's MPI traverser).

    ``shape`` maps axis names to sizes, outermost first; process ``rank``
    sits at the row-major coordinates of its rank.  ``device`` is where this
    process keeps its tiles.  The mesh owns the process groups of its
    sub-communicators (:meth:`create_groups`).
    """

    def __init__(self, shape: Mapping[str, int], rank: int, device: torch.device):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.device = device
        self._groups: dict[MeshAxes, Any] = {}

    def coords(self) -> dict[str, int]:
        """This process's row-major grid coordinates."""
        return dict(zip(self.axis_names, mixed_radix_split(self.rank, list(self.shape.values()))))

    def members(self, axes: Sequence[str]) -> tuple[int, ...]:
        """Global ranks of this process's communicator over ``axes`` (the
        other axes fixed at this process's coordinates), row-major over
        ``axes`` in the order given — the communicator-rank order."""
        mine = self.coords()
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(mine)
            c.update(zip(axes, combo))
            out.append(mixed_radix_join([c[a] for a in self.axis_names], list(self.shape.values())))
        return tuple(out)

    def _key(self, axes: Sequence[str]) -> MeshAxes:
        for ax in axes:
            if ax not in self.shape:
                raise LayoutError(f"mesh has no axis {ax!r} (has {self.axis_names})")
        return tuple(a for a in self.axis_names if a in axes)

    def create_groups(self, axes: Sequence[str]) -> None:
        """Create the process groups of every communicator over ``axes``
        (one per coordinate of the other axes).  Collective over the world:
        every rank must call it with the same axes in the same order."""
        key = self._key(axes)
        if key in self._groups:
            return
        if prod(self.shape[a] for a in key) == 1 or len(key) == len(self.axis_names):
            self._groups[key] = None  # a single process, or the whole world
            return
        others = [a for a in self.axis_names if a not in key]
        sizes = list(self.shape.values())
        mine = None
        for combo in itertools.product(*(range(self.shape[a]) for a in others)):
            ranks = []
            for sub in itertools.product(*(range(self.shape[a]) for a in key)):
                c = dict(zip(others, combo))
                c.update(zip(key, sub))
                ranks.append(mixed_radix_join([c[a] for a in self.axis_names], sizes))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        self._groups[key] = mine

    def group(self, axes: Sequence[str]):
        """The process group of this process's communicator over ``axes``
        (``None`` for the default world group or a single process)."""
        key = self._key(axes)
        if key not in self._groups:
            raise LayoutError(
                f"no process group over mesh axes {key}; build the traverser with "
                "mpi_traverser/mpi_cart_traverser, which create them on every rank"
            )
        return self._groups[key]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device: torch.device | str | None = None) -> Mesh:
    """A :class:`Mesh` of shape ``axis_shapes`` over the initialised world.

    The world size must equal the product of the shape; ranks are row-major
    over the grid.  ``device`` defaults to this process's current CUDA
    device under NCCL and to the CPU under gloo.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world (see init_world)")
    shape = dict(zip(axis_names, (int(s) for s in axis_shapes)))
    if len(shape) != len(tuple(axis_shapes)):
        raise LayoutError(f"make_mesh: axis names {tuple(axis_names)} do not match shape {tuple(axis_shapes)}")
    world = dist.get_world_size()
    if prod(shape.values()) != world:
        raise LayoutError(
            f"make_mesh: grid {tuple(axis_shapes)} holds {prod(shape.values())} ranks "
            f"but the world has {world}"
        )
    if device is None and is_fake_world():
        device = "cpu"
    if device is None:
        nccl = "nccl" in str(dist.get_backend())
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        _check_one_gpu_per_rank()
    return Mesh(shape, dist.get_rank(), device)


@dataclasses.dataclass(frozen=True)
class DistTraverser:
    """Traverser + mesh + {rank dim -> mesh axes} bindings."""

    trav: Traverser
    mesh: Mesh
    bindings: tuple[tuple[str, MeshAxes], ...]  # rank dim -> mesh axes (ordered)

    # -- communicator-like queries ------------------------------------------------
    def comm_size(self, dim: str | None = None) -> int:
        if dim is None:
            return prod(self.mesh_axis_size(ax) for _, axs in self.bindings for ax in axs)
        axs = dict(self.bindings)[dim]
        return prod(self.mesh_axis_size(ax) for ax in axs)

    def mesh_axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    @property
    def rank_dims(self) -> tuple[str, ...]:
        return tuple(d for d, _ in self.bindings)

    def rank_mesh_axes(self, dim: str) -> MeshAxes:
        return dict(self.bindings)[dim]

    def coord(self, dim: str) -> int:
        """This process's coordinate along rank dim ``dim`` (``MPI_Cart_coords``)."""
        mine = self.mesh.coords()
        axs = self.rank_mesh_axes(dim)
        return mixed_radix_join([mine[a] for a in axs], [self.mesh.shape[a] for a in axs])

    def communicator(self, rank_dims: Sequence[str]) -> tuple[Any, tuple[int, ...]]:
        """``(process group, member global ranks)`` of this process's
        communicator over ``rank_dims``; members are listed in communicator
        rank order (row-major over the rank dims).  The order must agree with
        the process group's own rank order, so the bound mesh axes must
        follow the mesh's axis order."""
        axes: MeshAxes = ()
        for d in rank_dims:
            axes += self.rank_mesh_axes(d)
        members = self.mesh.members(axes)
        if list(members) != sorted(members):
            raise LayoutError(
                f"rank dims {tuple(rank_dims)} bind mesh axes {axes} out of mesh order "
                f"{self.mesh.axis_names}; bind them in mesh order"
            )
        return self.mesh.group(axes), members

    # -- traverser passthrough ------------------------------------------------------
    def index_space(self) -> dict[str, int]:
        return self.trav.index_space()

    @property
    def order(self) -> tuple[str, ...]:
        return self.trav.order

    def __xor__(self, transform) -> "DistTraverser":
        return dataclasses.replace(self, trav=self.trav ^ transform)

    def __or__(self, fn) -> None:
        # Host-side reference iteration over the *full* space, including rank dims.
        return self.trav | fn

    # -- sub-communicators (MPI_Comm_split / MPI_Cart_sub analogue) -----------------
    def sub(self, *dims: str) -> "DistTraverser":
        """Restrict the communicator to the named ranking dims.

        The paper's ``MPI_Comm_split``: on a ``('rows', 'cols')`` grid,
        ``dt.sub('rows')`` is the column communicator family — one independent
        communicator per fixed ``cols`` coordinate, which is exactly how the
        collectives treat the dropped dims.
        """
        known = dict(self.bindings)
        missing = [d for d in dims if d not in known]
        if missing:
            raise LayoutError(f"sub{dims}: unknown rank dims {missing} (have {self.rank_dims})")
        if not dims:
            raise LayoutError("sub() needs at least one rank dim")
        return dataclasses.replace(
            self, bindings=tuple((d, axs) for d, axs in self.bindings if d in dims)
        )

    # -- rank decomposition -----------------------------------------------------------
    def rank_leaves(self, dim: str) -> tuple[tuple[str, int], ...]:
        """Leaf dims (with extents) composing the ranking dim ``dim``
        (non-trivial when the rank dim was ``merge_blocks``-ed from a grid)."""
        dec = self.trav._resolved_decomp()
        if dim in dec:
            return dec[dim]
        return ((dim, self.trav.dim_size(dim)),)  # type: ignore[return-value]

    def tile_space(self) -> dict[str, int]:
        """Index space per rank = full space minus rank-dim leaves."""
        space = self.index_space()
        for d in self.rank_dims:
            for leaf, _ in self.rank_leaves(d):
                space.pop(leaf, None)
            space.pop(d, None)
        return space


def _bind(trav: Traverser, rank_dim: str, mesh: Mesh, mesh_axes: MeshAxes) -> Traverser:
    for ax in mesh_axes:
        if ax not in mesh.shape:
            raise LayoutError(f"mesh has no axis {ax!r} (has {mesh.axis_names})")
    size = prod(mesh.shape[ax] for ax in mesh_axes)
    current = trav.dim_size(rank_dim)
    if current is None:
        return trav ^ set_length(rank_dim, size)
    if current != size:
        raise LayoutError(
            f"rank dim {rank_dim!r} has extent {current} but communicator "
            f"axes {mesh_axes} have size {size}"
        )
    return trav


def _create_all_groups(mesh: Mesh, bindings: Sequence[tuple[str, MeshAxes]]) -> None:
    # every union of bound axis groups, smallest first, in binding order:
    # the same sequence of new_group calls on every rank
    for n in range(1, len(bindings) + 1):
        for combo in itertools.combinations(bindings, n):
            mesh.create_groups([ax for _, axs in combo for ax in axs])


def mpi_traverser(
    rank_dim: str,
    trav: Traverser,
    mesh: Mesh,
    axes: Sequence[str] | str | None = None,
) -> DistTraverser:
    """Bind ``rank_dim`` of ``trav`` to the mesh (paper ``mpi_traverser<'r'>``).

    ``axes`` defaults to *all* mesh axes (the whole communicator).  The rank
    dim's extent must equal the product of the bound mesh axis sizes; if the
    extent is open it is deduced automatically.  Collective over the world
    (it creates the communicator's process groups).
    """
    mesh_axes = _as_axes(axes) if axes is not None else mesh.axis_names
    trav = _bind(trav, rank_dim, mesh, mesh_axes)
    dt = DistTraverser(trav=trav, mesh=mesh, bindings=((rank_dim, mesh_axes),))
    dt.trav._resolved_decomp()  # force early deduction errors (type safety)
    _create_all_groups(mesh, dt.bindings)
    return dt


def mpi_cart_traverser(
    bindings: Sequence[tuple[str, Sequence[str] | str]] | Mapping[str, Sequence[str] | str],
    trav: Traverser,
    mesh: Mesh,
) -> DistTraverser:
    """Bind several rank dims to disjoint mesh-axis groups — the paper's
    ``MPI_Cart_create``: a communicator grid, e.g. ``[('Ri', 'rows'),
    ('Cj', 'cols')]`` on a 2-D mesh.

    Each rank dim's extent must equal (or, if open, is deduced as) the product
    of its mesh axes.  Collectives then operate along one grid dim at a time;
    the process groups of every row, column and their unions are created
    here, eagerly, on every rank in one fixed order (collective over the
    world).
    """
    items = list(bindings.items()) if isinstance(bindings, Mapping) else list(bindings)
    if not items:
        raise LayoutError("mpi_cart_traverser needs at least one (rank dim, mesh axes) binding")
    used: set[str] = set()
    norm: list[tuple[str, MeshAxes]] = []
    for rank_dim, axes in items:
        mesh_axes = _as_axes(axes)
        for ax in mesh_axes:
            if ax in used:
                raise LayoutError(f"mesh axis {ax!r} bound to two rank dims")
            used.add(ax)
        trav = _bind(trav, rank_dim, mesh, mesh_axes)
        norm.append((rank_dim, mesh_axes))
    dt = DistTraverser(trav=trav, mesh=mesh, bindings=tuple(norm))
    dt.trav._resolved_decomp()  # force early deduction errors (type safety)
    _create_all_groups(mesh, dt.bindings)
    return dt
