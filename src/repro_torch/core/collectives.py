"""Layout-agnostic collective operations (paper §4.2) on ``torch.distributed``.

The signature of every operation takes *bags* (buffer + layout) and a
:class:`DistTraverser` — never a process group or an MPI datatype.  The
layout transformation required by differing endpoint layouts is derived
automatically (``relayout_plan``) and runs on the send side (pack) or the
receive side (unpack) of the ``torch.distributed`` call, which is the
analogue of MPI performing the transform inside the transfer.

The comm layer is real SPMD: every process runs the same program and a
:class:`DistBag` holds only this process's tile, next to the static facts
every rank agrees on (tile layout, grid, extents table).  Other ranks' tiles
are reached only by communicating (:func:`gather`, :func:`gatherv_bag`).

Index-space type checks (paper: "the index space of the distributed structure
has to be a subspace of the root structure index space, and the difference
has to be covered by the dimension bound to the communicator") happen before
any data moves and raise :class:`LayoutError`.

A :class:`DistBag` may be distributed over *several* ranking dimensions at
once (a communicator grid, e.g. ``('rows', 'cols')`` — the paper's
``MPI_Cart_create``).  Every collective then names the ranking dimension it
operates along; the remaining grid dimensions act as independent
sub-communicators, exactly like ``MPI_Comm_split`` keyed by the other grid
coordinates.  A communicator of one process moves no data through
``torch.distributed``: its collectives are local copies.

Non-blocking collectives
------------------------
``all_gather_start``, ``all_reduce_start``, ``reduce_scatter_start``,
``reduce_scatterv_start``, ``all_to_all_start``, ``all_gatherv_start`` and
``all_to_allv_start`` issue the operation with ``async_op=True`` and
return a :class:`repro_torch.core.request.Pending` immediately; compute
issued between start and :meth:`~repro_torch.core.request.Pending.wait`
overlaps the transfer.  The blocking collectives are literally
``*_start(...).wait()``.

Ragged distribution (the MPI v-collectives)
-------------------------------------------
MPI's answer to non-uniform buffers is the ``v`` family, whose
counts/displacements arrays describe a different extent per rank.  The
layout-agnostic analogue here is :attr:`DistBag.extents`: per-rank *valid*
sizes along tiled dims, carried next to a homogeneous **padded capacity**
tile layout.  Valid elements occupy the leading slice along each ragged dim;
the rest of the buffer is zero padding that rides the wire but never enters
logical results (``tile()`` returns the valid view).  ``extents[r][dim]`` is
rank ``r``'s *count* along ``dim``; the displacement of rank ``r`` is the
prefix sum of the preceding ranks' extents along the rank dim that owns
``dim`` (:func:`repro_torch.core.dims.ragged_split` builds balanced tables).

=======================  ====================================================
MPI                      repro_torch.core
=======================  ====================================================
``MPI_Scatter``          :func:`scatter` (root = communicator rank 0)
``MPI_Allgather``        :func:`all_gather_bag` / :func:`all_gather_dist` /
                         ``_start`` (a receive layout per rank);
                         :func:`gather` (the root bag on every rank)
``MPI_Allreduce``        :func:`all_reduce_bag` / ``_start``
``MPI_Bcast``            :func:`broadcast`
``MPI_Reduce_scatter``   :func:`reduce_scatter_bag` / ``_start``
``MPI_Scatterv``         :func:`scatterv_bag` (extents = counts)
``MPI_Gatherv``          :func:`gatherv_bag`
``Reduce_scatter`` (v)   :func:`reduce_scatterv_bag` / ``_start``
``MPI_Alltoall``         :func:`all_to_all_bag` / ``_start`` (the reshard)
``MPI_Allgatherv``       :func:`all_gatherv_bag` / ``_dist`` / ``_start``
``MPI_Alltoallv``        :func:`all_to_allv_bag` / ``_start`` (split sizes =
                         the counts table; zero counts allowed)
=======================  ====================================================

Shard-level v-collectives
-------------------------
The ZeRO train step (:mod:`repro_torch.train.trainer`) moves plain flat
gradient and parameter buffers, not bags: :func:`shard_reduce_scatterv_start`
(``MPI_Ireduce_scatter`` of a ``(R * cap,)`` buffer with a ``recvcounts``
table) and :func:`shard_all_gatherv_start` (``MPI_Iallgatherv`` of ``(cap,)``
capacity shards) take a tensor or a tuple of them and one named mesh axis,
like the shard-level forms of :mod:`repro_torch.core.p2p`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .bag import Bag
from .dims import LayoutError, check_same_space, prod
from .dist import DistTraverser
from .layout import Axis, Layout, torch_dtype
from .relayout import check_ragged_dims, relayout
from .request import Pending, wait_all

__all__ = [
    "DistBag",
    "Pending",
    "wait_all",
    "scatter",
    "gather",
    "broadcast",
    "all_gather_start",
    "all_gather_dist",
    "all_gather_bag",
    "all_reduce_start",
    "all_reduce_bag",
    "reduce_scatter_bag",
    "reduce_scatter_start",
    "grid_extents",
    "scatterv_bag",
    "gatherv_bag",
    "reduce_scatterv_bag",
    "reduce_scatterv_start",
    "all_to_all_start",
    "all_to_all_bag",
    "all_gatherv_start",
    "all_gatherv_dist",
    "all_gatherv_bag",
    "all_to_allv_start",
    "all_to_allv_bag",
    "all_to_allv_tie",
    "all_reduce_tie",
    "reduce_identity",
    "dist_full",
    "rank_map",
    "shard_reduce_scatterv_start",
    "shard_all_gatherv_start",
]

_REDUCERS = {
    "add": dist.ReduceOp.SUM,
    "mean": dist.ReduceOp.SUM,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


def _resolve_reduce(op: str):
    if op not in _REDUCERS:
        raise LayoutError(f"unknown reduce op {op!r} (have {sorted(_REDUCERS)})")
    return _REDUCERS[op]


def reduce_identity(op: str, dtype):
    """The identity element of reduce op ``op`` for ``dtype`` — the value
    padding must carry so it never enters a reduction's result: 0 for
    ``add``/``mean``, ``-inf``/``+inf`` (or the integer extremes) for
    ``max``/``min``.  Zero padding is *only* the identity of add/mean;
    capacity fill for a max/min pipeline should use this instead
    (``scatterv_bag(..., pad_value=reduce_identity(op, dtype))``)."""
    _resolve_reduce(op)
    dt = np.dtype(dtype)
    if op in ("add", "mean"):
        return dt.type(0)
    if dt.kind == "f":
        return dt.type(-np.inf if op == "max" else np.inf)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return dt.type(info.min if op == "max" else info.max)
    raise LayoutError(f"reduce_identity: no {op!r} identity for dtype {dt}")


@dataclasses.dataclass(frozen=True)
class DistBag:
    """This process's tile of a bag scattered over the ranks of a
    DistTraverser.

    ``data`` is the local tile, already in ``tile_layout``; the tile's grid
    coordinates follow from the traverser's mesh (:attr:`coords`).
    """

    data: torch.Tensor
    tile_layout: Layout
    dt: DistTraverser
    rank_dims: tuple[str, ...]
    # per-rank valid extents for *ragged* bags (the MPI v-collective
    # counts): a tuple over flat ranks (row-major over ``grid_shape``) of
    # ``((dim, valid_extent), ...)`` pairs.  The table is static and the same
    # on every rank.  The tile buffer keeps the homogeneous padded *capacity*
    # shape of ``tile_layout``; valid elements occupy the leading slice along
    # each ragged dim and the rest is zero padding.  None = dense.
    extents: tuple[tuple[tuple[str, int], ...], ...] | None = None
    # per-rank tile layouts of a *heterogeneous* bag (a send_recv receiver
    # keeping its declared layout, an all_gather whose ranks declared
    # different destination layouts): a tuple over flat ranks (row-major over
    # ``grid_shape``), the same on every rank.  The buffer keeps the
    # homogeneous shape of ``tile_layout``; ``tile(r)`` views it through the
    # rank's own entry, reshaping when that entry's physical shape differs
    # (the same element count).  None = every rank in ``tile_layout``.
    tile_layouts: tuple[Layout, ...] | None = None

    def __post_init__(self):
        if isinstance(self.rank_dims, str):
            object.__setattr__(self, "rank_dims", (self.rank_dims,))
        if tuple(self.data.shape) != self.tile_layout.shape:
            raise LayoutError(
                f"DistBag: tile shape {tuple(self.data.shape)} != layout shape {self.tile_layout.shape}"
            )
        if self.extents is not None and len(self.extents) != self.comm_size:
            raise LayoutError(
                f"extents table has {len(self.extents)} entries for comm size {self.comm_size}"
            )
        if self.tile_layouts is not None:
            if len(self.tile_layouts) != self.comm_size:
                raise LayoutError(f"tile_layouts has {len(self.tile_layouts)} entries for comm "
                                  f"size {self.comm_size}")
            for lay in self.tile_layouts:
                if prod(lay.shape) != prod(self.tile_layout.shape):
                    raise LayoutError(f"tile_layouts: layout shape {lay.shape} cannot view a "
                                      f"slot of shape {self.tile_layout.shape}")

    @property
    def comm_size(self) -> int:
        return prod(self.dt.comm_size(d) for d in self.rank_dims)

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(self.dt.comm_size(d) for d in self.rank_dims)

    @property
    def coords(self) -> tuple[int, ...]:
        """This process's grid coordinates along ``rank_dims``."""
        return tuple(self.dt.coord(d) for d in self.rank_dims)

    @property
    def own_layout(self) -> Layout:
        """The layout this process's buffer is in (its ``tile_layouts``
        entry on a heterogeneous bag)."""
        if self.tile_layouts is None:
            return self.tile_layout
        return self.tile_layouts[self.flat_rank(self.coords)]

    # -- ragged queries ---------------------------------------------------------
    @property
    def is_ragged(self) -> bool:
        return self.extents is not None

    def ragged_dims(self) -> tuple[str, ...]:
        """Dims with per-rank valid extents (empty for dense bags)."""
        if self.extents is None:
            return ()
        seen: dict[str, None] = {}
        for entry in self.extents:
            for d, _ in entry:
                seen[d] = None
        return tuple(seen)

    def flat_rank(self, rank: int | Sequence[int]) -> int:
        """Row-major flat index of a grid coordinate (``MPI_Cart_rank``)."""
        coords = (rank,) if isinstance(rank, int) else tuple(rank)
        if len(coords) != len(self.rank_dims):
            raise LayoutError(f"rank {rank!r} does not address grid {self.rank_dims}")
        flat = 0
        for c, s in zip(coords, self.grid_shape):
            if not 0 <= c < s:
                raise LayoutError(f"rank {rank!r} out of range for grid {self.grid_shape}")
            flat = flat * s + c
        return flat

    def rank_extents(self, rank: int | Sequence[int]) -> dict[str, int]:
        """Rank ``rank``'s valid extents (full capacity space for dense bags)."""
        space = dict(self.tile_layout.index_space())
        if self.extents is not None:
            space.update(dict(self.extents[self.flat_rank(rank)]))
        return space

    def tile(self, rank: int | Sequence[int]) -> Bag:
        """This process's tile as a bag (ragged bags: the *valid* leading
        region only).  ``rank`` is an int on 1-D communicators, a coordinate
        tuple on grids, and must be this process's own: other ranks' tiles
        live in other processes and are reached by gathering."""
        flat = self.flat_rank(rank)
        if flat != self.flat_rank(self.coords):
            raise LayoutError(
                f"tile({rank!r}): this process holds tile {self.coords}; "
                "gather to read other ranks' tiles"
            )
        return _tile_view(self, self.data, flat)

def _tile_view(db: DistBag, data: torch.Tensor, flat: int) -> Bag:
    layout = db.tile_layout if db.tile_layouts is None else db.tile_layouts[flat]
    b = Bag(data.reshape(layout.shape), layout)
    if db.extents is not None and db.extents[flat]:
        b = b.valid_view(dict(db.extents[flat]))
    return b


# -----------------------------------------------------------------------------
# shared plumbing
# -----------------------------------------------------------------------------
def _as_rank_dims(dt: DistTraverser, rank_dim) -> tuple[str, ...]:
    if rank_dim is None:
        return dt.rank_dims
    if isinstance(rank_dim, str):
        return (rank_dim,)
    return tuple(rank_dim)


def _transfer_layout(tile: Layout, leaves: tuple[tuple[str, int], ...]) -> Layout:
    """Tile layout with the rank-dim leaves prepended as outermost axes."""
    for leaf, _ in leaves:
        if any(a.name == leaf for a in tile.axes):
            raise LayoutError(f"rank leaf dim {leaf!r} collides with tile axis")
    axes = tuple(Axis(leaf, s) for leaf, s in leaves) + tile.axes
    dim_map = tuple((leaf, (leaf,)) for leaf, _ in leaves) + tile.dim_map
    return Layout(tile.dtype, axes, dim_map)


def _all_leaves(dt: DistTraverser, rank_dims: Sequence[str]) -> tuple[tuple[str, int], ...]:
    out: tuple[tuple[str, int], ...] = ()
    for d in rank_dims:
        out += dt.rank_leaves(d)
    return out


def _check_scatter_spaces(
    root: Layout, tile: Layout, dt: DistTraverser, rank_dims: Sequence[str]
) -> None:
    leaves = _all_leaves(dt, rank_dims)
    expected = dict(tile.index_space())
    for leaf, size in leaves:
        if leaf in expected:
            raise LayoutError(f"rank leaf {leaf!r} already in tile index space")
        expected[leaf] = size
    check_same_space(root.index_space(), expected, what="scatter(root, tile x ranks)")
    # and the traverser must agree with both (it was built from the structures)
    trav_space = dt.index_space()
    for d, s in tile.index_space().items():
        if d in trav_space and trav_space[d] != s:
            raise LayoutError(f"traverser dim {d!r} extent {trav_space[d]} != tile {s}")


def _lead_shape(dt: DistTraverser, rank_dims: Sequence[str]) -> tuple[int, ...]:
    return tuple(dt.comm_size(d) for d in rank_dims)


def _scatter_stacked(stacked: torch.Tensor | None, shape, dtype, dt: DistTraverser,
                     rank_dims: Sequence[str]) -> torch.Tensor:
    """MPI_Scatter of the root's stacked ``(P, *shape)`` tiles: communicator
    rank ``f`` receives slot ``f``.  Only the root (communicator rank 0)
    passes ``stacked``."""
    group, members = dt.communicator(rank_dims)
    if len(members) == 1:
        return stacked[0].clone(memory_format=torch.contiguous_format)
    out = torch.empty(shape, dtype=dtype, device=dt.mesh.device)
    slots = list(stacked.unbind(0)) if stacked is not None else None
    dist.scatter(out, slots, src=members[0], group=group)
    return out


def _all_gather_tiles(db: DistBag) -> torch.Tensor:
    """Every rank's tile, stacked ``(P, *tile shape)`` in communicator order."""
    group, members = db.dt.communicator(db.rank_dims)
    shape = db.tile_layout.shape
    if len(members) == 1:
        return db.data.reshape((1,) + shape)
    out = torch.empty((len(members),) + shape, dtype=db.data.dtype, device=db.data.device)
    # flat buffers: the stacked output is the rank-ordered concatenation
    dist.all_gather_into_tensor(out.view(-1), db.data.contiguous().view(-1), group=group)
    return out


def _is_root(dt: DistTraverser, rank_dims: Sequence[str]) -> bool:
    return all(dt.coord(d) == 0 for d in rank_dims)


def grid_extents(
    dt: DistTraverser,
    rank_dims: Sequence[str],
    ragged: Mapping[str, tuple[str, Sequence[int]]],
) -> tuple[tuple[tuple[str, int], ...], ...]:
    """Build a flat-rank extents table from per-grid-dim ragged specs.

    ``ragged`` maps a rank dim to ``(tile dim, per-coordinate valid
    extents)`` — the extents <-> counts mapping of the MPI v-collectives: the
    extent list is the counts array along that grid dim, the displacements
    are its prefix sums.  Rank dims absent from ``ragged`` are dense.  The
    result is indexed row-major over the grid shape.
    """
    for rd in ragged:
        if rd not in rank_dims:
            raise LayoutError(f"grid_extents: {rd!r} is not a rank dim (have {tuple(rank_dims)})")
    seen_dims = [dim for dim, _ in ragged.values()]
    if len(set(seen_dims)) != len(seen_dims):
        raise LayoutError(f"grid_extents: a tile dim is ragged over two rank dims: {seen_dims}")
    shape = [dt.comm_size(d) for d in rank_dims]
    for rd, (dim, exts) in ragged.items():
        if len(exts) != dt.comm_size(rd):
            raise LayoutError(
                f"grid_extents: {len(exts)} extents for {rd!r} of comm size {dt.comm_size(rd)}"
            )
    out = []
    for coords in itertools.product(*(range(s) for s in shape)):
        entry = []
        for rd, c in zip(rank_dims, coords):
            if rd in ragged:
                dim, exts = ragged[rd]
                entry.append((dim, int(exts[c])))
        out.append(tuple(entry))
    return tuple(out)


def _ragged_owner_candidates(dist_bag: DistBag) -> dict[str, list[int]]:
    """For each ragged dim, the rank-dim positions its extents are
    *separable* along (depend only on that position's coordinate) — the
    inverse of :func:`grid_extents`.  Uniform extents are separable along
    every position, so callers disambiguate with the root-space sums
    (:func:`_match_ragged_owners`).  Raises when an extents table is not a
    per-grid-dim product."""
    assert dist_bag.extents is not None
    shape = dist_bag.grid_shape
    coords_list = list(itertools.product(*(range(s) for s in shape)))
    by_dim: dict[str, dict[tuple, int]] = {}
    for coords, entry in zip(coords_list, dist_bag.extents):
        for d, e in entry:
            by_dim.setdefault(d, {})[coords] = e
    out: dict[str, list[int]] = {}
    for d, table in by_dim.items():
        if len(table) != len(coords_list):
            raise LayoutError(f"ragged dim {d!r} has extents on only some ranks")
        cands = []
        for p in range(len(shape)):
            per_coord: dict[int, int] = {}
            if all(per_coord.setdefault(coords[p], e) == e for coords, e in table.items()):
                cands.append(p)
        if not cands:
            raise LayoutError(
                f"ragged dim {d!r}: extents do not vary along a single rank dim "
                f"(not a grid_extents-style table)"
            )
        out[d] = cands
    return out


def _match_ragged_owners(dist_bag: DistBag, root_space: Mapping[str, int]) -> dict[str, int]:
    """Assign each ragged dim to the rank dim that tiles it, as a perfect
    matching over grid positions: candidates come from separability, the
    root-space sums disambiguate dims whose extents are uniform, and a small
    backtracking search finds the permutation."""
    cand_sets = _ragged_owner_candidates(dist_bag)
    shape = dist_bag.grid_shape
    filtered: dict[str, list[int]] = {}
    for d, cands in cand_sets.items():
        keep = [p for p in cands if sum(_dim_extent_list(dist_bag, d, p)) == root_space.get(d)]
        if not keep:
            raise LayoutError(
                f"gatherv: extents of {d!r} sum to none of the candidate rank "
                f"dims' totals (root extent {root_space.get(d)})"
            )
        filtered[d] = keep
    dims = sorted(filtered, key=lambda d: len(filtered[d]))
    if len(dims) != len(shape):
        raise LayoutError(
            f"gatherv: ragged dims {dims} must cover every rank dim "
            f"{dist_bag.rank_dims} exactly once"
        )

    def assign(i: int, used: set) -> dict[str, int] | None:
        if i == len(dims):
            return {}
        d = dims[i]
        for p in filtered[d]:
            if p in used:
                continue
            rest = assign(i + 1, used | {p})
            if rest is not None:
                rest[d] = p
                return rest
        return None

    owners = assign(0, set())
    if owners is None:
        raise LayoutError(
            f"gatherv: no one-to-one assignment of ragged dims {dims} to rank "
            f"dims {dist_bag.rank_dims} matches the root extents"
        )
    return owners


def _dim_extent_list(dist_bag: DistBag, dim: str, pos: int) -> list[int]:
    """Per-coordinate extents of ``dim`` along rank-dim position ``pos``."""
    shape = dist_bag.grid_shape
    out = []
    for c in range(shape[pos]):
        coords = [0] * len(shape)
        coords[pos] = c
        out.append(dist_bag.rank_extents(tuple(coords))[dim])
    return out


def _require_dense(dist_bag: DistBag, what: str) -> None:
    """Guard: the dense collectives cannot reorganize ragged dims (their
    counts differ per rank) — direct the caller to the v-form."""
    if dist_bag.extents is not None and dist_bag.ragged_dims():
        raise LayoutError(
            f"{what}: bag is ragged along {sorted(dist_bag.ragged_dims())}; use the "
            "v-collective (scatterv/gatherv/reduce_scatterv) instead"
        )


def _require_homogeneous(dist_bag: DistBag, what: str) -> None:
    """Guard: a collective on a bag whose ranks hold their tiles in
    different layouts (``tile_layouts``) would move each rank's bytes as if
    they were in ``tile_layout``.  The table is the same on every rank, so
    every rank refuses together, before any transfer is issued: no rank is
    left waiting in a collective another rank refused."""
    if dist_bag.tile_layouts is not None:
        raise LayoutError(
            f"{what}: bag carries per-rank heterogeneous tile layouts (tile_layouts); "
            "relayout to a homogeneous bag first"
        )


def _uniform_extents_along(dist_bag: DistBag, rank_dim: str, what: str) -> None:
    """Every member of each ``rank_dim`` sub-communicator must agree on the
    extents (an elementwise reduce across differing valid regions is
    ill-typed)."""
    if dist_bag.extents is None:
        return
    pos = dist_bag.rank_dims.index(rank_dim)
    for coords in itertools.product(*(range(s) for s in dist_bag.grid_shape)):
        if coords[pos] == 0:
            continue
        base = list(coords)
        base[pos] = 0
        if dist_bag.extents[dist_bag.flat_rank(coords)] != dist_bag.extents[dist_bag.flat_rank(tuple(base))]:
            raise LayoutError(
                f"{what}: extents differ across the {rank_dim!r} communicator "
                "(elementwise reduce over ragged tiles is ill-typed)"
            )


def _dense_layout(dtype, items: Sequence[tuple[str, int]]) -> Layout:
    """Row-major layout over ``items`` (dim, extent) pairs, outer..inner."""
    axes = tuple(Axis(d, s) for d, s in items)
    dim_map = tuple((d, (d,)) for d, _ in items)
    return Layout(dtype, axes, dim_map)


def _fresh_axis_name(layout: Layout, base: str) -> str:
    name = base
    while any(a.name == name for a in layout.axes) or any(d == name for d, _ in layout.dim_map):
        name += "_"
    return name


def _block_over(layout: Layout, dim: str, name: str, R: int) -> Layout:
    """``layout`` with a new outermost axis of size ``R`` enumerating the R
    outer blocks of logical ``dim`` (so the result spans ``dim`` extent * R)."""
    axes = (Axis(name, R),) + layout.axes
    dim_map = tuple(
        (d, ((name,) + axs) if d == dim else axs) for d, axs in layout.dim_map
    )
    return Layout(layout.dtype, axes, dim_map)


def _issue_reduce_scatter_stacked(stacked: torch.Tensor, op: str, dt: DistTraverser,
                                  rank_dim: str) -> tuple[torch.Tensor, list]:
    """Reduce ``stacked`` ``(R, *piece)`` over the ``rank_dim`` communicator
    and keep block ``r`` on communicator rank ``r``; returns the landing
    buffer and the Work handles (none for a one-process communicator)."""
    group, members = dt.communicator((rank_dim,))
    if len(members) == 1:
        return stacked[0].clone(memory_format=torch.contiguous_format), []
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype, device=stacked.device)
    work = dist.reduce_scatter_tensor(out.view(-1), stacked.contiguous().view(-1),
                                      op=_resolve_reduce(op), group=group, async_op=True)
    return out, [work]


def _check_rank_dim(dist_bag: DistBag, rank_dim: str | None) -> str:
    rank_dim = rank_dim or dist_bag.rank_dims[0]
    if rank_dim not in dist_bag.rank_dims:
        raise LayoutError(f"bag is not distributed over {rank_dim!r} (has {dist_bag.rank_dims})")
    return rank_dim


# -----------------------------------------------------------------------------
# root <-> tiles (scatter / gather / broadcast)
# -----------------------------------------------------------------------------
def scatter(
    root: Bag,
    tile_layout: Layout,
    dt: DistTraverser,
    rank_dim: str | Sequence[str] | None = None,
) -> DistBag:
    """Scatter ``root`` so each rank holds one tile in ``tile_layout``
    (``MPI_Scatter`` from communicator rank 0, whose ``root`` is read).

    Works for arbitrary (root layout, tile layout) pairs over the same logical
    space — including different dimension orders and blockings on the two
    sides; the root packs every tile into its destination layout before the
    transfer.  With a grid traverser, ``rank_dim`` may list several ranking
    dims (default: all of them) and the tiles distribute over the full
    communicator grid.
    """
    rank_dims = _as_rank_dims(dt, rank_dim)
    _check_scatter_spaces(root.layout, tile_layout, dt, rank_dims)
    stacked = None
    if _is_root(dt, rank_dims):
        xfer = _transfer_layout(tile_layout, _all_leaves(dt, rank_dims))
        arr = relayout(root.data.to(dt.mesh.device), root.layout, xfer)
        stacked = arr.reshape((-1,) + tile_layout.shape)
    tile = _scatter_stacked(stacked, tile_layout.shape, torch_dtype(tile_layout.dtype), dt, rank_dims)
    return DistBag(tile, tile_layout, dt, rank_dims)


def gather(dist_bag: DistBag, root_layout: Layout) -> Bag:
    """Gather the tiles back into a root bag with ``root_layout`` (any layout
    spanning the same global logical space).  Every rank receives the root
    (``MPI_Allgather``), like the reference's replicated root."""
    _require_homogeneous(dist_bag, "gather")
    _require_dense(dist_bag, "gather (use gatherv_bag for ragged tiles)")
    _check_scatter_spaces(root_layout, dist_bag.tile_layout, dist_bag.dt, dist_bag.rank_dims)
    xfer = _transfer_layout(dist_bag.tile_layout, _all_leaves(dist_bag.dt, dist_bag.rank_dims))
    arr = _all_gather_tiles(dist_bag).reshape(xfer.shape)
    return Bag(relayout(arr, xfer, root_layout), root_layout)


def broadcast(b: Bag, dt: DistTraverser, dst_layout: Layout | None = None) -> Bag:
    """Replicate a bag from communicator rank 0 to every rank, relayouting if
    the destination layout differs (the paper's broadcast between
    column-major and row-major)."""
    data = b.data.to(dt.mesh.device)
    layout = b.layout
    if dst_layout is not None:
        check_same_space(layout.index_space(), dst_layout.index_space(), what="broadcast")
        data = relayout(data, layout, dst_layout)
        layout = dst_layout
    group, members = dt.communicator(dt.rank_dims)
    data = data.clone(memory_format=torch.contiguous_format)
    if len(members) > 1:
        dist.broadcast(data, src=members[0], group=group)
    return Bag(data, layout)


def dist_full(
    dt: DistTraverser,
    tile_layout: Layout,
    *,
    fill: Any = 0.0,
    rank_dim: str | Sequence[str] | None = None,
) -> DistBag:
    """Allocate a DistBag with every tile filled with ``fill`` (the
    distributed counterpart of :func:`repro_torch.core.bag`)."""
    rank_dims = _as_rank_dims(dt, rank_dim)
    data = torch.full(tile_layout.shape, fill, dtype=torch_dtype(tile_layout.dtype),
                      device=dt.mesh.device)
    return DistBag(data, tile_layout, dt, rank_dims)


# -----------------------------------------------------------------------------
# all-gather and all-reduce (MPI_Allgather / MPI_Allreduce)
# -----------------------------------------------------------------------------
def all_gather_start(
    dist_bag: DistBag,
    root_layout: Layout | Sequence[Layout],
    *,
    rank_dim: str | Sequence[str] | None = None,
) -> Pending:
    """Non-blocking all-gather (``MPI_Iallgather``): issue the transfer and
    return a :class:`Pending` whose :meth:`~Pending.wait` hands back a
    :class:`DistBag` in which every rank of the ``rank_dim`` communicator
    holds the full gathered structure in its destination layout.

    ``root_layout`` is one layout (every rank declares the same destination)
    or a sequence of per-rank layouts over the same index space and physical
    shape (1-D communicators only), indexed by the communicator rank: each
    rank unpacks the landed tiles into its own.  The bag keeps its full grid
    distribution: ranks outside ``rank_dim`` hold independent
    (sub-communicator) results."""
    _require_homogeneous(dist_bag, "all_gather")
    rank_dims = _as_rank_dims(dist_bag.dt, rank_dim) if rank_dim is not None \
        else dist_bag.rank_dims
    for d in rank_dims:
        if d not in dist_bag.rank_dims:
            raise LayoutError(f"bag is not distributed over {d!r} (has {dist_bag.rank_dims})")
    _require_dense(dist_bag, "all_gather")
    layouts = [root_layout] if isinstance(root_layout, Layout) else list(root_layout)
    if len(layouts) > 1 and len(rank_dims) != 1:
        raise LayoutError("per-rank all_gather layouts need a 1-D communicator")
    group, members = dist_bag.dt.communicator(rank_dims)
    if len(layouts) not in (1, len(members)):
        raise LayoutError(
            f"all_gather: got {len(layouts)} destination layouts for comm size {len(members)}"
        )
    for lay in layouts:
        _check_scatter_spaces(lay, dist_bag.tile_layout, dist_bag.dt, rank_dims)
        if lay.shape != layouts[0].shape:
            raise LayoutError(
                f"per-rank all_gather layouts must share one physical shape: "
                f"{lay.shape} != {layouts[0].shape}"
            )
    mine = layouts[0] if len(layouts) == 1 else layouts[dist_bag.dt.coord(rank_dims[0])]
    xfer = _transfer_layout(dist_bag.tile_layout, _all_leaves(dist_bag.dt, rank_dims))
    tile = dist_bag.data.contiguous()
    landed = torch.empty((len(members) * tile.numel(),), dtype=tile.dtype, device=tile.device)
    works = []
    if len(members) == 1:
        landed.copy_(tile.view(-1))
    else:  # flat buffers: the landed tiles in communicator order
        works.append(dist.all_gather_into_tensor(landed, tile.view(-1), group=group,
                                                 async_op=True))

    tile_layouts = None
    if len(layouts) > 1:
        # the reference's per-rank table: indexed by the full-grid flat rank,
        # the declarations keyed on the gathered communicator dim expanded
        # across the other grid coordinates
        pos = dist_bag.rank_dims.index(rank_dims[0])
        tile_layouts = tuple(layouts[c[pos]] for c in itertools.product(
            *(range(s) for s in dist_bag.grid_shape)))

    def finish():
        data = relayout(landed.reshape(xfer.shape), xfer, mine)
        return DistBag(data, layouts[0], dist_bag.dt, dist_bag.rank_dims,
                       tile_layouts=tile_layouts)

    return Pending(finish, works, op="all_gather")


def all_gather_dist(
    dist_bag: DistBag,
    root_layout: Layout | Sequence[Layout],
    *,
    rank_dim: str | Sequence[str] | None = None,
) -> DistBag:
    """Blocking all-gather returning the per-rank receive buffers as a
    :class:`DistBag` (``all_gather_start(...).wait()``)."""
    return all_gather_start(dist_bag, root_layout, rank_dim=rank_dim).wait()


def all_gather_bag(dist_bag: DistBag, root_layout: Layout) -> Bag:
    """Every rank ends with the full structure in ``root_layout``, moved by
    one ``all_gather`` over the whole communicator grid and unpacked on the
    receive side (:func:`gather` stays as the oracle)."""
    return Bag(all_gather_dist(dist_bag, root_layout).data, root_layout)


def all_reduce_start(
    dist_bag: DistBag,
    op: str = "add",
    *,
    rank_dim: str | None = None,
    out_tile_layout: Layout | None = None,
) -> Pending:
    """Non-blocking all-reduce (``MPI_Iallreduce``): issue the reduction and
    return a :class:`Pending` immediately (see :func:`all_reduce_bag`)."""
    _require_homogeneous(dist_bag, "all_reduce")
    rank_dim = _check_rank_dim(dist_bag, rank_dim)
    out_layout = out_tile_layout or dist_bag.tile_layout
    check_same_space(dist_bag.tile_layout.index_space(), out_layout.index_space(),
                     what="all_reduce")
    _uniform_extents_along(dist_bag, rank_dim, "all_reduce")
    if dist_bag.extents is not None:
        check_ragged_dims(dist_bag.tile_layout, out_layout, dist_bag.ragged_dims(),
                          what="all_reduce")
    red_op = _resolve_reduce(op)
    group, members = dist_bag.dt.communicator((rank_dim,))
    R = len(members)
    # the send datatype: pack into the output layout before the transfer
    buf = relayout(dist_bag.data, dist_bag.tile_layout, out_layout).clone(
        memory_format=torch.contiguous_format)
    works = [dist.all_reduce(buf, op=red_op, group=group, async_op=True)] if R > 1 else []

    def finish():
        y = buf / R if op == "mean" else buf
        return DistBag(y, out_layout, dist_bag.dt, dist_bag.rank_dims, extents=dist_bag.extents)

    return Pending(finish, works, op="all_reduce")


def all_reduce_bag(
    dist_bag: DistBag,
    op: str = "add",
    *,
    rank_dim: str | None = None,
    out_tile_layout: Layout | None = None,
) -> DistBag:
    """Reduce tiles elementwise across the ``rank_dim`` communicator; every
    rank of that communicator ends with the same reduced tile
    (``MPI_Allreduce``).  ``out_tile_layout`` may differ from the input tile
    layout: the tile is packed into it before the transfer."""
    return all_reduce_start(dist_bag, op, rank_dim=rank_dim,
                            out_tile_layout=out_tile_layout).wait()


# -----------------------------------------------------------------------------
# reduce-scatter (MPI_Reduce_scatter)
# -----------------------------------------------------------------------------
def reduce_scatter_start(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    scatter_dim: str | None = None,
    op: str = "add",
    rank_dim: str | None = None,
) -> Pending:
    """Non-blocking reduce-scatter (``MPI_Ireduce_scatter``): issue the
    reduce+scatter and return a :class:`Pending` immediately (see
    :func:`reduce_scatter_bag`)."""
    _require_homogeneous(dist_bag, "reduce_scatter")
    _require_dense(dist_bag, "reduce_scatter (use reduce_scatterv_bag for ragged tiles)")
    rank_dim = _check_rank_dim(dist_bag, rank_dim)
    R = dist_bag.dt.comm_size(rank_dim)
    in_space = dist_bag.tile_layout.index_space()
    out_space = out_tile_layout.index_space()
    if scatter_dim is None:
        cands = [d for d, s in in_space.items() if out_space.get(d, -1) * R == s]
        if len(cands) != 1:
            raise LayoutError(
                f"cannot infer scatter dim from {in_space} -> {out_space} "
                f"with comm size {R} (candidates: {cands}); pass scatter_dim"
            )
        (scatter_dim,) = cands
    expected = dict(out_space)
    if scatter_dim not in expected:
        raise LayoutError(f"scatter dim {scatter_dim!r} missing from output space {out_space}")
    expected[scatter_dim] = expected[scatter_dim] * R
    check_same_space(in_space, expected, what=f"reduce_scatter over {scatter_dim!r}")
    _resolve_reduce(op)
    blk = _fresh_axis_name(out_tile_layout, "__rs")
    mid = _block_over(out_tile_layout, scatter_dim, blk, R)
    # (R, *out shape): block r is rank r's part, already in the output layout
    stacked = relayout(dist_bag.data, dist_bag.tile_layout, mid)
    out, works = _issue_reduce_scatter_stacked(stacked, op, dist_bag.dt, rank_dim)

    def finish():
        y = out / R if op == "mean" else out
        return DistBag(y, out_tile_layout, dist_bag.dt, dist_bag.rank_dims)

    return Pending(finish, works, op="reduce_scatter")


def reduce_scatter_bag(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    scatter_dim: str | None = None,
    op: str = "add",
    rank_dim: str | None = None,
) -> DistBag:
    """Elementwise-reduce tiles across the ``rank_dim`` communicator, then
    scatter the result: communicator rank ``r`` keeps logical block ``r`` of
    ``scatter_dim`` (MPI_Reduce_scatter_block).

    The output tile layout is free — rank ``r``'s block lands directly in
    ``out_tile_layout``, with the transform packed before the transfer.
    Index spaces are checked first: the output space must equal the input
    space except that ``scatter_dim``'s extent shrinks by the communicator
    size.
    """
    return reduce_scatter_start(
        dist_bag, out_tile_layout, scatter_dim=scatter_dim, op=op, rank_dim=rank_dim
    ).wait()


# -----------------------------------------------------------------------------
# ragged v-collectives (MPI_Scatterv / Gatherv / Reduce_scatter v)
# -----------------------------------------------------------------------------
def _check_vscatter(
    root_layout: Layout,
    tile_layout: Layout,
    dt: DistTraverser,
    rank_dims: Sequence[str],
    ragged: Mapping[str, tuple[str, Sequence[int]]],
) -> None:
    if set(ragged) != set(rank_dims):
        raise LayoutError(
            f"scatterv: ragged spec covers {sorted(ragged)} but the operation "
            f"distributes over {tuple(rank_dims)}; every rank dim needs its "
            "(tile dim, extents) counts (use scatter for dense block dims)"
        )
    root_space = root_layout.index_space()
    tile_space = tile_layout.index_space()
    if set(root_space) != set(tile_space):
        raise LayoutError(
            f"scatterv: root dims {sorted(root_space)} != tile dims {sorted(tile_space)}"
        )
    rdims = []
    for rd in rank_dims:
        dim, exts = ragged[rd]
        rdims.append(dim)
        if dim not in tile_space:
            raise LayoutError(f"scatterv: ragged dim {dim!r} missing from tile space")
        if len(exts) != dt.comm_size(rd):
            raise LayoutError(
                f"scatterv: {len(exts)} extents for {rd!r} of comm size {dt.comm_size(rd)}"
            )
        if min(exts) < 1:
            raise LayoutError(f"scatterv: empty block in extents {tuple(exts)} for {rd!r}")
        if max(exts) > tile_space[dim]:
            raise LayoutError(
                f"scatterv: extent {max(exts)} of dim {dim!r} exceeds tile "
                f"capacity {tile_space[dim]}"
            )
        if sum(exts) != root_space[dim]:
            raise LayoutError(
                f"scatterv: extents of {dim!r} sum to {sum(exts)} != root extent "
                f"{root_space[dim]} (counts must tile the root exactly)"
            )
    for d, s in tile_space.items():
        if d not in rdims and root_space[d] != s:
            raise LayoutError(
                f"scatterv: dense dim {d!r} extent {s} != root extent {root_space[d]}"
            )
    check_ragged_dims(tile_layout, tile_layout, rdims, what="scatterv(tile)")


def _prefix_sums(exts: Sequence[int]) -> list[int]:
    out, acc = [0], 0
    for e in exts:
        acc += e
        out.append(acc)
    return out


def scatterv_bag(
    root: Bag,
    tile_layout: Layout,
    dt: DistTraverser,
    ragged: Mapping[str, tuple[str, Sequence[int]]],
    rank_dim: str | Sequence[str] | None = None,
    *,
    pad_value=0,
) -> DistBag:
    """``MPI_Scatterv``: scatter ``root`` into per-rank *ragged* tiles.

    ``ragged`` maps each rank dim to ``(tile dim, per-coordinate extents)``
    — the counts array; displacements are its prefix sums.  ``tile_layout``
    is the homogeneous padded *capacity* layout (its ragged dims sized at the
    max extent, typically ``ceil(total / R)`` from
    :func:`repro_torch.core.dims.ragged_split`); rank ``r`` receives its
    ``extents[r]``-sized logical block in the leading slice with
    ``pad_value`` padding behind it, relayouted from any root layout exactly
    like :func:`scatter`.  The result carries the extents table, so
    downstream collectives and :meth:`DistBag.tile` stay padding-free.

    ``pad_value`` is the capacity-fill value (default 0, the add/mean
    identity); tiles feeding a local ``max``/``min`` over a ragged dim
    should fill with ``reduce_identity(op, dtype)``.
    """
    rank_dims = _as_rank_dims(dt, rank_dim)
    ragged = dict(ragged)
    _check_vscatter(root.layout, tile_layout, dt, rank_dims, ragged)
    lead = _lead_shape(dt, rank_dims)
    dtype = torch_dtype(tile_layout.dtype)
    stacked = None
    if _is_root(dt, rank_dims):
        canon = _dense_layout(root.layout.dtype, list(root.layout.index_space().items()))
        arr = relayout(root.data.to(dt.mesh.device), root.layout, canon)
        axis_of = {d: canon.axis_index(d) for d, _ in canon.dim_map}
        offs = {rd: _prefix_sums(ragged[rd][1]) for rd in rank_dims}
        stacked = torch.full((prod(lead),) + tile_layout.shape, pad_value, dtype=dtype,
                             device=dt.mesh.device)
        for f, coords in enumerate(itertools.product(*(range(s) for s in lead))):
            slicer: list[Any] = [slice(None)] * canon.ndim
            shrunk_canon, shrunk_tile = canon, tile_layout
            for rd, c in zip(rank_dims, coords):
                dim, exts = ragged[rd]
                o = offs[rd][c]
                slicer[axis_of[dim]] = slice(o, o + exts[c])
                shrunk_canon = shrunk_canon.resize_dim(dim, exts[c])
                shrunk_tile = shrunk_tile.resize_dim(dim, exts[c])
            chunk = relayout(arr[tuple(slicer)], shrunk_canon, shrunk_tile)
            stacked[f][tuple(slice(0, s) for s in shrunk_tile.shape)] = chunk
    tile = _scatter_stacked(stacked, tile_layout.shape, dtype, dt, rank_dims)
    return DistBag(tile, tile_layout, dt, tuple(rank_dims),
                   extents=grid_extents(dt, rank_dims, ragged))


def gatherv_bag(dist_bag: DistBag, root_layout: Layout) -> Bag:
    """``MPI_Gatherv``: assemble the ragged tiles back into a root bag on
    every rank.

    The displacement arithmetic is recovered from the bag's extents table
    (each ragged dim's counts vary along exactly one rank dim); only the
    valid leading regions enter the result — the padding never leaves the
    tiles.  The inverse of :func:`scatterv_bag` for any ``root_layout`` over
    the same space.
    """
    _require_homogeneous(dist_bag, "gatherv")
    if dist_bag.extents is None:
        raise LayoutError("gatherv_bag: bag is dense (no extents); use gather")
    root_space = root_layout.index_space()
    tile_space = dist_bag.tile_layout.index_space()
    if set(root_space) != set(tile_space):
        raise LayoutError(
            f"gatherv_bag: root dims {sorted(root_space)} != tile dims {sorted(tile_space)}"
        )
    owners = _match_ragged_owners(dist_bag, root_space)
    ext_lists = {d: _dim_extent_list(dist_bag, d, p) for d, p in owners.items()}
    for d, s in tile_space.items():
        if d not in owners and root_space[d] != s:
            raise LayoutError(
                f"gatherv_bag: dense dim {d!r} extent {s} != root extent {root_space[d]}"
            )
    tiles = _all_gather_tiles(dist_bag)
    canon = _dense_layout(root_layout.dtype, list(root_space.items()))
    axis_of = {d: canon.axis_index(d) for d, _ in canon.dim_map}
    offs = {d: _prefix_sums(exts) for d, exts in ext_lists.items()}
    out = torch.zeros(canon.shape, dtype=tiles.dtype, device=tiles.device)
    for flat, coords in enumerate(itertools.product(*(range(s) for s in dist_bag.grid_shape))):
        t = _tile_view(dist_bag, tiles[flat], flat)  # valid view: ragged dims resized
        shrunk_canon = canon
        slicer: list[Any] = [slice(None)] * canon.ndim
        for d, p in owners.items():
            e = ext_lists[d][coords[p]]
            o = offs[d][coords[p]]
            shrunk_canon = shrunk_canon.resize_dim(d, e)
            slicer[axis_of[d]] = slice(o, o + e)
        out[tuple(slicer)] = relayout(t.data, t.layout, shrunk_canon)
    return Bag(relayout(out, canon, root_layout), root_layout)


def reduce_scatterv_start(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    scatter_dim: str,
    in_blocks: tuple[int, Sequence[int]],
    out_extents: Sequence[int],
    op: str = "add",
    rank_dim: str | None = None,
) -> Pending:
    """Non-blocking ragged reduce-scatter: issue and return a
    :class:`Pending` immediately (see :func:`reduce_scatterv_bag`).

    The input tile's ``scatter_dim`` is *block-ragged*: ``in_blocks =
    (capacity, extents)`` describes B interior blocks of uniform capacity
    whose valid leading extents differ (a partial panel accumulated block by
    block, e.g. the ragged SUMMA epilogue).  Each rank slices the valid
    stream straight out of its padded blocks into R output blocks of
    ``out_extents``, re-padded to the output capacity (all static slices,
    identical on every rank), and the stacked blocks are reduced+scattered
    with padded capacity tiles on the wire: ``add``/``mean`` pad with zero,
    their identity; ``max``/``min`` pad with :func:`reduce_identity` and the
    output padding is re-zeroed so the bag's zero-padding contract survives.
    """
    _require_homogeneous(dist_bag, "reduce_scatterv")
    rank_dim = _check_rank_dim(dist_bag, rank_dim)
    _resolve_reduce(op)
    if scatter_dim in dist_bag.ragged_dims():
        raise LayoutError(
            f"reduce_scatterv: {scatter_dim!r} is leading-ragged in the input; "
            "its block structure must come via in_blocks"
        )
    _uniform_extents_along(dist_bag, rank_dim, "reduce_scatterv")
    R = dist_bag.dt.comm_size(rank_dim)
    cap_in, in_exts = in_blocks
    in_exts = tuple(int(e) for e in in_exts)
    B = len(in_exts)
    total = sum(in_exts)
    out_extents = tuple(int(e) for e in out_extents)
    if len(out_extents) != R:
        raise LayoutError(f"reduce_scatterv: {len(out_extents)} out extents for comm size {R}")
    if sum(out_extents) != total:
        raise LayoutError(
            f"reduce_scatterv: out extents sum {sum(out_extents)} != in extents sum {total}"
        )
    if max(in_exts) > cap_in or min(in_exts) < 0:
        raise LayoutError(f"reduce_scatterv: in extents {in_exts} exceed capacity {cap_in}")
    in_space = dist_bag.tile_layout.index_space()
    out_space = out_tile_layout.index_space()
    if in_space.get(scatter_dim) != B * cap_in:
        raise LayoutError(
            f"reduce_scatterv: scatter dim {scatter_dim!r} extent {in_space.get(scatter_dim)} "
            f"!= {B} blocks x capacity {cap_in}"
        )
    cap_out = out_space.get(scatter_dim)
    if cap_out is None or max(out_extents) > cap_out:
        raise LayoutError(
            f"reduce_scatterv: out extents {out_extents} exceed output capacity {cap_out}"
        )
    expected = dict(in_space)
    expected[scatter_dim] = cap_out
    check_same_space(out_space, expected, what=f"reduce_scatterv over {scatter_dim!r}")
    other_ragged = dist_bag.ragged_dims()
    check_ragged_dims(
        dist_bag.tile_layout, out_tile_layout, (scatter_dim,) + other_ragged, what="reduce_scatterv"
    )
    rest = [(d, s) for d, s in in_space.items() if d != scatter_dim]
    mid_in = _dense_layout(dist_bag.tile_layout.dtype, rest + [(scatter_dim, B * cap_in)])
    mid_out = _dense_layout(out_tile_layout.dtype, rest + [(scatter_dim, cap_out)])
    ident = reduce_identity(op, dist_bag.tile_layout.dtype)

    # displacement prefix sums over the valid stream: input block b holds
    # stream rows [ibase[b], ibase[b+1]), output rank r wants rows
    # [obase[r], obase[r+1])
    ibase = _prefix_sums(in_exts)
    obase = _prefix_sums(out_extents)
    x = relayout(dist_bag.data, dist_bag.tile_layout, mid_in)
    stacked = torch.full((R,) + mid_out.shape, ident.item(), dtype=x.dtype, device=x.device)
    for r in range(R):
        o = 0
        for b in range(B):
            lo = max(obase[r], ibase[b])
            hi = min(obase[r + 1], ibase[b + 1])
            if lo >= hi:
                continue
            s = b * cap_in + (lo - ibase[b])
            stacked[r, ..., o:o + (hi - lo)] = x[..., s:s + (hi - lo)]
            o += hi - lo
    out, works = _issue_reduce_scatter_stacked(stacked, op, dist_bag.dt, rank_dim)
    pos = dist_bag.rank_dims.index(rank_dim)
    my_flat = dist_bag.flat_rank(dist_bag.coords)
    new_ext = []
    for coords in itertools.product(*(range(s) for s in dist_bag.grid_shape)):
        entry = [
            p
            for p in (dist_bag.extents[dist_bag.flat_rank(coords)] if dist_bag.extents else ())
            if p[0] != scatter_dim
        ]
        entry.append((scatter_dim, out_extents[coords[pos]]))
        new_ext.append(tuple(entry))

    def finish():
        y = out / R if op == "mean" else out
        if op in ("max", "min"):
            # restore the zero-padding contract of the result bag: the reduce
            # of identities is the identity, not 0
            for d, e in new_ext[my_flat]:
                y.narrow(mid_out.axis_index(d), e, y.shape[mid_out.axis_index(d)] - e).zero_()
        y = relayout(y, mid_out, out_tile_layout)
        return DistBag(y, out_tile_layout, dist_bag.dt, dist_bag.rank_dims,
                       extents=tuple(new_ext))

    return Pending(finish, works, op="reduce_scatterv")


def reduce_scatterv_bag(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    scatter_dim: str,
    in_blocks: tuple[int, Sequence[int]],
    out_extents: Sequence[int],
    op: str = "add",
    rank_dim: str | None = None,
) -> DistBag:
    """Ragged ``MPI_Reduce_scatter``: elementwise-reduce block-ragged panels
    across the ``rank_dim`` communicator and scatter ``scatter_dim`` so rank
    ``r`` keeps its ``out_extents[r]``-sized logical block (leading slice of
    a ``max(out_extents)``-capacity tile).  See
    :func:`reduce_scatterv_start` for the block-compaction semantics."""
    return reduce_scatterv_start(
        dist_bag,
        out_tile_layout,
        scatter_dim=scatter_dim,
        in_blocks=in_blocks,
        out_extents=out_extents,
        op=op,
        rank_dim=rank_dim,
    ).wait()


# -----------------------------------------------------------------------------
# all-to-all and the ragged all-gather / all-to-all (MPI_Alltoall /
# MPI_Allgatherv / MPI_Alltoallv)
# -----------------------------------------------------------------------------
def _issue_all_to_all_pieces(pieces: Sequence[torch.Tensor], recv_shapes: Sequence[tuple],
                             dt: DistTraverser, rank_dim: str) -> tuple[list, list]:
    """Send ``pieces[j]`` to communicator rank ``j`` and land rank ``j``'s
    piece for this process in a buffer of ``recv_shapes[j]``: one
    ``all_to_all_single`` with per-rank split sizes (``MPI_Ialltoallv``), so
    only the pieces' own elements cross the wire and an empty piece moves
    nothing.  Returns the landing buffers and the Work handles (none for a
    one-process communicator)."""
    group, members = dt.communicator((rank_dim,))
    if len(members) == 1:
        return [pieces[0].clone(memory_format=torch.contiguous_format)], []
    send = torch.cat([p.reshape(-1) for p in pieces])
    sizes = [prod(s) for s in recv_shapes]
    landed = torch.empty((sum(sizes),), dtype=send.dtype, device=send.device)
    work = dist.all_to_all_single(landed, send, output_split_sizes=sizes,
                                  input_split_sizes=[p.numel() for p in pieces],
                                  group=group, async_op=True)
    return [t.view(s) for t, s in zip(landed.split(sizes), recv_shapes)], [work]


def all_to_all_start(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    split_dim: str,
    concat_dim: str,
    rank_dim: str | None = None,
) -> Pending:
    """Non-blocking all-to-all (``MPI_Ialltoall``): issue the reshard and
    return a :class:`Pending` immediately (see :func:`all_to_all_bag`)."""
    _require_homogeneous(dist_bag, "all_to_all")
    _require_dense(dist_bag, "all_to_all (use all_to_allv_bag for ragged tiles)")
    if split_dim == concat_dim:
        raise LayoutError("all_to_all: split_dim and concat_dim must differ")
    rank_dim = _check_rank_dim(dist_bag, rank_dim)
    R = dist_bag.dt.comm_size(rank_dim)
    in_space = dist_bag.tile_layout.index_space()
    out_space = out_tile_layout.index_space()
    expected = dict(out_space)
    for d in (split_dim, concat_dim):
        if d not in expected:
            raise LayoutError(f"dim {d!r} missing from output space {out_space}")
    if in_space.get(split_dim) != out_space[split_dim] * R:
        raise LayoutError(
            f"all_to_all: split dim {split_dim!r} must shrink by comm size {R}: "
            f"{in_space.get(split_dim)} -> {out_space[split_dim]}"
        )
    if in_space.get(concat_dim, -1) * R != out_space[concat_dim]:
        raise LayoutError(
            f"all_to_all: concat dim {concat_dim!r} must grow by comm size {R}: "
            f"{in_space.get(concat_dim)} -> {out_space[concat_dim]}"
        )
    expected[split_dim] = out_space[split_dim] * R
    expected[concat_dim] = out_space[concat_dim] // R
    check_same_space(in_space, expected, what="all_to_all")
    # one exchanged piece in a canonical dense layout (the endpoint
    # relayouts absorb any order): block j of split_dim goes to rank j, and
    # the piece from rank j becomes block j of concat_dim
    piece = _dense_layout(
        dist_bag.tile_layout.dtype,
        [(d, out_space[split_dim] if d == split_dim else in_space[d]) for d in in_space],
    )
    blk = _fresh_axis_name(piece, "__aa")
    send_l = _block_over(piece, split_dim, blk, R)
    recv_l = _block_over(piece, concat_dim, blk, R)
    stacked = relayout(dist_bag.data, dist_bag.tile_layout, send_l)
    landed, works = _issue_all_to_all_pieces(list(stacked.unbind(0)), [piece.shape] * R,
                                             dist_bag.dt, rank_dim)

    def finish():
        y = torch.stack(landed).reshape(recv_l.shape)
        return DistBag(relayout(y, recv_l, out_tile_layout), out_tile_layout, dist_bag.dt,
                       dist_bag.rank_dims)

    return Pending(finish, works, op="all_to_all")


def all_to_all_bag(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    split_dim: str,
    concat_dim: str,
    rank_dim: str | None = None,
) -> DistBag:
    """``MPI_Alltoall`` along the ``rank_dim`` communicator: each rank splits
    its tile into R blocks of ``split_dim``, sends block ``j`` to rank ``j``,
    and concatenates the received blocks (in rank order) along
    ``concat_dim``.  The layout-agnostic reshard primitive: a bag tiled
    along one logical dim becomes tiled along another, with both endpoint
    tile layouts chosen freely.  Checks first: ``split_dim`` shrinks by R,
    ``concat_dim`` grows by R, everything else matches."""
    return all_to_all_start(dist_bag, out_tile_layout, split_dim=split_dim,
                            concat_dim=concat_dim, rank_dim=rank_dim).wait()


def _gatherv_cat_dim(dist_bag: DistBag, pos: int, root_space: Mapping[str, int],
                     what: str) -> str:
    """The ragged dim whose extents the rank dim at grid position ``pos``
    tiles (per-sub-communicator counts): candidates from separability,
    disambiguated by the root-space sum and by unique ownership."""
    cands = _ragged_owner_candidates(dist_bag)
    matches = [d for d, ps in cands.items()
               if pos in ps and sum(_dim_extent_list(dist_bag, d, pos)) == root_space.get(d)]
    if len(matches) > 1:
        unique = [d for d in matches if cands[d] == [pos]]
        matches = unique or matches
    if len(matches) != 1:
        raise LayoutError(
            f"{what}: cannot identify the ragged dim tiled by rank dim "
            f"{dist_bag.rank_dims[pos]!r} (candidates: {sorted(matches)} of "
            f"ragged dims {sorted(cands)})"
        )
    return matches[0]


def all_gatherv_start(
    dist_bag: DistBag,
    root_layout: Layout,
    *,
    rank_dim: str | Sequence[str] | None = None,
) -> Pending:
    """Non-blocking ragged all-gather (``MPI_Iallgatherv``) along one rank
    dim: issue the transfer and return a :class:`Pending` whose
    :meth:`~Pending.wait` hands back a :class:`DistBag` in which every rank
    of the communicator holds the tiles' valid regions concatenated in rank
    order, in ``root_layout``.

    The padded capacity tiles cross the wire (one ``all_gather``); the
    static extents table, the same on every rank, gives the valid slices
    the receiver concatenates.  On a communicator grid the gather runs
    along the named rank dim (required unless the bag has one); the other
    grid dims act as independent sub-communicators, and dims they tile stay
    ragged at capacity in the result and keep their extents."""
    _require_homogeneous(dist_bag, "all_gatherv")
    rank_dims = _as_rank_dims(dist_bag.dt, rank_dim) if rank_dim is not None \
        else dist_bag.rank_dims
    for d in rank_dims:
        if d not in dist_bag.rank_dims:
            raise LayoutError(f"bag is not distributed over {d!r} (has {dist_bag.rank_dims})")
    if dist_bag.extents is None:
        raise LayoutError("all_gatherv: bag is dense (no extents); use all_gather_*")
    if len(rank_dims) != 1:
        raise LayoutError("all_gatherv gathers along one rank dim per call; name it "
                          f"explicitly on the grid {dist_bag.rank_dims}")
    (rd,) = rank_dims
    pos = dist_bag.rank_dims.index(rd)
    root_space = root_layout.index_space()
    cat_dim = _gatherv_cat_dim(dist_bag, pos, root_space, "all_gatherv")
    exts = _dim_extent_list(dist_bag, cat_dim, pos)
    # dims tiled by the other grid dims ride through at capacity; their
    # extents must not vary along ``rd``
    other_ragged = tuple(d for d in dist_bag.ragged_dims() if d != cat_dim)
    rest_ext = tuple(tuple(p for p in entry if p[0] != cat_dim) for entry in dist_bag.extents)
    if other_ragged:
        _uniform_extents_along(dataclasses.replace(dist_bag, extents=rest_ext), rd,
                               "all_gatherv (other ragged dims)")
    expected = dict(dist_bag.tile_layout.index_space())
    expected[cat_dim] = sum(exts)
    check_same_space(root_space, expected, what="all_gatherv(root, sum of tiles)")
    check_ragged_dims(dist_bag.tile_layout, dist_bag.tile_layout, (cat_dim,),
                      what="all_gatherv")
    check_ragged_dims(root_layout, root_layout, other_ragged, what="all_gatherv(out)")
    ax = dist_bag.tile_layout.axis_index(dist_bag.tile_layout.dim_axes(cat_dim)[0])
    full_l = dist_bag.tile_layout.resize_dim(cat_dim, sum(exts))
    group, members = dist_bag.dt.communicator((rd,))
    tile = dist_bag.data.contiguous()
    landed = torch.empty((len(members) * tile.numel(),), dtype=tile.dtype, device=tile.device)
    works = []
    if len(members) == 1:
        landed.copy_(tile.view(-1))
    else:  # flat buffers: the landed tiles in communicator order
        works.append(dist.all_gather_into_tensor(landed, tile.view(-1), group=group,
                                                 async_op=True))

    def finish():
        tiles = landed.view((len(members),) + tuple(tile.shape))
        full = torch.cat([tiles[r].narrow(ax, 0, e) for r, e in enumerate(exts)], dim=ax)
        return DistBag(relayout(full, full_l, root_layout), root_layout, dist_bag.dt,
                       dist_bag.rank_dims, extents=rest_ext if other_ragged else None)

    return Pending(finish, works, op="all_gatherv")


def all_gatherv_dist(
    dist_bag: DistBag,
    root_layout: Layout,
    *,
    rank_dim: str | Sequence[str] | None = None,
) -> DistBag:
    """Blocking ragged all-gather returning the per-rank receive buffers
    (``all_gatherv_start(...).wait()``)."""
    return all_gatherv_start(dist_bag, root_layout, rank_dim=rank_dim).wait()


def all_gatherv_bag(dist_bag: DistBag, root_layout: Layout) -> Bag:
    """``MPI_Allgatherv``: every rank ends with the full structure (the
    ragged tiles' valid regions concatenated in rank order) in
    ``root_layout``.  On a communicator grid this gathers along every rank
    dim in turn (one sub-communicator all-gather per grid dim, a
    dimension-ordered ``MPI_Allgatherv`` over a Cartesian communicator), so
    each grid dim must tile its own ragged dim."""
    root_space = root_layout.index_space()
    db = dist_bag
    for i, rd in enumerate(dist_bag.rank_dims):
        if i == len(dist_bag.rank_dims) - 1:
            target = root_layout
        else:
            cat_dim = _gatherv_cat_dim(db, db.rank_dims.index(rd), root_space, "all_gatherv")
            space = dict(db.tile_layout.index_space())
            space[cat_dim] = root_space[cat_dim]
            target = _dense_layout(root_layout.dtype, list(space.items()))
        db = all_gatherv_dist(db, target, rank_dim=rd)
    return Bag(db.data, root_layout)


def all_to_allv_start(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    split_dim: str,
    concat_dim: str,
    split_extents: Sequence[int],
    rank_dim: str | None = None,
) -> Pending:
    """Non-blocking ragged all-to-all (``MPI_Ialltoallv``): issue the
    reshard and return a :class:`Pending` immediately.

    The ragged transpose-reshard: a bag tiled raggedly along ``concat_dim``
    (its extents table) becomes tiled raggedly along ``split_dim``
    (``split_extents``, zeros allowed).  Rank ``r`` sends the
    ``(split_extents[j], my concat extent)`` valid sub-block to rank ``j``;
    the split sizes of the one ``all_to_all_single`` are those counts, so
    no padding crosses the wire.  The receiver places rank ``j``'s block at
    its concat displacement (the prefix sum of the extents) in a
    zero-padded ``split_dim`` capacity tile.  On a communicator grid the
    exchange runs along the named ``rank_dim`` sub-communicators; dims tiled
    by the other grid dims ride through at capacity and keep their
    extents."""
    _require_homogeneous(dist_bag, "all_to_allv")
    if split_dim == concat_dim:
        raise LayoutError("all_to_allv: split_dim and concat_dim must differ")
    rank_dim = _check_rank_dim(dist_bag, rank_dim)
    pos = dist_bag.rank_dims.index(rank_dim)
    R = dist_bag.dt.comm_size(rank_dim)
    split_extents = tuple(int(e) for e in split_extents)
    if len(split_extents) != R:
        raise LayoutError(f"all_to_allv: {len(split_extents)} split extents for comm size {R}")
    if min(split_extents) < 0:
        raise LayoutError(f"all_to_allv: negative split extents {split_extents}")
    if dist_bag.extents is None:
        raise LayoutError(
            "all_to_allv: input must be ragged along concat_dim (use all_to_all for dense)")
    cands = _ragged_owner_candidates(dist_bag)
    if concat_dim not in cands or pos not in cands[concat_dim]:
        raise LayoutError(
            f"all_to_allv: input must be ragged along {concat_dim!r} over "
            f"{rank_dim!r} (ragged dims: {sorted(cands)})"
        )
    if split_dim in cands:
        raise LayoutError(
            f"all_to_allv: split dim {split_dim!r} must be dense in the input "
            f"(ragged dims: {sorted(cands)})"
        )
    other_ragged = tuple(d for d in dist_bag.ragged_dims() if d != concat_dim)
    for d in other_ragged:
        if cands[d] == [pos]:
            raise LayoutError(
                f"all_to_allv: ragged dim {d!r} varies along {rank_dim!r}; only "
                f"{concat_dim!r} may (other ragged dims belong to other grid dims)"
            )
    concat_exts = _dim_extent_list(dist_bag, concat_dim, pos)
    in_space = dist_bag.tile_layout.index_space()
    out_space = out_tile_layout.index_space()
    X_total = sum(split_extents)
    if in_space.get(split_dim) != X_total:
        raise LayoutError(
            f"all_to_allv: split dim {split_dim!r} extent {in_space.get(split_dim)} "
            f"!= split extents sum {X_total}"
        )
    cap_s = out_space.get(split_dim)
    if cap_s is None or max(split_extents) > cap_s:
        raise LayoutError(
            f"all_to_allv: split extents {split_extents} exceed output capacity {cap_s}")
    C_total = sum(concat_exts)
    if out_space.get(concat_dim) != C_total:
        raise LayoutError(
            f"all_to_allv: concat dim {concat_dim!r} output extent "
            f"{out_space.get(concat_dim)} != concat extents sum {C_total}"
        )
    expected = {d: s for d, s in in_space.items() if d not in (split_dim, concat_dim)}
    expected[split_dim] = cap_s
    expected[concat_dim] = C_total
    check_same_space(out_space, expected, what="all_to_allv")
    check_ragged_dims(dist_bag.tile_layout, out_tile_layout,
                      (split_dim, concat_dim) + other_ragged, what="all_to_allv")
    rest = [(d, s) for d, s in in_space.items() if d not in (split_dim, concat_dim)]
    mid_in = _dense_layout(dist_bag.tile_layout.dtype,
                           rest + [(split_dim, X_total), (concat_dim, in_space[concat_dim])])
    mid_out = _dense_layout(out_tile_layout.dtype,
                            rest + [(split_dim, cap_s), (concat_dim, C_total)])
    me = dist_bag.dt.coord(rank_dim)
    x = relayout(dist_bag.data, dist_bag.tile_layout, mid_in)
    x = x.narrow(-1, 0, concat_exts[me])  # this rank's valid concat extent
    offs = _prefix_sums(split_extents)
    pieces = [x.narrow(-2, offs[j], split_extents[j]) for j in range(R)]
    lead = tuple(s for _, s in rest)
    landed, works = _issue_all_to_all_pieces(
        pieces, [lead + (split_extents[me], concat_exts[j]) for j in range(R)],
        dist_bag.dt, rank_dim)
    new_ext = []
    for coords in itertools.product(*(range(s) for s in dist_bag.grid_shape)):
        entry = [p for p in dist_bag.extents[dist_bag.flat_rank(coords)] if p[0] != concat_dim]
        entry.append((split_dim, split_extents[coords[pos]]))
        new_ext.append(tuple(entry))

    def finish():
        full = torch.zeros(mid_out.shape, dtype=x.dtype, device=x.device)
        full.narrow(-2, 0, split_extents[me]).copy_(torch.cat(landed, dim=-1))
        return DistBag(relayout(full, mid_out, out_tile_layout), out_tile_layout, dist_bag.dt,
                       dist_bag.rank_dims, extents=tuple(new_ext))

    return Pending(finish, works, op="all_to_allv")


def all_to_allv_bag(
    dist_bag: DistBag,
    out_tile_layout: Layout,
    *,
    split_dim: str,
    concat_dim: str,
    split_extents: Sequence[int],
    rank_dim: str | None = None,
) -> DistBag:
    """``MPI_Alltoallv``: reshard a bag tiled raggedly along ``concat_dim``
    into one tiled raggedly along ``split_dim`` (see
    :func:`all_to_allv_start`); blocking = ``all_to_allv_start(...).wait()``."""
    return all_to_allv_start(dist_bag, out_tile_layout, split_dim=split_dim,
                             concat_dim=concat_dim, split_extents=split_extents,
                             rank_dim=rank_dim).wait()


class _AllToAllvLeg(torch.autograd.Function):
    """The arrived tile of an ``MPI_Ialltoallv`` leg, tied to the tile that
    was sent: the forward passes the arrived data through; the backward
    sends its cotangent back along the reverse leg (split and concat dims
    swapped, the forward's concat extents as its split extents) and hands
    it to the sent tile."""

    @staticmethod
    def forward(ctx, meta, sent, arrived):
        ctx.meta = meta
        return arrived.view_as(arrived)

    @staticmethod
    def backward(ctx, d):
        (arrived_layout, dt, rank_dims, extents, sent_layout, split_dim, concat_dim,
         concat_exts, rank_dim) = ctx.meta
        back = all_to_allv_start(DistBag(d.contiguous(), arrived_layout, dt, rank_dims,
                                         extents=extents),
                                 sent_layout, split_dim=concat_dim, concat_dim=split_dim,
                                 split_extents=concat_exts, rank_dim=rank_dim).wait()
        return None, back.data, None


def all_to_allv_tie(sent: DistBag, arrived: DistBag, *, split_dim: str, concat_dim: str,
                    rank_dim: str | None = None) -> DistBag:
    """``arrived``, what ``all_to_allv_start(sent, ..., split_dim=,
    concat_dim=, rank_dim=)`` delivered, with its data differentiable with
    respect to ``sent.data``: the backward of a ragged all-to-all is the
    all-to-all of the cotangent along the reverse leg, with the same
    extents (the expert-parallel dispatch's backward is its combine leg, and
    the combine's its dispatch).  The forward's request was issued and
    waited as the caller's plan chose (double-buffered or blocking); the
    backward leg is blocking, issued where autograd reaches it, in one
    order on every rank (the same graph).  Without a gradient to take,
    ``arrived`` itself."""
    if not (torch.is_grad_enabled() and sent.data.requires_grad):
        return arrived
    rank_dim = _check_rank_dim(sent, rank_dim)
    pos = sent.rank_dims.index(rank_dim)
    meta = (arrived.tile_layout, arrived.dt, arrived.rank_dims, arrived.extents,
            sent.tile_layout, split_dim, concat_dim,
            tuple(_dim_extent_list(sent, concat_dim, pos)), rank_dim)
    data = _AllToAllvLeg.apply(meta, sent.data, arrived.data)
    return DistBag(data, arrived.tile_layout, arrived.dt, arrived.rank_dims,
                   extents=arrived.extents)


class _ReducedTie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, reduced):
        return reduced.view_as(reduced)

    @staticmethod
    def backward(ctx, d):
        return d, None


def all_reduce_tie(local: torch.Tensor, reduced: DistBag) -> DistBag:
    """``reduced``, the result of ``all_reduce_start`` over a bag whose
    data is ``local``, with its data differentiable with respect to
    ``local``: every rank goes on to use the same sum alike (a statistic
    over every rank's tokens), so each rank's cotangent of the sum is the
    whole one, and the backward hands it to ``local`` unchanged."""
    if not (torch.is_grad_enabled() and local.requires_grad):
        return reduced
    return DistBag(_ReducedTie.apply(local, reduced.data), reduced.tile_layout, reduced.dt,
                   reduced.rank_dims, extents=reduced.extents)


# -----------------------------------------------------------------------------
# per-rank compute
# -----------------------------------------------------------------------------
def rank_map(
    fn: Callable[..., Any],
    dt: DistTraverser,
    *dist_bags: DistBag,
    out_tile_layout: Layout | None = None,
    rank_dim: str | Sequence[str] | None = None,
    out_extents: tuple[tuple[tuple[str, int], ...], ...] | None = None,
) -> DistBag:
    """Run ``fn(rank, *tile_bags) -> tile_bag_or_tensor`` on this process's
    tiles.

    ``fn`` sees plain :class:`Bag` tiles in their declared layouts (paper
    Listing 5's ``modify(tile[state])``).  On a 1-D communicator ``rank`` is
    the integer rank; on a grid it is a state dict ``{rank_dim:
    coordinate}`` (the paper's ``MPI_Cart_coords``).  Input bags may live on
    different traversers (e.g. operands of a SUMMA step bound to different
    grid dims) as long as they share the mesh.

    ``out_extents`` (optional) attaches a per-rank valid-extents table to the
    result — per-rank compute on padded ragged tiles (``fn`` sees the full
    capacity buffers and is responsible for keeping the padding inert, e.g.
    zeros under add-reductions).
    """
    rank_dims = _as_rank_dims(dt, rank_dim)
    for db in dist_bags:
        if db.dt.mesh is not dt.mesh:
            raise LayoutError("rank_map: all bags must live on the same mesh")
    if len(rank_dims) == 1:
        rank: Any = dt.coord(rank_dims[0])
    else:
        rank = {d: dt.coord(d) for d in rank_dims}
    out = fn(rank, *[Bag(db.data.reshape(db.own_layout.shape), db.own_layout)
                     for db in dist_bags])
    out_arr = out.data if isinstance(out, Bag) else out
    out_layout = out_tile_layout or dist_bags[0].tile_layout
    return DistBag(out_arr.reshape(out_layout.shape), out_layout, dt, rank_dims,
                   extents=out_extents)


# -----------------------------------------------------------------------------
# shard-level forms (plain per-rank tensors along one mesh axis)
# -----------------------------------------------------------------------------
def _mesh_axis(mesh, axis_name: str) -> tuple[int, int, object, tuple[int, ...]]:
    """``(R, my coordinate, process group, member global ranks)`` of this
    process's communicator along ``axis_name``; creates the axis's groups
    on first use (collective: every rank reaches it at the same point)."""
    if axis_name not in mesh.shape:
        raise LayoutError(f"mesh has no axis {axis_name!r} (has {mesh.axis_names})")
    mesh.create_groups((axis_name,))
    return (mesh.shape[axis_name], mesh.coords()[axis_name], mesh.group((axis_name,)),
            mesh.members((axis_name,)))


def _shard_leaves(x) -> tuple[list[torch.Tensor], bool]:
    """``x``'s tensors and whether it was a tuple/list of them."""
    if isinstance(x, (tuple, list)):
        return list(x), True
    return [x], False


def _check_flat_extents(n: int, extents: Sequence[int], what: str) -> int:
    """Validate a flat recvcounts table against an ``R * cap`` buffer; returns
    the per-rank capacity."""
    R = len(extents)
    if R == 0 or n % R:
        raise LayoutError(f"{what}: flat size {n} must be R * cap for R={R} ranks")
    cap = n // R
    for r, e in enumerate(extents):
        if not 0 <= int(e) <= cap:
            raise LayoutError(f"{what}: extents[{r}]={e} outside [0, cap={cap}]")
    return cap


def shard_reduce_scatterv_start(x, axis_name: str, *, extents: Sequence[int], mesh) -> Pending:
    """Issue ``MPI_Ireduce_scatter`` (sum) of flat padded buffers over mesh
    axis ``axis_name``: each of ``x`` (a ``(R * cap,)`` tensor or a tuple of
    them) is summed over the axis's ranks and rank ``r`` receives its own
    ``(cap,)`` slice, of which the leading ``extents[r]`` elements are valid
    payload (the ``recvcounts`` table,
    :func:`repro_torch.models.sharding.ragged_grad_extents`).  The
    capacity-pad tail is zeros by construction
    (:func:`repro_torch.train.buckets.pack_bucket`), inert under the sum.
    ``x`` is not modified.  On an axis of one rank nothing moves and ``wait``
    gives ``x`` itself.  The ZeRO train step issues one per gradient bucket,
    every bucket in flight before any wait (:func:`repro_torch.core.plan.bucket`)."""
    leaves, is_seq = _shard_leaves(x)
    R, _, group, _ = _mesh_axis(mesh, axis_name)
    if len(extents) != R:
        raise LayoutError(f"shard_reduce_scatterv_start: {len(extents)} extents for an axis "
                          f"of {R} ranks")
    for t in leaves:
        if t.ndim != 1:
            raise LayoutError(f"shard_reduce_scatterv_start: a flat buffer is 1-D, got shape "
                              f"{tuple(t.shape)}")
        _check_flat_extents(t.shape[0], extents, "shard_reduce_scatterv_start")
    if R == 1:
        return Pending(lambda: x, op="reduce_scatterv")
    outs, works = [], []
    for t in leaves:
        out = torch.empty((t.shape[0] // R,), dtype=t.dtype, device=t.device)
        works.append(dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                                                group=group, async_op=True))
        outs.append(out)
    return Pending(lambda: type(x)(outs) if is_seq else outs[0], works, op="reduce_scatterv")


def shard_all_gatherv_start(x, axis_name: str, *, extents: Sequence[int], mesh) -> Pending:
    """Issue ``MPI_Iallgatherv`` of flat capacity shards over mesh axis
    ``axis_name``: every rank's ``(cap,)`` shard of ``x`` (a tensor or a
    tuple of them), concatenated in rank order into the whole ``(R * cap,)``
    buffer, of which rank ``r``'s slice carries ``extents[r]`` valid
    elements (counts; the displacements are the ``r * cap`` capacity
    offsets).  On an axis of one rank nothing moves and ``wait`` gives ``x``
    itself.  The ZeRO train step's return leg: each updated parameter
    shard is regathered for the next forward."""
    leaves, is_seq = _shard_leaves(x)
    R, _, group, _ = _mesh_axis(mesh, axis_name)
    if len(extents) != R:
        raise LayoutError(f"shard_all_gatherv_start: {len(extents)} extents for an axis of "
                          f"{R} ranks")
    for t in leaves:
        if t.ndim != 1:
            raise LayoutError(f"shard_all_gatherv_start: a capacity shard is 1-D, got shape "
                              f"{tuple(t.shape)}")
        _check_flat_extents(t.shape[0] * R, extents, "shard_all_gatherv_start")
    if R == 1:
        return Pending(lambda: x, op="all_gatherv")
    outs, works = [], []
    for t in leaves:
        out = torch.empty((R * t.shape[0],), dtype=t.dtype, device=t.device)
        works.append(dist.all_gather_into_tensor(out, t.contiguous(), group=group,
                                                 async_op=True))
        outs.append(out)
    return Pending(lambda: type(x)(outs) if is_seq else outs[0], works, op="all_gatherv")
