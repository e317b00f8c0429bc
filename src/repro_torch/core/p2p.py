"""Layout-agnostic point-to-point communication (paper §4.3).

Send/recv is the most-used MPI feature; its layout-agnostic form says: the
source rank holds a tile in one layout, the destination declares a possibly
*different* layout, and the relayout plan — derived from the two layouts,
exactly like the MPI-datatype construction of ``collectives`` — packs the
tile on the send side of the transfer.

All operations work along one ranking dim of a (possibly multi-dim) grid
communicator; the other grid dims act as independent sub-communicators, each
a ``torch.distributed`` process group.  Transfers go through
``torch.distributed.batch_isend_irecv``; a pair whose source is the receiver
itself is a local copy, never a send to self.

Non-blocking transfers
----------------------
Real MPI GEMMs hide the ring exchange behind the local multiply with
``MPI_Isend``/``MPI_Irecv``; the analogue here is the ``*_start`` family,
which *issues* the transfer and hands back a
:class:`repro_torch.core.request.Pending` whose
:meth:`~repro_torch.core.request.Pending.wait` is the completion point.

=============================  ================================================
MPI                            repro_torch.core
=============================  ================================================
``MPI_Send`` / ``MPI_Recv``    :func:`send_recv`
``MPI_Sendrecv`` ring          :func:`ring_shift` / :func:`permute`
``MPI_Isend``/``Irecv``        :func:`ring_shift_start` / :func:`permute_start`
``MPI_Wait`` / ``MPI_Waitall`` :func:`wait` over one or more pending requests
=============================  ================================================

Shard-level forms
-----------------
The model stack works on plain per-rank tensors, not bags: the
sequence-parallel ring attention rotates its KV block along the ``model``
axis of a :class:`~repro_torch.core.dist.Mesh`.  :func:`shard_ring_shift`,
:func:`shard_ring_shift_start`, :func:`shard_all_gather_start`,
:func:`shard_all_reduce_start` and :func:`shard_reduce_scatter_start` take a
tensor or a tuple of tensors and one named mesh axis; the axis's process
group is the communicator.  On an axis
of one rank they move nothing.  The tensor-parallel decode step issues one
:func:`shard_all_reduce_start` (``MPI_Iallreduce``) per microbatch and block
stage, and completes it behind the next microbatch's compute.

Ragged bags move at their padded *capacity* (the uniform wire datatype); the
per-rank valid extents ride the request object's result bag, and a transfer
hands the receiver the sender's counts — ``ring_shift`` on a ragged bag
rotates the extents table together with the tiles.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from .collectives import DistBag
from .collectives import _mesh_axis as _axis
from .collectives import _require_homogeneous
from .collectives import _shard_leaves as _leaves
from .dims import LayoutError, check_same_space
from .layout import Layout
from .relayout import check_ragged_dims, relayout
from .request import Pending, wait_all

__all__ = [
    "permute",
    "ring_shift",
    "permute_start",
    "ring_shift_start",
    "send_recv",
    "shard_ring_shift",
    "shard_ring_shift_start",
    "shard_all_gather_start",
    "shard_all_reduce_start",
    "shard_reduce_scatter_start",
    "wait",
]


def _along(dist_bag: DistBag, rank_dim: str | None) -> tuple[str, int]:
    rank_dim = rank_dim or dist_bag.rank_dims[0]
    if rank_dim not in dist_bag.rank_dims:
        raise LayoutError(f"bag is not distributed over {rank_dim!r} (has {dist_bag.rank_dims})")
    return rank_dim, dist_bag.dt.comm_size(rank_dim)


def _check_perm(perm: Sequence[tuple[int, int]], R: int) -> list[tuple[int, int]]:
    pairs = [(int(s), int(d)) for s, d in perm]
    for s, d in pairs:
        if not (0 <= s < R and 0 <= d < R):
            raise LayoutError(f"permute pair ({s}, {d}) out of range for comm size {R}")
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise LayoutError(f"permute pairs must have unique sources and destinations: {pairs}")
    return pairs


def _dst_layout(dist_bag: DistBag, dst_tile_layout: Layout | None) -> Layout:
    dst = dst_tile_layout or dist_bag.tile_layout
    check_same_space(
        dist_bag.tile_layout.index_space(), dst.index_space(), what="p2p endpoints"
    )
    if dist_bag.is_ragged:
        # the padded capacity tile is the wire datatype: the valid region
        # survives the endpoint relayout only as a leading rectangle
        check_ragged_dims(dist_bag.tile_layout, dst, dist_bag.ragged_dims(), what="p2p endpoints")
    return dst


def _moved_extents(dist_bag: DistBag, rank_dim: str, pairs: Sequence[tuple[int, int]], *,
                   keep_bystanders: bool):
    """Extents table after tiles move along ``rank_dim`` per ``pairs``.

    The receiving rank adopts the *source's* extents (the counts travel with
    the tile, exactly like an MPI_Recv with the sender's count); ranks no
    pair sends to either keep their own (``send_recv`` bystanders) or drop
    to zero-extent (``permute``'s zero tiles).
    """
    if dist_bag.extents is None:
        return None
    pos = dist_bag.rank_dims.index(rank_dim)
    recv = {d: s for s, d in pairs}
    new = []
    for coords in itertools.product(*(range(s) for s in dist_bag.grid_shape)):
        c = coords[pos]
        if c in recv:
            src_coords = list(coords)
            src_coords[pos] = recv[c]
            new.append(dist_bag.extents[dist_bag.flat_rank(tuple(src_coords))])
        elif keep_bystanders:
            new.append(dist_bag.extents[dist_bag.flat_rank(coords)])
        else:
            new.append(tuple((d, 0) for d, _ in dist_bag.extents[dist_bag.flat_rank(coords)]))
    return tuple(new)


def permute_start(
    dist_bag: DistBag,
    perm: Iterable[tuple[int, int]],
    *,
    rank_dim: str | None = None,
    dst_tile_layout: Layout | None = None,
) -> Pending:
    """Non-blocking :func:`permute`: issue the transfer and return a
    :class:`Pending` immediately (``MPI_Isend``/``MPI_Irecv``)."""
    _require_homogeneous(dist_bag, "permute")
    rank_dim, R = _along(dist_bag, rank_dim)
    pairs = _check_perm(list(perm), R)
    dst = _dst_layout(dist_bag, dst_tile_layout)
    group, members = dist_bag.dt.communicator((rank_dim,))
    me = dist_bag.dt.coord(rank_dim)
    # the send datatype: pack into the receiver's declared layout
    packed = relayout(dist_bag.data, dist_bag.tile_layout, dst).contiguous()
    ops = []
    recv_from = [s for s, d in pairs if d == me]
    if not recv_from:
        landed = torch.zeros_like(packed)
    elif recv_from[0] == me:
        landed = packed.clone()
    else:
        landed = torch.empty_like(packed)
        ops.append(dist.P2POp(dist.irecv, landed, members[recv_from[0]], group))
    for s, d in pairs:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, packed, members[d], group))
    works = dist.batch_isend_irecv(ops) if ops else []
    extents = _moved_extents(dist_bag, rank_dim, pairs, keep_bystanders=False)

    def finish():
        return dataclasses.replace(dist_bag, data=landed, tile_layout=dst, extents=extents)

    return Pending(finish, works, op="permute")


def permute(
    dist_bag: DistBag,
    perm: Iterable[tuple[int, int]],
    *,
    rank_dim: str | None = None,
    dst_tile_layout: Layout | None = None,
) -> DistBag:
    """Exchange tiles along ``rank_dim`` per the ``(src, dst)`` pairs.

    Every pair is a matched send/recv; the endpoint layouts may differ
    (``dst_tile_layout``) and the relayout packs the tile before the
    transfer.  Ranks that no pair sends to receive a zero tile — the analogue
    of posting no matching ``MPI_Recv``.
    """
    return permute_start(dist_bag, perm, rank_dim=rank_dim, dst_tile_layout=dst_tile_layout).wait()


def ring_shift_start(
    dist_bag: DistBag,
    shift: int = 1,
    *,
    rank_dim: str | None = None,
    dst_tile_layout: Layout | None = None,
) -> Pending:
    """Non-blocking :func:`ring_shift`: the double-buffered SUMMA issues this
    *before* the local GEMM of the step and waits after, so step ``k``'s panel
    rotation overlaps step ``k``'s multiply."""
    _, R = _along(dist_bag, rank_dim)
    pairs = [(i, (i + shift) % R) for i in range(R)]
    return permute_start(dist_bag, pairs, rank_dim=rank_dim, dst_tile_layout=dst_tile_layout)


def ring_shift(
    dist_bag: DistBag,
    shift: int = 1,
    *,
    rank_dim: str | None = None,
    dst_tile_layout: Layout | None = None,
) -> DistBag:
    """Rotate tiles along the ``rank_dim`` ring: rank ``r`` receives the tile
    of rank ``r - shift`` (mod R) — MPI_Sendrecv in the classic ring pattern,
    and the panel-rotation step of Cannon/SUMMA GEMMs."""
    return ring_shift_start(dist_bag, shift, rank_dim=rank_dim,
                            dst_tile_layout=dst_tile_layout).wait()


def send_recv(
    dist_bag: DistBag,
    *,
    src: int,
    dst: int,
    rank_dim: str | None = None,
    dst_tile_layout: Layout | None = None,
) -> DistBag:
    """One matched send/recv pair along ``rank_dim`` (``MPI_Send`` /
    ``MPI_Recv``): rank ``dst`` receives rank ``src``'s tile, every other
    rank keeps its own.

    ``dst_tile_layout`` is the receiver's declared datatype: it is the
    *wire* layout of the transfer, and the sender packs into it
    (``relayout``) before the send.  The receiver *keeps* that layout: its
    buffer holds the received bytes in the homogeneous slot shape (the same
    element count), and the result records the layout in
    ``tile_layouts[dst]`` (only when it differs from the tile layout), so
    ``out.tile(dst)`` is the received tile in the receiver's own datatype
    with no unpack.  Ranks other than ``dst`` posted no matching receive:
    their tiles pass through untouched, bit for bit, in the source layout.
    On a ragged bag the receiver adopts ``src``'s extents; a bag that
    already carries ``tile_layouts`` is refused.  The transfer is one
    ``dist.send``/``dist.recv`` on the ``rank_dim`` communicator, and
    ``src == dst`` is a local relayout."""
    rank_dim, R = _along(dist_bag, rank_dim)
    _check_perm([(src, dst)], R)
    if dist_bag.tile_layouts is not None:
        raise LayoutError(
            "send_recv: bag already carries per-rank heterogeneous layouts; "
            "relayout to a homogeneous bag first"
        )
    wire = _dst_layout(dist_bag, dst_tile_layout)
    group, members = dist_bag.dt.communicator((rank_dim,))
    me = dist_bag.dt.coord(rank_dim)
    data = dist_bag.data
    slot = dist_bag.tile_layout.shape
    if me == src:
        packed = relayout(data, dist_bag.tile_layout, wire).contiguous()
        if dst == src:
            data = packed.reshape(slot)
        else:
            dist.send(packed, members[dst], group=group)
    elif me == dst:
        landed = torch.empty(wire.shape, dtype=data.dtype, device=data.device)
        dist.recv(landed, members[src], group=group)
        data = landed.reshape(slot)
    out = dataclasses.replace(dist_bag, data=data)
    if wire is not dist_bag.tile_layout and wire != dist_bag.tile_layout:
        pos = out.rank_dims.index(rank_dim)
        out = dataclasses.replace(out, tile_layouts=tuple(
            wire if coords[pos] == dst else dist_bag.tile_layout
            for coords in itertools.product(*(range(s) for s in out.grid_shape))))
    if dist_bag.is_ragged:
        out = dataclasses.replace(out, extents=_moved_extents(dist_bag, rank_dim, [(src, dst)],
                                                              keep_bystanders=True))
    return out


def wait(*pending: Pending):
    """Complete one or more pending transfers (``MPI_Wait`` / ``MPI_Waitall``).

    Returns the received :class:`DistBag` for a single request, a tuple of
    them for several.
    """
    return wait_all(*pending)


# -----------------------------------------------------------------------------
# shard-level forms (plain per-rank tensors along one mesh axis)
# -----------------------------------------------------------------------------


def shard_ring_shift_start(x, axis_name: str, shift: int = 1, *, mesh) -> Pending:
    """Issue the rotation of ``x`` (a tensor or a tuple of them) one ring
    step along mesh axis ``axis_name``: rank ``r`` receives rank
    ``r - shift``'s value (mod R).  Returns a :class:`Pending` whose
    ``wait`` gives the received value, in ``x``'s structure.  The
    double-buffered ring attention issues this before a step's local
    attention and waits after it, like the SUMMA ring's panel rotation.
    When grad mode is on and a tensor of ``x`` requires grad, the received
    value is differentiable: its backward shifts the cotangent the other way
    around the ring (training through the ring)."""
    leaves, is_seq = _leaves(x)
    R, me, group, members = _axis(mesh, axis_name)
    if shift % R == 0:
        return Pending(lambda: x, op="ring_shift")
    dst, src = members[(me + shift) % R], members[(me - shift) % R]
    linked = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    sent = [t.contiguous() for t in leaves]
    landed = [torch.empty_like(t) for t in sent]
    ops = []
    for t, buf in zip(sent, landed):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    works = dist.batch_isend_irecv(ops)

    def finish():
        out = landed
        if linked:  # the cotangents go back the other way around the ring
            out = list(_ShiftGrad.apply((axis_name, shift, mesh), landed, *leaves))
        sent.clear()  # the sends are complete: their buffers may go
        return type(x)(out) if is_seq else out[0]

    return Pending(finish, works, op="ring_shift")


class _ShiftGrad(torch.autograd.Function):
    """The gradient of a ring shift: links the landed tensors to the sent
    ones, and in the backward shifts the landed tensors' cotangents back by
    ``-shift`` (rank ``r``'s cotangent goes to the rank it received from).
    Every rank of the axis runs the same backward, so the sends match."""

    @staticmethod
    def forward(ctx, meta, landed, *sent):
        ctx.meta = meta
        return tuple(landed)

    @staticmethod
    def backward(ctx, *d_landed):
        axis_name, shift, mesh = ctx.meta
        d_sent = shard_ring_shift_start(tuple(d.contiguous() for d in d_landed), axis_name,
                                        -shift, mesh=mesh).wait()
        return (None, None, *d_sent)


def shard_ring_shift(x, axis_name: str, shift: int = 1, *, mesh):
    """Blocking :func:`shard_ring_shift_start`: rank ``r`` receives rank
    ``r - shift``'s ``x`` along mesh axis ``axis_name``."""
    return shard_ring_shift_start(x, axis_name, shift, mesh=mesh).wait()


def shard_all_gather_start(x, axis_name: str, *, mesh, axis: int = 0) -> Pending:
    """Issue ``MPI_Iallgather`` of ``x`` (a tensor or a tuple of them) along
    mesh axis ``axis_name``: every rank's value in rank order, concatenated
    along ``axis`` (the reference's ``tiled=True``).  Every rank must hand
    in the same shape."""
    leaves, is_seq = _leaves(x)
    R, _, group, _ = _axis(mesh, axis_name)
    flats, works = [], []
    for t in leaves:
        t = t.contiguous()
        flat = torch.empty((R * t.numel(),), dtype=t.dtype, device=t.device)
        if R == 1:
            flat.copy_(t.reshape(-1))
        else:  # gloo gathers flat buffers only
            works.append(dist.all_gather_into_tensor(flat, t.reshape(-1), group=group,
                                                     async_op=True))
        flats.append((flat, t.shape))

    def finish():
        out = []
        for flat, shape in flats:
            # rank blocks in rank order along ``axis``: a view for axis 0,
            # else one copy
            blocks = flat.reshape(R, *shape).movedim(0, axis)
            out.append(blocks.reshape(*shape[:axis], R * shape[axis], *shape[axis + 1:]))
        return type(x)(out) if is_seq else out[0]

    return Pending(finish, works, op="all_gather")


def shard_all_reduce_start(x, axis_name: str, *, mesh, op: str = "sum") -> Pending:
    """Issue ``MPI_Iallreduce`` (``op``: ``"sum"`` or ``"max"``) of ``x`` (a
    tensor or a tuple of them) over mesh axis ``axis_name`` and return a
    :class:`Pending` whose ``wait`` gives the reductions, in ``x``'s
    structure.  ``x`` is not modified:
    the reduction runs in a copy.  On an axis of one rank nothing moves and
    ``wait`` gives ``x`` itself.  On NCCL, ``wait`` orders the current
    stream after the reduction (no host sync)."""
    leaves, is_seq = _leaves(x)
    R, _, group, _ = _axis(mesh, axis_name)
    if R == 1:
        return Pending(lambda: x, op="all_reduce")
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    bufs = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
    works = [dist.all_reduce(b, op=rop, group=group, async_op=True) for b in bufs]
    return Pending(lambda: type(x)(bufs) if is_seq else bufs[0], works, op="all_reduce")


def shard_reduce_scatter_start(x, axis_name: str, *, mesh, axis: int = 0) -> Pending:
    """Issue ``MPI_Ireduce_scatter`` (sum) of ``x`` (a tensor or a tuple of
    them) over mesh axis ``axis_name``: the per-rank partials are summed and
    rank ``r`` receives block ``r`` of the sum along ``axis`` (the
    reference's ``tiled=True``); ``x``'s size along ``axis`` must divide
    into the axis's R ranks.  ``x`` is not modified.  On an axis of one rank
    nothing moves and ``wait`` gives ``x`` itself."""
    leaves, is_seq = _leaves(x)
    R, _, group, _ = _axis(mesh, axis_name)
    for t in leaves:
        if t.shape[axis] % R:
            raise LayoutError(f"shard_reduce_scatter_start: dim {axis} of {tuple(t.shape)} "
                              f"does not split over {R} ranks")
    if R == 1:
        return Pending(lambda: x, op="reduce_scatter")
    outs, works = [], []
    for t in leaves:
        moved = t.movedim(axis, 0).contiguous()  # block r is a contiguous run
        out = torch.empty((moved.shape[0] // R,) + tuple(moved.shape[1:]), dtype=t.dtype,
                          device=t.device)
        works.append(dist.reduce_scatter_tensor(out.view(-1), moved.view(-1),
                                                op=dist.ReduceOp.SUM, group=group,
                                                async_op=True))
        outs.append(out)

    def finish():
        out = [o.movedim(0, axis) for o in outs]
        return type(x)(out) if is_seq else out[0]

    return Pending(finish, works, op="reduce_scatter")
