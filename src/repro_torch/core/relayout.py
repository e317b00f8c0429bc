"""Layout-agnostic relayout: the analogue of the paper's MPI-datatype engine.

The paper (§3) derives MPI datatypes from Noarr structures so that a transfer
between two ranks holding *different physical layouts* of the same logical
structure performs the layout transformation inside the transfer.  The tensor equivalent is a minimal
``reshape -> permute -> reshape`` program derived from the two layouts; the
collectives run it on the send side (pack) or the receive side (unpack) of
each ``torch.distributed`` transfer.

The plan construction mirrors the paper's datatype classification (§3.1):

* identity permutation                -> "contiguous"  (MPI_Type_contiguous)
* pure axis permutation, no splits    -> "hvector"     (strided copies)
* refinement splits needed            -> "hindexed"    (blocked gather)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .dims import LayoutError, check_same_space, common_refinement
from .layout import Layout

__all__ = ["RelayoutPlan", "relayout_plan", "relayout", "transfer_kind", "check_ragged_dims"]


def check_ragged_dims(src: Layout, dst: Layout, dims, *, what: str = "relayout") -> None:
    """Ragged-padding safety check for transfers of padded capacity tiles.

    A padded ragged tile keeps its valid region a *leading* hyper-rectangle
    through a relayout only if every ragged dim maps to a single physical
    axis on both sides: axis permutations preserve leading rectangles, while
    blocking a ragged dim would interleave padding with valid elements (the
    analogue of an MPI datatype that strides *through* the v-collective's
    displacement gaps).  Raises :class:`LayoutError` before any data moves.
    """
    for d in dims:
        for side, layout in (("source", src), ("destination", dst)):
            axs = layout.dim_axes(d)
            if len(axs) != 1:
                raise LayoutError(
                    f"{what}: ragged dim {d!r} is blocked over axes {axs} in the "
                    f"{side} layout; ragged dims must map to a single physical axis"
                )


@dataclasses.dataclass(frozen=True)
class RelayoutPlan:
    """A concrete reshape/transpose/reshape program between two layouts.

    When the two blockings admit no common refinement (e.g. block size 3 vs
    block size 2 over the same dim), ``gather_perm`` holds an explicit element
    permutation — the analogue of MPI_Type_create_hindexed, which can express
    arbitrary displacement lists."""

    src_shape: tuple[int, ...]
    refined_shape: tuple[int, ...]  # src reshaped into the common refinement
    perm: tuple[int, ...]  # transpose on the refined axes
    dst_shape: tuple[int, ...]
    kind: str  # 'contiguous' | 'hvector' | 'hindexed' | 'hindexed-gather'
    gather_perm: Any = None  # np.ndarray of flat src offsets, in dst order

    @property
    def is_noop(self) -> bool:
        return self.kind == "contiguous"

    def apply(self, arr: torch.Tensor) -> torch.Tensor:
        """Run the plan on a tensor holding ``src`` data; the result is a
        contiguous tensor in ``dst`` physical order (a view when no data
        has to move)."""
        if tuple(arr.shape) != self.src_shape:
            raise LayoutError(f"relayout: array shape {tuple(arr.shape)} != layout shape {self.src_shape}")
        if self.is_noop:
            return arr.reshape(self.dst_shape)
        if self.gather_perm is not None:
            index = torch.as_tensor(self.gather_perm, device=arr.device)
            return arr.reshape(-1)[index].reshape(self.dst_shape)
        out = arr.reshape(self.refined_shape)
        # torch's ``transpose`` swaps two dims; ``permute`` is numpy's transpose
        out = out.permute(self.perm).contiguous()
        return out.reshape(self.dst_shape)

    def describe(self) -> str:
        if self.gather_perm is not None:
            return f"RelayoutPlan[{self.kind}] {self.src_shape} -> gather({len(self.gather_perm)}) -> {self.dst_shape}"
        return (
            f"RelayoutPlan[{self.kind}] {self.src_shape} -> reshape{self.refined_shape} "
            f"-> transpose{self.perm} -> reshape{self.dst_shape}"
        )


def _refined_labels(layout: Layout, refinement: dict[str, list[int]]) -> tuple[list[Any], list[int]]:
    """Per-physical-axis expansion of ``layout`` into refined sub-axes.

    Returns (labels, sizes) where each label is ``(dim, k)`` identifying the
    k-th refined segment of logical dim ``dim`` — the shared vocabulary that
    lets us line up source and destination orderings.
    """
    # For each dim, refined segments outer..inner; each physical axis of the
    # dim covers a contiguous run of those segments.
    labels: list[Any] = []
    sizes: list[int] = []
    # position cursor per dim
    cursor: dict[str, int] = {d: 0 for d, _ in layout.dim_map}
    axis_dim = {ax: d for d, axs in layout.dim_map for ax in axs}
    for axis in layout.axes:
        d = axis_dim[axis.name]
        segs = refinement[d]
        covered = 1
        start = cursor[d]
        k = start
        while covered < axis.size:
            covered *= segs[k]
            k += 1
        if covered != axis.size and axis.size != 1:
            raise LayoutError(
                f"internal: refinement {segs} does not align with axis {axis} of dim {d!r}"
            )
        if axis.size == 1 and covered != 1:
            k = start  # size-1 axis covers no refined segment
        for j in range(start, k):
            labels.append((d, j))
            sizes.append(segs[j])
        cursor[d] = k
    return labels, sizes


def relayout_plan(src: Layout, dst: Layout) -> RelayoutPlan:
    """Derive the transformation program taking ``src``-laid data to ``dst``.

    Type safety (paper §3.2/§4.2): raises :class:`LayoutError` unless the two
    layouts span the same logical index space, *before* any data moves.
    """
    src._require_resolved()
    dst._require_resolved()
    check_same_space(src.index_space(), dst.index_space(), what="relayout")
    if src.dtype != dst.dtype:
        raise LayoutError(f"relayout: dtype mismatch {src.dtype} vs {dst.dtype}")

    try:
        refinement = {
            d: common_refinement(src.dim_radices(d), dst.dim_radices(d)) for d in src.index_space()
        }
    except LayoutError:
        return _gather_plan(src, dst)
    src_labels, src_sizes = _refined_labels(src, refinement)
    dst_labels, dst_sizes = _refined_labels(dst, refinement)
    if sorted(map(repr, src_labels)) != sorted(map(repr, dst_labels)):
        raise LayoutError("internal: refined label sets differ")  # pragma: no cover
    pos = {lab: i for i, lab in enumerate(src_labels)}
    perm = tuple(pos[lab] for lab in dst_labels)

    splits_needed = len(src_labels) != len(src.axes) or len(dst_labels) != len(dst.axes)
    if perm == tuple(range(len(perm))):
        kind = "contiguous"
    elif not splits_needed:
        kind = "hvector"
    else:
        kind = "hindexed"
    return RelayoutPlan(
        src_shape=src.shape,
        refined_shape=tuple(src_sizes),
        perm=perm,
        dst_shape=dst.shape,
        kind=kind,
    )


def _gather_plan(src: Layout, dst: Layout) -> RelayoutPlan:
    """Arbitrary-displacement fallback (MPI_Type_create_hindexed analogue).

    Builds, with host numpy when the plan is made, the flat source offset of every
    element in destination physical order.  O(elements) host work — only used
    when no reshape/transpose program exists; the framework layouts are
    designed so the hot paths never take this branch.
    """
    import numpy as np

    coords = np.indices(dst.shape)
    # dst physical coords -> logical state (vectorized mixed-radix join per dim)
    from .dims import mixed_radix_join

    state = {}
    for d, axs in dst.dim_map:
        radices = dst.dim_radices(d)
        parts = [coords[dst.axis_index(ax)] for ax in axs]
        state[d] = mixed_radix_join(parts, radices)
    phys = src.physical_index(state)
    flat_src = np.ravel_multi_index(phys, src.shape).reshape(-1)
    return RelayoutPlan(
        src_shape=src.shape,
        refined_shape=src.shape,
        perm=tuple(range(len(src.shape))),
        dst_shape=dst.shape,
        kind="hindexed-gather",
        gather_perm=flat_src,
    )


def relayout(arr, src: Layout, dst: Layout):
    """Move data from ``src`` layout to ``dst`` layout (same logical space)."""
    return relayout_plan(src, dst).apply(arr)


def transfer_kind(src: Layout, dst: Layout) -> str:
    """Which MPI datatype family the transfer would need (paper §3.1)."""
    return relayout_plan(src, dst).kind
