"""Noarr-style layout structures for PyTorch tensors.

A :class:`Layout` is the analogue of a Noarr *structure*: a mapping
from a logical index space with **named dimensions** to physical memory.  For
an ndarray backend the physical side is the axis order of the backing array
(axis 0 is outermost / slowest-varying, matching a contiguous tensor's
row-major order) plus an optional *blocking* of logical dims into several physical
axes.

Layouts are assembled compositionally from *proto-structures* combined with
the ``^`` operator, mirroring the paper's syntax::

    matrix = scalar(np.float32) ^ vector("i", N) ^ vector("j", M)   # col-major
    matrix_rm = scalar(np.float32) ^ vector("j", M) ^ vector("i", N)  # row-major
    tiled = matrix ^ into_blocks("i", "I", 16) ^ into_blocks("j", "J", 16)

The later-applied proto-structure is the *outer* one, exactly as in Noarr
(``scalar<int>() ^ vector<'i'>(N) ^ vector<'j'>(M)`` puts ``j`` outermost,
i.e. column-major when ``i`` indexes rows).

Type safety: every transformation validates dimension names and extents at
Python time, raising :class:`LayoutError` before any tensor is touched — the
analogue of Noarr's signature-based compile-time checks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .dims import LayoutError, mixed_radix_split, prod

__all__ = [
    "Axis",
    "Layout",
    "ProtoStructure",
    "scalar",
    "vector",
    "vectors",
    "vectors_like",
    "into_blocks",
    "merge_blocks",
    "hoist",
    "reorder",
    "rename",
    "set_length",
    "fix_dim",
    "torch_dtype",
    "layout_dtype",
    "BFLOAT16",
]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One physical ndarray axis. ``size=None`` means *open* (deduced later,
    e.g. from the communicator size — paper §4.1)."""

    name: str
    size: int | None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name}:{self.size if self.size is not None else '?'}"


def _dedup_check(names: Sequence[str], what: str) -> None:
    if len(set(names)) != len(names):
        raise LayoutError(f"duplicate {what}: {list(names)}")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Logical named index space -> physical ndarray axes.

    Attributes:
      dtype:   element dtype (the Noarr ``scalar<T>`` base).
      axes:    physical axes, in ndarray order (axes[0] outermost).
      dim_map: ordered mapping ``logical dim -> tuple(axis names, outer..inner)``.
               A logical dim spanning k>1 axes is *blocked*; its index
               decomposes mixed-radix over the axis sizes.
    """

    dtype: Any
    axes: tuple[Axis, ...] = ()
    dim_map: tuple[tuple[str, tuple[str, ...]], ...] = ()

    # -- construction helpers -------------------------------------------------
    def __post_init__(self):
        axis_names = [a.name for a in self.axes]
        _dedup_check(axis_names, "physical axis names")
        mapped = [ax for _, axs in self.dim_map for ax in axs]
        _dedup_check(mapped, "mapped axis names")
        dim_names = [d for d, _ in self.dim_map]
        _dedup_check(dim_names, "logical dim names")
        missing = set(mapped) - set(axis_names)
        if missing:
            raise LayoutError(f"dim_map references unknown axes: {sorted(missing)}")
        unmapped = set(axis_names) - set(mapped)
        if unmapped:
            raise LayoutError(f"physical axes not covered by dim_map: {sorted(unmapped)}")

    def __xor__(self, proto: "ProtoStructure") -> "Layout":
        return proto.apply(self)

    # -- queries ---------------------------------------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        self._require_resolved()
        return tuple(a.size for a in self.axes)  # type: ignore[misc]

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def dims(self) -> tuple[str, ...]:
        return tuple(d for d, _ in self.dim_map)

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise LayoutError(f"no physical axis {name!r} in {self}")

    def axis_index(self, name: str) -> int:
        for i, a in enumerate(self.axes):
            if a.name == name:
                return i
        raise LayoutError(f"no physical axis {name!r} in {self}")

    def dim_axes(self, dim: str) -> tuple[str, ...]:
        for d, axs in self.dim_map:
            if d == dim:
                return axs
        raise LayoutError(f"no logical dim {dim!r} in {self} (dims: {self.dims})")

    def dim_radices(self, dim: str) -> tuple[int, ...]:
        return tuple(self.axis(ax).size for ax in self.dim_axes(dim))  # type: ignore[misc]

    def dim_size(self, dim: str) -> int:
        return prod(self.dim_radices(dim))

    def index_space(self) -> dict[str, int]:
        """The logical index space (the layout-agnostic 'signature' extents)."""
        self._require_resolved()
        return {d: self.dim_size(d) for d, _ in self.dim_map}

    def resize_dim(self, dim: str, size: int) -> "Layout":
        """This layout with logical dim ``dim`` resized to ``size``.

        Ragged tiles use this to view the *valid* leading sub-extent of a
        padded capacity axis (MPI_Scatterv counts vs the padded buffer).  The
        dim must map to a single physical axis: a blocked dim would interleave
        padding with valid elements, which is exactly what ragged layouts
        forbid (see :func:`repro_torch.core.relayout.check_ragged_dims`).
        """
        axs = self.dim_axes(dim)
        if len(axs) != 1:
            raise LayoutError(
                f"resize_dim({dim!r}): dim is blocked over axes {axs}; "
                "ragged dims must map to a single physical axis"
            )
        (ax,) = axs
        axes = tuple(Axis(a.name, size if a.name == ax else a.size) for a in self.axes)
        return Layout(self.dtype, axes, self.dim_map)

    def is_resolved(self) -> bool:
        return all(a.size is not None for a in self.axes)

    def _require_resolved(self) -> None:
        if not self.is_resolved():
            open_axes = [a.name for a in self.axes if a.size is None]
            raise LayoutError(
                f"layout has open (unsized) axes {open_axes}; use set_length or "
                "bind to a DistTraverser to deduce them"
            )

    # -- signature / traversal order -------------------------------------------
    def default_order(self) -> tuple[str, ...]:
        """Default traversal order of *logical dims*: by the position of each
        dim's outermost physical axis (the Noarr signature order)."""
        pos = {d: self.axis_index(axs[0]) for d, axs in self.dim_map}
        return tuple(sorted(self.dims, key=lambda d: pos[d]))

    # -- indexing ---------------------------------------------------------------
    def physical_index(self, state: Mapping[str, Any]) -> tuple[Any, ...]:
        """Map a logical state ``{dim: index}`` to per-axis physical indices.

        Works with Python ints and integer tensors (mixed-radix // and %).
        """
        axis_idx: dict[str, Any] = {}
        for d, axs in self.dim_map:
            if d not in state:
                raise LayoutError(f"state missing index for dim {d!r} (has {sorted(state)})")
            radices = self.dim_radices(d)
            parts = mixed_radix_split(state[d], radices)
            for ax, p in zip(axs, parts):
                axis_idx[ax] = p
        return tuple(axis_idx[a.name] for a in self.axes)

    def offset(self, state: Mapping[str, Any]) -> Any:
        """Linear element offset in the (row-major) backing buffer."""
        self._require_resolved()
        phys = self.physical_index(state)
        off = 0
        for p, a in zip(phys, self.axes):
            off = off * a.size + p
        return off

    # -- paper's trait functions (§3.1) ------------------------------------------
    def stride_along(self, axis_name: str) -> int:
        """Element stride of one physical axis (row-major)."""
        self._require_resolved()
        i = self.axis_index(axis_name)
        return prod(a.size for a in self.axes[i + 1 :])  # type: ignore[misc]

    def is_contiguous_along(self, axis_name: str) -> bool:
        """Would MPI_Type_contiguous suffice for this axis (stride == 1 block)?"""
        return self.axis_index(axis_name) == len(self.axes) - 1

    def lower_bound_along(self, axis_name: str) -> int:
        return 0  # ndarray-backed layouts have no leading padding

    def size_bytes(self) -> int:
        self._require_resolved()
        return prod(self.shape) * np.dtype(self.dtype).itemsize

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        dims = ", ".join(
            f"{d}<-({','.join(axs)})" if axs != (d,) else d for d, axs in self.dim_map
        )
        return f"Layout[{np.dtype(self.dtype).name}; axes=({', '.join(map(repr, self.axes))}); dims=({dims})]"


# =============================================================================
# Proto-structures
# =============================================================================
class ProtoStructure:
    """A transformation of a layout; composable with ``^`` like in Noarr."""

    def apply(self, layout: Layout) -> Layout:  # pragma: no cover - interface
        raise NotImplementedError

    def __xor__(self, other: "ProtoStructure") -> "ProtoStructure":
        return _Composed(self, other)


@dataclasses.dataclass(frozen=True)
class _Composed(ProtoStructure):
    first: ProtoStructure
    second: ProtoStructure

    def apply(self, layout: Layout) -> Layout:
        return self.second.apply(self.first.apply(layout))


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}
# numpy has no bfloat16: the layouts of bf16 tensors carry this 2-byte stand-in
# (it does not compare equal to the reference's ml_dtypes bfloat16)
BFLOAT16 = np.dtype([("bfloat16", np.uint16)])
_TORCH_DTYPES[BFLOAT16] = torch.bfloat16


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` of a layout's numpy element dtype
    (``Layout.dtype`` stays numpy, so layouts compare equal across packages)."""
    dt = np.dtype(dtype)
    if dt not in _TORCH_DTYPES:
        raise LayoutError(f"no torch dtype for layout dtype {dt}")
    return _TORCH_DTYPES[dt]


def layout_dtype(dtype: torch.dtype) -> np.dtype:
    """The layout element dtype of a ``torch.dtype`` (:data:`BFLOAT16` for
    ``torch.bfloat16``)."""
    for dt, t in _TORCH_DTYPES.items():
        if t == dtype:
            return dt
    raise LayoutError(f"no layout dtype for torch dtype {dtype}")


def scalar(dtype) -> Layout:
    """The base structure: a single element of ``dtype`` (Noarr ``scalar<T>()``)."""
    return Layout(dtype=np.dtype(dtype))


@dataclasses.dataclass(frozen=True)
class vector(ProtoStructure):
    """Add a new dimension as the *outermost* physical axis.

    ``scalar(f32) ^ vector('i', N) ^ vector('j', M)``: ``j`` ends outermost —
    column-major when ``i`` indexes rows, exactly as in the paper.
    """

    dim: str
    size: int | None = None

    def apply(self, layout: Layout) -> Layout:
        if any(a.name == self.dim for a in layout.axes):
            raise LayoutError(f"dimension {self.dim!r} already present in {layout}")
        return Layout(
            dtype=layout.dtype,
            axes=(Axis(self.dim, self.size),) + layout.axes,
            dim_map=((self.dim, (self.dim,)),) + layout.dim_map,
        )


def vectors(*dims: str) -> Callable[..., ProtoStructure]:
    """``vectors('i','j')(N, M)`` == ``vector('i',N) ^ vector('j',M)``."""

    def with_sizes(*sizes: int | None) -> ProtoStructure:
        if len(sizes) != len(dims):
            raise LayoutError(f"vectors{dims} got {len(sizes)} sizes")
        proto: ProtoStructure | None = None
        for d, s in zip(dims, sizes):
            proto = vector(d, s) if proto is None else proto ^ vector(d, s)
        assert proto is not None
        return proto

    return with_sizes


def vectors_like(*dims: str):
    """``vectors_like('m','n')(traverser_or_layout)`` — sizes deduced from an
    object exposing an index space (paper Listing 4/5)."""

    def from_source(source) -> ProtoStructure:
        space = source.index_space() if callable(getattr(source, "index_space", None)) else dict(source)
        missing = [d for d in dims if d not in space]
        if missing:
            raise LayoutError(f"vectors_like: source lacks dims {missing} (has {sorted(space)})")
        return vectors(*dims)(*[space[d] for d in dims])

    return from_source


@dataclasses.dataclass(frozen=True)
class into_blocks(ProtoStructure):
    """Split logical dim into (block_dim outer, dim inner).

    Physically splits the dim's single axis in place (the two new axes stay
    adjacent in memory, block index more-major) — Noarr ``into_blocks``.
    Exactly one of ``block_size`` (inner extent) / ``num_blocks`` may be None
    when the original axis is open.
    """

    dim: str
    block_dim: str
    block_size: int | None = None  # size of the *inner* (element) part
    num_blocks: int | None = None  # size of the *outer* (block) part

    def apply(self, layout: Layout) -> Layout:
        axs = layout.dim_axes(self.dim)
        if len(axs) != 1:
            raise LayoutError(
                f"into_blocks({self.dim!r}): dim is already blocked over axes {axs}; "
                "merge first or block a leaf axis"
            )
        if any(a.name == self.block_dim for a in layout.axes):
            raise LayoutError(f"block dim {self.block_dim!r} already present")
        (axis_name,) = axs
        old = layout.axis(axis_name)
        bs, nb = self.block_size, self.num_blocks
        if old.size is not None:
            if bs is None and nb is None:
                raise LayoutError(f"into_blocks({self.dim!r}): need block_size or num_blocks")
            if bs is None:
                bs = _exact_div(old.size, nb, self)
            if nb is None:
                nb = _exact_div(old.size, bs, self)
            if bs * nb != old.size:
                raise LayoutError(
                    f"into_blocks({self.dim!r}): {nb} blocks x {bs} != extent {old.size}"
                )
        new_axes = []
        for a in layout.axes:
            if a.name == axis_name:
                new_axes.append(Axis(self.block_dim, nb))
                new_axes.append(Axis(axis_name, bs))
            else:
                new_axes.append(a)
        new_dim_map = []
        for d, daxs in layout.dim_map:
            if d == self.dim:
                new_dim_map.append((self.block_dim, (self.block_dim,)))
                new_dim_map.append((self.dim, (axis_name,)))
            else:
                new_dim_map.append((d, daxs))
        return Layout(layout.dtype, tuple(new_axes), tuple(new_dim_map))


def _exact_div(total: int, part: int | None, who) -> int:
    if part is None or part == 0 or total % part:
        raise LayoutError(f"{who}: {part} does not divide extent {total}")
    return total // part


@dataclasses.dataclass(frozen=True)
class merge_blocks(ProtoStructure):
    """Merge two logical dims into one (outer first): the new dim's index is
    ``i_outer * size(inner) + i_inner``.  Physical axes are untouched, so the
    merged dim may span non-adjacent memory — this is what lets a single
    'rank' dim cover a 2-D grid of tiles (paper Listing 5)."""

    outer: str
    inner: str
    merged: str

    def apply(self, layout: Layout) -> Layout:
        oaxs = layout.dim_axes(self.outer)
        iaxs = layout.dim_axes(self.inner)
        if self.merged not in (self.outer, self.inner) and any(
            d == self.merged for d, _ in layout.dim_map
        ):
            raise LayoutError(f"merged dim {self.merged!r} already present")
        new_dim_map = []
        for d, daxs in layout.dim_map:
            if d == self.outer:
                new_dim_map.append((self.merged, oaxs + iaxs))
            elif d == self.inner:
                continue
            else:
                new_dim_map.append((d, daxs))
        return Layout(layout.dtype, layout.axes, tuple(new_dim_map))


@dataclasses.dataclass(frozen=True)
class blocked(ProtoStructure):
    """Tile a dim *physically* while keeping the logical index space intact:
    ``into_blocks(dim, tag, bs)`` followed by merging the block index back
    into ``dim``.  Two bags whose layouts block the same dim differently (or
    not at all) remain relayout-compatible — the common-refinement engine
    handles the transfer."""

    dim: str
    tag: str
    block_size: int | None = None
    num_blocks: int | None = None

    def apply(self, layout: Layout) -> Layout:
        out = into_blocks(self.dim, self.tag, self.block_size, self.num_blocks).apply(layout)
        return merge_blocks(self.tag, self.dim, self.dim).apply(out)


@dataclasses.dataclass(frozen=True)
class hoist(ProtoStructure):
    """Move a logical dim's axes to the outermost physical position (in order).

    At the layout level this *changes memory order* (materializing a bag from
    the hoisted layout gives the reordered buffer); at the traverser level the
    same name only reorders iteration.
    """

    dim: str

    def apply(self, layout: Layout) -> Layout:
        daxs = layout.dim_axes(self.dim)
        moved = [layout.axis(ax) for ax in daxs]
        rest = [a for a in layout.axes if a.name not in daxs]
        return Layout(layout.dtype, tuple(moved) + tuple(rest), layout.dim_map)


@dataclasses.dataclass(frozen=True)
class reorder(ProtoStructure):
    """Set the full physical axis order by axis name (outermost first)."""

    order: tuple[str, ...]

    def __init__(self, *order: str):
        object.__setattr__(self, "order", tuple(order))

    def apply(self, layout: Layout) -> Layout:
        if sorted(self.order) != sorted(layout.axis_names):
            raise LayoutError(
                f"reorder{self.order} must be a permutation of axes {layout.axis_names}"
            )
        return Layout(
            layout.dtype,
            tuple(layout.axis(n) for n in self.order),
            layout.dim_map,
        )


@dataclasses.dataclass(frozen=True)
class rename(ProtoStructure):
    old: str
    new: str

    def apply(self, layout: Layout) -> Layout:
        if self.old == self.new:
            return layout
        if any(a.name == self.new for a in layout.axes) or any(
            d == self.new for d, _ in layout.dim_map
        ):
            raise LayoutError(f"rename: {self.new!r} already present")
        axes = tuple(Axis(self.new if a.name == self.old else a.name, a.size) for a in layout.axes)
        dim_map = tuple(
            (
                self.new if d == self.old else d,
                tuple(self.new if ax == self.old else ax for ax in axs),
            )
            for d, axs in layout.dim_map
        )
        return Layout(layout.dtype, axes, dim_map)


@dataclasses.dataclass(frozen=True)
class set_length(ProtoStructure):
    """Resolve an open axis extent (paper ``set_length``)."""

    axis_name: str
    size: int

    def apply(self, layout: Layout) -> Layout:
        old = layout.axis(self.axis_name)
        if old.size is not None and old.size != self.size:
            raise LayoutError(
                f"set_length({self.axis_name!r}, {self.size}): axis already sized {old.size}"
            )
        axes = tuple(
            Axis(a.name, self.size if a.name == self.axis_name else a.size) for a in layout.axes
        )
        return Layout(layout.dtype, axes, layout.dim_map)


@dataclasses.dataclass(frozen=True)
class fix_dim(ProtoStructure):
    """Remove a size-1 logical dim after fixing (layout-level ``fix``)."""

    dim: str

    def apply(self, layout: Layout) -> Layout:
        daxs = layout.dim_axes(self.dim)
        for ax in daxs:
            if layout.axis(ax).size != 1:
                raise LayoutError(
                    f"fix_dim({self.dim!r}): axis {ax} has size {layout.axis(ax).size} != 1; "
                    "slice the bag first"
                )
        axes = tuple(a for a in layout.axes if a.name not in daxs)
        dim_map = tuple((d, axs) for d, axs in layout.dim_map if d != self.dim)
        return Layout(layout.dtype, axes, dim_map)
