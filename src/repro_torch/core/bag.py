"""Noarr *bags*: a tensor paired with a :class:`Layout`.

``bag[state]`` accesses an element through the logical index space regardless
of the physical layout (paper §2).  Bags are functional like their reference
counterparts: ``bag.at(state).set(v)`` returns a new bag and leaves the old
buffer untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .dims import LayoutError
from .layout import Layout, torch_dtype
from .relayout import relayout

__all__ = ["Bag", "bag", "bag_from_numpy", "idx"]


def idx(**indices: Any) -> dict[str, Any]:
    """A Noarr state literal: ``idx(i=3, j=5)``."""
    return dict(indices)


@dataclasses.dataclass(frozen=True)
class Bag:
    data: torch.Tensor
    layout: Layout

    def __post_init__(self):
        self.layout._require_resolved()
        if tuple(self.data.shape) != self.layout.shape:
            raise LayoutError(
                f"bag: buffer shape {tuple(self.data.shape)} != layout shape {self.layout.shape}"
            )
        if self.data.dtype != torch_dtype(self.layout.dtype):
            raise LayoutError(
                f"bag: buffer dtype {self.data.dtype} != layout dtype {self.layout.dtype}"
            )

    # -- logical access --------------------------------------------------------
    def _phys(self, state: Mapping[str, Any]) -> tuple[Any, ...]:
        # "[] applies the relevant index sub-set of the state" (paper Listing 1):
        # extra dims in the state are ignored.
        sub = {d: state[d] for d, _ in self.layout.dim_map if d in state}
        return self.layout.physical_index(sub)

    def __getitem__(self, state: Mapping[str, Any]):
        return self.data[self._phys(state)]

    class _At:
        def __init__(self, b: "Bag", state: Mapping[str, Any]):
            self._b, self._state = b, state

        def set(self, value) -> "Bag":
            b = self._b
            data = b.data.clone()
            data[b._phys(self._state)] = value
            return Bag(data, b.layout)

        def add(self, value) -> "Bag":
            b = self._b
            data = b.data.clone()
            data[b._phys(self._state)] += value
            return Bag(data, b.layout)

    def at(self, state: Mapping[str, Any]) -> "Bag._At":
        return Bag._At(self, state)

    # -- layout agnosticism ------------------------------------------------------
    def index_space(self) -> dict[str, int]:
        return self.layout.index_space()

    def to_layout(self, dst: Layout) -> "Bag":
        """Rematerialize under a different physical layout (same logical space)."""
        return Bag(relayout(self.data, self.layout, dst), dst)

    def valid_view(self, extents: Mapping[str, int]) -> "Bag":
        """View of the leading *valid* region of a padded ragged tile.

        ``extents`` maps logical dims to their valid sizes (the MPI
        v-collective counts); every named dim must map to a single physical
        axis so the valid elements form a leading hyper-rectangle.  The
        returned bag's layout is this layout with the named dims resized, and
        its data is a (strided) view of this bag's buffer.
        """
        layout = self.layout
        slicer: list[Any] = [slice(None)] * layout.ndim
        for d, e in extents.items():
            axs = layout.dim_axes(d)
            if len(axs) != 1:
                raise LayoutError(
                    f"valid_view: ragged dim {d!r} is blocked over axes {axs}; "
                    "ragged dims must stay unblocked"
                )
            i = layout.axis_index(axs[0])
            cap = layout.axes[i].size
            if not (0 <= e <= cap):
                raise LayoutError(f"valid_view: extent {e} of dim {d!r} exceeds capacity {cap}")
            slicer[i] = slice(0, e)
            layout = layout.resize_dim(d, e)
        return Bag(self.data[tuple(slicer)], layout)

    def with_data(self, data) -> "Bag":
        return Bag(data, self.layout)

    # -- convenience ---------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return self.layout.shape

    @property
    def dtype(self):
        return self.layout.dtype

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Bag({self.layout!r})"


def bag(layout: Layout, data: Any | None = None, *, fill: Any = 0,
        device: torch.device | str | None = None) -> Bag:
    """Allocate (or wrap) a buffer for ``layout`` (paper's ``bag(...)``).

    A tensor ``data`` keeps its device unless ``device`` is given; a new
    buffer is allocated on ``device`` (the CPU when ``None``)."""
    dtype = torch_dtype(layout.dtype)
    if data is None:
        data = torch.full(layout.shape, fill, dtype=dtype, device=device)
    else:
        data = torch.as_tensor(data, dtype=dtype, device=device).reshape(layout.shape)
    return Bag(data, layout)


def bag_from_numpy(layout: Layout, array: np.ndarray, device: torch.device | str) -> Bag:
    """Copy a host numpy buffer (for example a reference bag's data) into a
    bag on ``device``; the buffer is read in ``layout``'s physical order."""
    host = np.ascontiguousarray(np.asarray(array, dtype=layout.dtype).reshape(layout.shape))
    return Bag(torch.tensor(host, device=device), layout)
