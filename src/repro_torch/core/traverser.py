"""Noarr *traversers*: first-class iteration order over named index spaces.

A traverser is constructed from one or more bags/layouts; it checks that the
shared dims agree in extent (type safety) and merges their default traversal
orders (prioritizing from the left — paper §2).  Proto-structure-like
transforms reorder (``hoist``), restrict (``span``, ``fix``), extend
(``bcast``) or regroup (``merge_blocks``) the iteration space *without*
touching any physical layout.

``trav | fn`` applies ``fn`` to every state, exactly like the paper's
``traverser(C) | [&](auto state){...}``.  This is the reference-semantics
path (tests, examples); vectorized compute in the framework goes through
relayout + array ops instead.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

from .dims import LayoutError, mixed_radix_split

__all__ = ["Traverser", "traverser", "hoist", "fix", "span", "bcast", "merge_blocks", "set_length"]


@dataclasses.dataclass(frozen=True)
class Traverser:
    # iteration dims, outer..inner; sizes may be None (open, e.g. deduced from
    # the communicator size by mpi_traverser)
    dims: tuple[tuple[str, int | None], ...]
    # dims decomposed into leaf dims: merged -> ((leaf, size), ...) outer..inner
    decomp: tuple[tuple[str, tuple[tuple[str, int], ...]], ...] = ()
    fixed: tuple[tuple[str, Any], ...] = ()
    ranges: tuple[tuple[str, tuple[int, int]], ...] = ()  # dim -> [start, stop)

    # -- queries -----------------------------------------------------------------
    @property
    def order(self) -> tuple[str, ...]:
        return tuple(d for d, _ in self.dims)

    def dim_size(self, dim: str) -> int | None:
        for d, s in self.dims:
            if d == dim:
                return s
        raise LayoutError(f"traverser has no dim {dim!r} (has {self.order})")

    def iter_extent(self, dim: str) -> int:
        for d, (a, b) in self.ranges:
            if d == dim:
                return b - a
        s = self.dim_size(dim)
        if s is None:
            raise LayoutError(f"traverser dim {dim!r} has unresolved extent")
        return s

    def _resolved_decomp(self) -> dict[str, tuple[tuple[str, int], ...]]:
        """Infer open leaf extents in merged dims (N = r / M, paper §4.2)."""
        out: dict[str, tuple[tuple[str, int], ...]] = {}
        sizes = dict(self.dims)
        for d, leaves in self.decomp:
            if d not in sizes:
                continue  # merged dim itself was re-merged/fixed away
            total = sizes[d]
            known = [(n, s) for n, s in leaves if s is not None]
            unknown = [n for n, s in leaves if s is None]
            if unknown:
                if total is None or len(unknown) > 1:
                    raise LayoutError(
                        f"merged dim {d!r}: cannot deduce extents of {unknown} "
                        f"(merged extent {total})"
                    )
                kn = 1
                for _, s in known:
                    kn *= s
                if total % kn:
                    raise LayoutError(
                        f"merged dim {d!r}: extent {total} not divisible by known {kn}"
                    )
                fill = total // kn
                leaves = tuple((n, fill if s is None else s) for n, s in leaves)
            out[d] = leaves  # type: ignore[assignment]
        return out

    def index_space(self) -> dict[str, int]:
        """Leaf-dim index space covered by one full traversal (incl. fixed)."""
        space: dict[str, int] = {}
        dec = self._resolved_decomp()
        for d, s in self.dims:
            if d in dec:
                for leaf, ls in dec[d]:
                    space[leaf] = ls
            else:
                if s is None:
                    raise LayoutError(f"traverser dim {d!r} has unresolved extent")
                space[d] = s
        return space

    # -- transforms (composable with ^, like proto-structures) ---------------------
    def __xor__(self, t: "TraverserTransform") -> "Traverser":
        return t.apply(self)

    # -- execution ---------------------------------------------------------------
    def states(self):
        """Generate all states (dicts of leaf-dim indices) in traversal order."""
        dims = []
        for d, _ in self.dims:
            lo, hi = 0, self.iter_extent(d)
            for rd, (a, b) in self.ranges:
                if rd == d:
                    lo, hi = a, b
            dims.append((d, lo, hi))
        dec = self._resolved_decomp()
        base = dict(self.fixed)
        for combo in itertools.product(*[range(lo, hi) for _, lo, hi in dims]):
            state = dict(base)
            for (d, _, _), v in zip(dims, combo):
                if d in dec:
                    leaves = dec[d]
                    parts = mixed_radix_split(v, [s for _, s in leaves])
                    for (leaf, _), p in zip(leaves, parts):
                        state[leaf] = p
                    state[d] = v
                else:
                    state[d] = v
            yield state

    def __or__(self, fn: Callable[[Mapping[str, Any]], Any]) -> None:
        for state in self.states():
            fn(state)

    def size(self) -> int:
        n = 1
        for d, _ in self.dims:
            n *= self.iter_extent(d)
        return n


def _merge_orders(spaces: Sequence[dict[str, int | None]]) -> list[tuple[str, int | None]]:
    """Combine default traversal orders, prioritizing from the left; verify
    that shared dims agree in extent (the traverser-level type check)."""
    out: list[tuple[str, int | None]] = []
    seen: dict[str, int | None] = {}
    for space in spaces:
        for d, s in space.items():
            if d in seen:
                if seen[d] is not None and s is not None and seen[d] != s:
                    raise LayoutError(
                        f"traverser: dim {d!r} has conflicting extents {seen[d]} vs {s}"
                    )
                if seen[d] is None and s is not None:
                    seen[d] = s
                    out[[i for i, (n, _) in enumerate(out) if n == d][0]] = (d, s)
            else:
                seen[d] = s
                out.append((d, s))
    return out


def _ordered_space(obj) -> dict[str, int | None]:
    # Bags and Layouts expose dims in default traversal order.
    layout = getattr(obj, "layout", obj)
    if hasattr(layout, "default_order"):
        order = layout.default_order()
        return {
            d: (None if any(layout.axis(ax).size is None for ax in layout.dim_axes(d)) else layout.dim_size(d))
            for d in order
        }
    if isinstance(obj, Traverser):
        return dict(obj.dims)
    raise LayoutError(f"cannot build traverser from {obj!r}")


def traverser(*objs) -> Traverser:
    """Construct a traverser over the union of the operands' index spaces."""
    if not objs:
        raise LayoutError("traverser() needs at least one bag/layout")
    dims = _merge_orders([_ordered_space(o) for o in objs])
    return Traverser(dims=tuple(dims))


# -- transforms ---------------------------------------------------------------------
class TraverserTransform:
    def apply(self, t: Traverser) -> Traverser:  # pragma: no cover - interface
        raise NotImplementedError

    def __xor__(self, other: "TraverserTransform") -> "TraverserTransform":
        a = self

        class _C(TraverserTransform):
            def apply(self, t: Traverser) -> Traverser:
                return other.apply(a.apply(t))

        return _C()


@dataclasses.dataclass(frozen=True)
class hoist(TraverserTransform):
    """Move a dim to the outermost iteration position (paper §2)."""

    dim: str

    def apply(self, t: Traverser) -> Traverser:
        t.dim_size(self.dim)  # existence check
        moved = [(d, s) for d, s in t.dims if d == self.dim]
        rest = [(d, s) for d, s in t.dims if d != self.dim]
        return dataclasses.replace(t, dims=tuple(moved + rest))


class fix(TraverserTransform):
    """Fix dims to given indices, removing them from iteration.

    Accepts a state dict (``fix(state)``) or kwargs (``fix(i=3)``); dims not
    present in the traverser are ignored when a state dict is given (so the
    paper's ``traverser(A, B) ^ fix(state)`` works with an outer state)."""

    def __init__(self, state: Mapping[str, Any] | None = None, **kw: Any):
        self.values = {**(dict(state) if state else {}), **kw}
        self.strict = not state

    def apply(self, t: Traverser) -> Traverser:
        present = set(t.order)
        vals = {}
        for d, v in self.values.items():
            if d in present:
                vals[d] = v
            elif self.strict:
                raise LayoutError(f"fix: traverser has no dim {d!r} (has {t.order})")
        dims = tuple((d, s) for d, s in t.dims if d not in vals)
        return dataclasses.replace(
            t, dims=dims, fixed=t.fixed + tuple(vals.items())
        )


@dataclasses.dataclass(frozen=True)
class span(TraverserTransform):
    """Restrict iteration over a dim to ``[start, stop)``."""

    dim: str
    start: int
    stop: int

    def apply(self, t: Traverser) -> Traverser:
        size = t.dim_size(self.dim)
        if size is not None and not (0 <= self.start <= self.stop <= size):
            raise LayoutError(f"span({self.dim!r},{self.start},{self.stop}) out of range {size}")
        ranges = tuple((d, r) for d, r in t.ranges if d != self.dim)
        return dataclasses.replace(t, ranges=ranges + ((self.dim, (self.start, self.stop)),))


@dataclasses.dataclass(frozen=True)
class bcast(TraverserTransform):
    """Introduce a new iteration dim with no layout meaning (paper §2: the
    traverser-safe counterpart of ``vector``)."""

    dim: str
    size: int | None = None

    def apply(self, t: Traverser) -> Traverser:
        if self.dim in t.order:
            raise LayoutError(f"bcast: dim {self.dim!r} already present")
        return dataclasses.replace(t, dims=((self.dim, self.size),) + t.dims)


@dataclasses.dataclass(frozen=True)
class set_length(TraverserTransform):
    dim: str
    size: int

    def apply(self, t: Traverser) -> Traverser:
        old = t.dim_size(self.dim)
        if old is not None and old != self.size:
            raise LayoutError(f"set_length({self.dim!r},{self.size}): extent already {old}")
        dims = tuple((d, self.size if d == self.dim else s) for d, s in t.dims)
        return dataclasses.replace(t, dims=dims)


@dataclasses.dataclass(frozen=True)
class merge_blocks(TraverserTransform):
    """Merge two iteration dims into one (outer-major), e.g. a 2-D tile grid
    into a single rank dim (paper Listing 5).  If the inner dim's extent is
    unknown it stays open until ``set_length``/``mpi_traverser`` resolves the
    merged extent (N = r / M — the paper's auto-deduction)."""

    outer: str
    inner: str
    merged: str

    def apply(self, t: Traverser) -> Traverser:
        so, si = t.dim_size(self.outer), t.dim_size(self.inner)
        if self.merged in t.order and self.merged not in (self.outer, self.inner):
            raise LayoutError(f"merge_blocks: dim {self.merged!r} already present")
        merged_size = so * si if (so is not None and si is not None) else None
        dims: list[tuple[str, int | None]] = []
        for d, s in t.dims:
            if d == self.outer:
                dims.append((self.merged, merged_size))
            elif d == self.inner:
                continue
            else:
                dims.append((d, s))
        # leaf decomposition (sizes resolved later if open)
        decomp = dict(t.decomp)
        decomp[self.merged] = ((self.outer, so), (self.inner, si))  # type: ignore[assignment]
        return dataclasses.replace(t, dims=tuple(dims), decomp=tuple(decomp.items()))
