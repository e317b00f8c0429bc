"""Named-dimension primitives shared by the whole layout algebra.

The paper (Noarr-MPI) separates a structure's *logical index space* (named
dimensions) from its *physical layout*.  This module holds the tiny shared
vocabulary: dimension names, index-space dictionaries, mixed-radix helpers and
the error type that plays the role of Noarr's compile-time signature checks
(here "compile time" = Python call time, before any tensor is touched).
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence

__all__ = [
    "LayoutError",
    "IndexSpace",
    "check_same_space",
    "mixed_radix_split",
    "mixed_radix_join",
    "common_refinement",
    "prod",
    "ceil_div",
    "ragged_split",
]

# A logical index space: ordered mapping dim name -> extent.
IndexSpace = dict


class LayoutError(TypeError):
    """Raised when index spaces / layouts are incompatible.

    This is the analogue of Noarr's signature type errors: it fires when a
    plan is built, before any data is moved or computed.
    """


def prod(xs: Iterable[int]) -> int:
    return math.prod(xs)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ragged_split(total: int, parts: int) -> tuple[int, tuple[int, ...]]:
    """Balanced ragged split of ``total`` into ``parts`` blocks.

    Returns ``(capacity, extents)``: the uniform *padded* block capacity
    (``ceil(total / parts)``) and the per-block valid extents (the
    counts of the MPI ``Scatterv``/``Gatherv`` family; displacements are the
    prefix sums).  Balanced: extents differ by at most one, so no block is
    ever empty when ``total >= parts``.
    """
    if parts <= 0:
        raise LayoutError(f"ragged_split({total}, {parts}): parts must be positive")
    if total < parts:
        raise LayoutError(
            f"ragged_split({total}, {parts}): extent smaller than part count "
            "(empty ragged blocks are not representable as layouts)"
        )
    base, rem = divmod(total, parts)
    extents = tuple(base + (1 if i < rem else 0) for i in range(parts))
    return ceil_div(total, parts), extents


def check_same_space(a: Mapping[str, int], b: Mapping[str, int], *, what: str = "operands") -> None:
    """Type-safety check: both operands must span the same logical index space.

    Order does not matter (that is the whole point of layout agnosticism);
    the *set* of named extents must match exactly.
    """
    if dict(a) != dict(b):
        only_a = {k: v for k, v in a.items() if b.get(k) != v}
        only_b = {k: v for k, v in b.items() if a.get(k) != v}
        raise LayoutError(
            f"incompatible index spaces for {what}: {dict(a)} vs {dict(b)} "
            f"(mismatch: {only_a} vs {only_b})"
        )


def mixed_radix_split(value, radices: Sequence[int]):
    """Decompose ``value`` into indices along ``radices`` (outer..inner).

    Works on Python ints and integer tensors alike (uses // and %).
    """
    out = []
    for r in reversed(radices):
        out.append(value % r)
        value = value // r
    return tuple(reversed(out))


def mixed_radix_join(indices, radices: Sequence[int]):
    """Inverse of :func:`mixed_radix_split`."""
    value = 0
    for idx, r in zip(indices, radices):
        value = value * r + idx
    return value


def common_refinement(a: Sequence[int], b: Sequence[int]) -> list[int]:
    """Coarsest common refinement of two factorizations of the same extent.

    Example: ``common_refinement([64], [8, 8]) == [8, 8]``;
             ``common_refinement([4, 16], [8, 8]) == [4, 2, 8]``.

    This is the engine behind layout-agnostic relayouts between two
    differently-blocked views of the same logical dimension.
    """
    if prod(a) != prod(b):
        raise LayoutError(f"factorizations cover different extents: {list(a)} vs {list(b)}")

    def inner_cumulative(f: Sequence[int]) -> set[int]:
        # cumulative products counted from the *inner* (fastest) end
        cums, c = set(), 1
        for s in reversed(f):
            c *= s
            cums.add(c)
        return cums

    boundaries = sorted(inner_cumulative(a) | inner_cumulative(b))
    out_inner_first: list[int] = []
    prev = 1
    for c in boundaries:
        if c % prev:
            raise LayoutError(
                f"factorizations {list(a)} and {list(b)} have no common refinement "
                f"(boundary {c} not divisible by {prev})"
            )
        out_inner_first.append(c // prev)
        prev = c
    return list(reversed(out_inner_first))
