"""Gradient buckets: MPI-style counts/displacements over the flattened
param tree, for the ZeRO-2 train step (:mod:`repro_torch.train.trainer`).
The port of ``src/repro/train/buckets.py``; its tables are the reference's.

A bucket groups consecutive leaves of the flattened gradient tree
(:func:`repro_torch.models.module.tree_leaves`: sorted key order, JAX's)
into one flat buffer that crosses the wire as a single
``MPI_Ireduce_scatter`` (and whose updated params return as one
``MPI_Iallgatherv``).  Assembly rules:

* leaves are taken in flat-tree order (deterministic: counts and
  displacements are the same on every process, the MPI requirement);
* buckets are **dtype-homogeneous** (a flat buffer has one element type);
* a bucket closes when adding the next leaf would push it past
  ``bucket_bytes``, unless the bucket is empty, so a single tensor larger
  than the threshold gets a bucket of its own;
* each bucket pads its flat size to ``ranks`` equal capacity shards
  (:func:`repro_torch.models.sharding.ragged_grad_extents`, the
  ``recvcounts`` table); padding rides the wire and is wire-vs-valid
  accounted by :func:`zero_comm_model`.

``counts``/``displs`` per bucket are the per-leaf sizes and prefix sums
(the tables an ``MPI_Type_indexed`` datatype would carry), and
:func:`pack_bucket`/:func:`unpack_bucket` are the (de)serialization through
them, round-tripping bitwise.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch

from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import ragged_grad_extents

__all__ = ["GradBucket", "assign_buckets", "pack_bucket", "unpack_bucket", "bucket_leaves",
           "zero_comm_model"]


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One dtype-homogeneous slice of the flattened param space.

    ``indices`` are positions into the flat leaf list; ``counts``/``displs``
    are per-leaf element counts and prefix-sum offsets into the flat buffer
    (the MPI datatype tables); ``size`` is the valid element count,
    ``cap``/``extents`` the padded per-rank shard capacity and the per-rank
    valid sizes (``recvcounts``), so ``padded = ranks * cap``.  ``dtype`` is
    a torch dtype.
    """

    indices: tuple[int, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtype: Any
    counts: tuple[int, ...]
    displs: tuple[int, ...]
    size: int
    cap: int
    extents: tuple[int, ...]

    @property
    def padded(self) -> int:
        return self.cap * len(self.extents)

    @property
    def nbytes(self) -> int:
        return self.size * _itemsize(self.dtype)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def assign_buckets(params, *, bucket_bytes: int, ranks: int) -> tuple[GradBucket, ...]:
    """Greedy size-thresholded assignment of the flattened ``params``
    (tensors or :class:`~repro_torch.models.module.ParamSpec`\\ s) into
    dtype-homogeneous :class:`GradBucket`\\ s.

    Every leaf lands in exactly one bucket; flat-tree order is preserved
    within and across buckets, so ``concat(unpack(b) for b in buckets)``
    rebuilds the flat leaf list."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    if ranks <= 0:
        raise ValueError(f"ranks must be positive, got {ranks}")
    buckets: list[GradBucket] = []
    cur: list[tuple[int, Any]] = []
    cur_bytes = 0

    def close():
        nonlocal cur, cur_bytes
        if not cur:
            return
        shapes = tuple(tuple(leaf.shape) for _, leaf in cur)
        counts = tuple(int(math.prod(s)) for s in shapes)
        displs = (0, *itertools.accumulate(counts[:-1]))
        size = sum(counts)
        cap, extents = ragged_grad_extents(size, ranks)
        buckets.append(GradBucket(indices=tuple(i for i, _ in cur), shapes=shapes,
                                  dtype=cur[0][1].dtype, counts=counts, displs=displs,
                                  size=size, cap=cap, extents=extents))
        cur, cur_bytes = [], 0

    for i, leaf in enumerate(tree_leaves(params)):
        nbytes = int(math.prod(leaf.shape)) * _itemsize(leaf.dtype)
        if cur and (leaf.dtype != cur[0][1].dtype or cur_bytes + nbytes > bucket_bytes):
            close()
        cur.append((i, leaf))
        cur_bytes += nbytes
    close()
    return tuple(buckets)


def bucket_leaves(flat_leaves, bucket: GradBucket) -> list:
    """The bucket's leaves, picked from the flat leaf list in order."""
    return [flat_leaves[i] for i in bucket.indices]


def pack_bucket(flat_leaves, bucket: GradBucket) -> torch.Tensor:
    """Serialize the bucket's leaves into one flat ``(padded,)`` buffer:
    ravel in order, place at ``displs``, zero-pad the capacity tail."""
    parts = [flat_leaves[i].reshape(-1) for i in bucket.indices]
    pad = bucket.padded - bucket.size
    if pad:
        parts.append(parts[0].new_zeros((pad,)))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def unpack_bucket(flat: torch.Tensor, bucket: GradBucket) -> list:
    """Deserialize the ``(padded,)`` buffer back into the bucket's leaves
    through the counts/displacements tables (views of ``flat``; the inverse
    of :func:`pack_bucket`)."""
    return [flat[d:d + c].reshape(shape)
            for d, c, shape in zip(bucket.displs, bucket.counts, bucket.shapes)]


def zero_comm_model(buckets, *, itemsize: int | None = None) -> dict:
    """Analytic ZeRO comm model for the bucketed train step, in the
    reference's byte conventions (each collective's per-rank *result*
    bytes):

    * reduce-scatter of bucket *b*: result is one ``(cap_b,)`` shard ->
      ``itemsize * cap_b`` wire bytes per bucket;
    * all-gather of bucket *b*: result is the full ``(padded_b,)`` flat ->
      ``itemsize * padded_b`` wire bytes per bucket;
    * valid bytes scale both by the payload fraction
      ``sum(size_b) / sum(padded_b)``: the capacity-pad tail rides the wire
      but carries no gradient.

    Returns the per-kind wire/valid byte totals plus the
    ``valid_fractions`` table."""
    if not buckets:
        raise ValueError("zero_comm_model needs at least one bucket")
    itemsize = itemsize or max(_itemsize(b.dtype) for b in buckets)
    size = sum(b.size for b in buckets)
    padded = sum(b.padded for b in buckets)
    frac = size / padded
    rs_wire = float(itemsize * sum(b.cap for b in buckets))
    ag_wire = float(itemsize * padded)
    return {
        "n_buckets": len(buckets),
        "param_elems": size,
        "padded_elems": padded,
        "rs_wire_bytes": rs_wire,
        "rs_valid_bytes": rs_wire * frac,
        "ag_wire_bytes": ag_wire,
        "ag_valid_bytes": ag_wire * frac,
        "wire_bytes": rs_wire + ag_wire,
        "valid_bytes": (rs_wire + ag_wire) * frac,
        "valid_fractions": {"reduce-scatter": frac, "all-gather": frac},
    }
