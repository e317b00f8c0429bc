"""repro_torch.core — the layout-agnostic distributed-array algebra (the
paper's contribution) on PyTorch tensors and ``torch.distributed``.

Public API mirrors the paper's vocabulary:

* layouts:    ``scalar ^ vector ^ into_blocks ^ hoist ^ ...`` -> :class:`Layout`
* bags:       :func:`bag` / :class:`Bag` — tensor + layout, logical indexing
* traversers: :func:`traverser` ^ ``hoist/fix/span/bcast/merge_blocks``
* relayout:   :func:`relayout` — the MPI-datatype-construction analogue
* dist:       :func:`make_mesh`, :func:`mpi_traverser` /
              :func:`mpi_cart_traverser` -> :class:`DistTraverser`;
              layout-agnostic collectives, p2p and comm plans

Paper section -> module map:

=========  =======================================  =============================
Section    Paper concept                            Module
=========  =======================================  =============================
§2         structures, bags, traversers             ``layout``, ``bag``,
                                                    ``traverser``
§3.1       MPI datatype derivation & taxonomy       ``relayout``
                                                    (``transfer_kind``)
§3.2       signature/type safety                    ``dims`` (``LayoutError``,
                                                    ``check_same_space``)
§4.1       MPI traverser, rank binding,             ``dist`` (``mpi_traverser``,
           communicator grids / Comm_split          ``mpi_cart_traverser``,
                                                    ``DistTraverser.sub``)
§4.2       collectives (scatter/gather/bcast,       ``collectives``
           reduce_scatter, v-collectives)
§4.3       point-to-point ring shifts               ``p2p``
§5         layout-parametric distributed GEMM       ``repro_torch.kernels`` +
                                                    ``repro_torch.examples.
                                                    distributed_gemm``
=========  =======================================  =============================
"""
from .dims import LayoutError, ceil_div, common_refinement, ragged_split
from .layout import (
    Axis,
    Layout,
    ProtoStructure,
    scalar,
    vector,
    vectors,
    vectors_like,
    into_blocks,
    hoist,
    reorder,
    rename,
    set_length,
    fix_dim,
    torch_dtype,
)
from .layout import merge_blocks as merge_blocks_layout
from .bag import Bag, bag, bag_from_numpy, idx
from .traverser import Traverser, traverser, fix, span, bcast, merge_blocks
from .traverser import hoist as hoist_trav
from .traverser import set_length as set_length_trav
from .relayout import RelayoutPlan, check_ragged_dims, relayout, relayout_plan, transfer_kind
from .request import Pending, wait_all
from .dist import (DistTraverser, Mesh, init_fake_world, init_world, is_fake_world, make_mesh,
                   mpi_cart_traverser, mpi_traverser, resolve_device)
from .collectives import (
    DistBag,
    all_gather_bag,
    all_gather_dist,
    all_gather_start,
    all_reduce_bag,
    all_reduce_start,
    all_to_all_bag,
    all_to_all_start,
    all_to_allv_bag,
    all_to_allv_start,
    all_gatherv_bag,
    all_gatherv_dist,
    all_gatherv_start,
    broadcast,
    dist_full,
    gather,
    gatherv_bag,
    grid_extents,
    rank_map,
    reduce_identity,
    reduce_scatter_bag,
    reduce_scatter_start,
    reduce_scatterv_bag,
    reduce_scatterv_start,
    scatter,
    scatterv_bag,
    shard_all_gatherv_start,
    shard_reduce_scatterv_start,
)
from .plan import CommPlan, bucket, dispatch, halo, intent_of, pipeline, ring, stagger
from .p2p import (permute, permute_start, ring_shift, ring_shift_start, send_recv,
                  shard_all_gather_start,
                  shard_all_reduce_start, shard_reduce_scatter_start, shard_ring_shift,
                  shard_ring_shift_start, wait)

__all__ = [
    "LayoutError", "ceil_div", "common_refinement", "ragged_split",
    "Axis", "Layout", "ProtoStructure", "scalar", "vector", "vectors", "vectors_like",
    "into_blocks", "hoist", "reorder", "rename", "set_length", "fix_dim", "torch_dtype",
    "merge_blocks_layout",
    "Bag", "bag", "bag_from_numpy", "idx",
    "Traverser", "traverser", "fix", "span", "bcast", "merge_blocks", "hoist_trav",
    "set_length_trav",
    "RelayoutPlan", "check_ragged_dims", "relayout", "relayout_plan", "transfer_kind",
    "Pending", "wait_all",
    "DistTraverser", "Mesh", "init_world", "init_fake_world", "is_fake_world", "make_mesh",
    "mpi_cart_traverser", "mpi_traverser", "resolve_device",
    "DistBag", "all_gather_bag", "all_gather_dist", "all_gather_start", "all_reduce_bag",
    "all_reduce_start", "all_to_all_bag", "all_to_all_start", "all_to_allv_bag",
    "all_to_allv_start", "all_gatherv_bag", "all_gatherv_dist", "all_gatherv_start",
    "broadcast", "dist_full", "gather", "gatherv_bag", "grid_extents",
    "rank_map", "reduce_identity", "reduce_scatter_bag", "reduce_scatter_start",
    "reduce_scatterv_bag", "reduce_scatterv_start", "scatter", "scatterv_bag",
    "shard_all_gatherv_start", "shard_reduce_scatterv_start",
    "CommPlan", "bucket", "dispatch", "halo", "intent_of", "pipeline", "ring", "stagger",
    "permute", "permute_start", "ring_shift", "ring_shift_start", "send_recv",
    "shard_all_gather_start",
    "shard_all_reduce_start", "shard_reduce_scatter_start", "shard_ring_shift",
    "shard_ring_shift_start", "wait",
]
