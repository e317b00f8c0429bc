"""Sharding recipes: binding the model's named dims to mesh axes.

The port of ``src/repro/models/sharding.py``.  A recipe binds parameter
dims to mesh axes and names how each kind of activation is laid over the
mesh: the LM stack's form of the paper's MPI traverser, where the user
binds dims and every placement is derived.  :func:`make_recipe` derives the
same ``bindings``, ``attn_mode``, ``sp_ring`` flag and activation specs as
the reference's for a config and a mesh shape.  A spec is a tuple with one
entry per tensor dim: a mesh axis name, a tuple of them, or ``None``
(replicated), as the reference's ``PartitionSpec``.

What the port applies of a recipe.  Placement in the port is explicit, so
there is no ``shard_act``: every rank runs its own part of the recipe's
program and states each transfer (:class:`Placement`).  Parameters are
cut by the recipe's bindings (:meth:`Recipe.param_pspecs`,
:func:`repro_torch.models.weights.shard_params_by_recipe`): FSDP over
``data`` (``m``), tensor parallelism over ``model`` (``v``, ``f``, and
under ``tp`` the heads ``h`` and KV groups ``g``).  Under ``tp`` and plain
``sp`` (:func:`repro_torch.models.lm.forward`) a rank is handed its rows of
the batch (:func:`local_batch`: split over the ``data`` axes where they
divide it, as the reference's :func:`batch_shardings` places them; every
entry point takes this rank's blocks, a :class:`RankBatch`, and none
narrows a whole batch), all-gathers a
block's ``m``-sharded weights over ``data`` first thing inside the block's
checkpoint (so the checkpoint keeps the shards and its recompute gathers
again: no layer's gathered weights outlive its block).  Under ``tp`` it
keeps the residual stream whole over ``model`` (the reference's ``hidden``
spec): attention runs the rank's heads and KV groups, the FFN the rank's
``f`` columns, and each block's float32 partials are summed with one
all-reduce over ``model``.  Under plain ``sp`` the cache-less forward of
the attention stacks (the dense, MoE, audio and VLM families) carries the
residual stream cut over ``model`` by sequence between blocks, as the
reference's compiled program carries it (GSPMD propagates the cut of
``q``/``attn_out``): each rank holds its rows' ``(n_rows, cap, m)`` chunk
(:func:`ragged_seq_extents`, :attr:`Placement.S`), attention projects
its chunk's Q/K/V and gathers the chunks' K/V along the sequence, the FFN
gathers the normed chunks and reduce-scatters its float32 partial back to
the chunks (:func:`scatter`), and the VLM's cross block runs the chunk's
queries against its rows' whole image.  The other families, and every
forward with a cache, keep the residual whole and run the rank's chunk of
the queries against the whole K/V.  The head's
logits stay cut as the recipe's ``logits`` spec cuts them
(:func:`logits_spec`): a rank holds its rows and its block of the vocab
over ``model``, the loss is taken vocab-parallel on that block
(:func:`repro_torch.models.lm.loss_fn`), and only a caller that needs the
whole tensor gathers it (:func:`repro_torch.models.lm.gather_logits`).
The decode caches are cut by :func:`decode_state_shardings`: heads over
``model`` where the KV groups divide it, else the sequence.

Under ``sp_ring`` every rank keeps its contiguous, padded chunk of the
residual stream through the blocks and the attention runs as a
double-buffered ring of KV blocks
(:func:`repro_torch.models.attention.ring_attention_seq`).  A MoE block
takes the chunk (:class:`TokenShard` says which block of the token grid it
is) by expert parallelism or by the whole grid's dispatch
(:func:`repro_torch.models.ffn.moe_ffn`).  Its weights are used whole, one
layer at a time: each block gathers its layer's cut leaves inside its
checkpoint, as under ``tp``.  The final hidden states of the rank's rows
are gathered over ``model`` alone and the head computes the rank's block
of the logits, cut as under ``tp``.  Training
under it differentiates through the ring and that gather and sums each
parameter's partial gradients over the ranks (:meth:`TokenShard.partial`).

Gradients under ``tp``/``sp`` flow through the explicit collectives: the
backward of an all-reduce of partials is the identity, the backward of an
FSDP all-gather is a reduce-scatter over ``data`` (a slice when the batch
is not split there), and a weight held whole by the ranks that split the
work has its gradient summed over them (:class:`Placement`).

Sequence lengths need not divide the ring: :func:`ragged_seq_extents`
pads the sequence to R equal capacity chunks (trailing ranks hold short,
possibly empty, valid chunks) and the padded keys are masked.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.dims import mixed_radix_join
from repro_torch.core.p2p import (shard_all_gather_start, shard_all_reduce_start,
                                  shard_reduce_scatter_start)
from repro_torch.kernels.fake import on_card

__all__ = ["Recipe", "make_recipe", "use_recipe", "current_recipe", "fit_spec",
           "ragged_seq_extents", "ragged_expert_extents", "ragged_grad_extents", "TokenShard",
           "token_shard", "PRIORITY", "batch_shardings", "RankBatch", "local_batch",
           "local_batch_shapes", "rank_batch", "decode_state_shardings", "batch_rows",
           "logits_spec", "recipe_pspecs", "local_shape", "spec_axes", "partial_product",
           "Placement", "placement", "all_gather", "all_reduce", "scatter", "sum_stat",
           "sum_grads", "gather_cut", "lse_merge"]

Spec = tuple  # one entry per dim: a mesh axis, a tuple of them, or None


def ragged_seq_extents(S: int, R: int) -> tuple[int, tuple[int, ...]]:
    """Ragged sequence shards for an R-rank ring: ``(capacity, extents)``.

    Contiguous ceil-split: rank ``r`` owns positions ``[r*cap, min((r+1)*cap,
    S))``, so the leading ranks hold full chunks and only the trailing ranks
    are short, possibly empty (a ring step against an empty KV block is a
    fully masked score block)."""
    if R <= 0 or S <= 0:
        raise ValueError(f"ragged_seq_extents({S}, {R}): sizes must be positive")
    cap = -(-S // R)
    return cap, tuple(max(0, min(cap, S - r * cap)) for r in range(R))


def ragged_expert_extents(E: int, R: int) -> tuple[int, tuple[int, ...]]:
    """Ragged expert ownership over an R-rank model axis: ``(cap, extents)``.

    Contiguous ceil-split of the expert table: rank ``r`` owns experts
    ``[r*cap, min((r+1)*cap, E))``, so ``E`` need not divide the axis and
    trailing ranks own fewer (possibly zero) experts.  This is the per-rank
    side of the expert-parallel ``MPI_Alltoallv`` counts table: the
    dispatch leg's split extent for a destination rank sums the token
    counts of exactly these experts."""
    return ragged_seq_extents(E, R)


def ragged_grad_extents(n: int, R: int) -> tuple[int, tuple[int, ...]]:
    """Ragged 1/R shards of a flattened gradient bucket: ``(cap, extents)``.

    Contiguous ceil-split of the ``n``-element flat buffer the ZeRO train
    step reduce-scatters over the ``data`` axis: rank ``r`` owns elements
    ``[r*cap, min((r+1)*cap, n))`` of the reduced gradient (and the matching
    optimizer-state shard), the bucket pads to ``R*cap`` on the wire, and
    the extents are the ``MPI_Reduce_scatter`` ``recvcounts`` table
    (:func:`repro_torch.core.collectives.shard_reduce_scatterv_start`).
    ``n`` need not divide the axis: trailing ranks update short, possibly
    empty, shards."""
    return ragged_seq_extents(n, R)


# priority for param-dim conflicts (earlier wins a contested mesh axis)
PRIORITY = ["e", "v", "f", "h", "a", "i", "c", "g", "q", "k", "m", "l"]


@dataclasses.dataclass(frozen=True)
class Recipe:
    mesh: Any  # repro_torch.core.dist.Mesh
    bindings: dict[str, Any]  # param dim -> mesh axis (None = replicate)
    act_specs: dict[str, Spec]  # activation kind -> spec
    attn_mode: str  # 'tp' | 'sp'
    batch_axes: tuple[str, ...]
    # sp only: rotate seq-sharded KV blocks through the explicit
    # double-buffered model-axis ring
    sp_ring: bool = False

    def spec(self, kind: str) -> Spec | None:
        return self.act_specs.get(kind)

    def param_pspecs(self, spec_tree):
        """Every weight's spec under the bindings (the reference's
        ``Recipe.param_pspecs``; trailing ``None`` entries dropped)."""
        from .module import param_pspecs

        return param_pspecs(spec_tree, self.bindings, priority=PRIORITY)


def make_recipe(cfg, mesh, *, attn_mode: str = "auto",
                overrides: Mapping[str, Any] | None = None,
                act_overrides: Mapping[str, Spec] | None = None) -> Recipe:
    """Derive the standard FSDP(data) x TP/SP(model) recipe for ``cfg`` on
    ``mesh`` (a :class:`repro_torch.core.dist.Mesh`, or anything with its
    ``shape`` dict and ``axis_names``), as the reference does:

    * weights: ``m`` (d_model) over ``data``, ``f``/``v``/``e``/heads over
      ``model``, each only where it divides;
    * batch over ``data`` (and ``pod`` when present);
    * attention ``tp`` when the head count divides the model axis, else
      ``sp``; ``attn_mode="sp_ring"`` is ``sp`` with the KV ring."""
    axes = set(mesh.axis_names)
    model_ax = "model" if "model" in axes else None
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    B = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    msize = mesh.shape[model_ax] if model_ax else 1

    sp_ring = attn_mode == "sp_ring"
    if sp_ring:
        attn_mode = "sp"  # the ring is an sp sub-mode: same specs except kv
    if attn_mode == "auto":
        attn_mode = "tp" if (model_ax and cfg.n_heads % msize == 0) else "sp"

    bind: dict[str, Any] = {}
    if model_ax:
        def mbind(dim: str, size: int):
            if size % msize == 0:
                bind[dim] = model_ax

        mbind("v", cfg.vocab_padded)
        mbind("f", cfg.d_ff)
        if cfg.n_experts:
            mbind("e", cfg.n_experts)
        if attn_mode == "tp":
            mbind("h", cfg.n_heads)
            mbind("g", cfg.n_kv)
        if cfg.family == "ssm":
            mbind("a", cfg.d_model)
        if cfg.family == "hybrid":
            d_inner = cfg.ssm_expand * cfg.d_model
            mbind("i", 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                  + d_inner // cfg.ssm_head_dim)
            if d_inner % msize or (d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) % msize:
                bind.pop("i", None)
            mbind("c", d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    if "data" in axes and cfg.d_model % mesh.shape["data"] == 0:
        bind["m"] = "data"  # FSDP: d_model over data
    bind.update(overrides or {})

    mp = model_ax
    g_div = model_ax and cfg.n_kv % msize == 0
    h_div = model_ax and cfg.n_heads % msize == 0
    sp = attn_mode == "sp"
    experts_div = cfg.n_experts and cfg.n_experts % max(msize, 1) == 0
    act: dict[str, Spec] = {
        "tokens": (B, None),
        "hidden": (B, None, None),
        "logits": (B, None, mp),
        # attention internals (b, h|g, s, d)
        "q": (B, mp, None, None) if (not sp and h_div) else (B, None, mp if sp else None, None),
        # sp_ring: K/V shard their seq dim too (the ring rotates the blocks)
        "kv": (B, mp, None, None) if (not sp and g_div) else (
            (B, None, mp, None) if sp_ring else (B, None, None, None)),
        "attn_out": (B, mp, None, None) if (not sp and h_div) else (B, None, mp if sp else None,
                                                                    None),
        "ffn_h": (B, None, mp if (cfg.d_ff % max(msize, 1) == 0) else None),
        "cache_kv": (B, mp, None, None) if g_div else (B, None, mp, None),
        "cache_mla": (B, mp, None),
        "moe_buf": (mp, None, None) if experts_div else (None, None, None),
        "moe_buf_g": (B, mp, None, None) if experts_div else (B, None, None, None),
        "moe_ep_buf": (tuple(batch_axes) + (model_ax,) if model_ax else B, None, None),
        "moe_tok": (B, None),
        "state_rwkv": (B, mp, None, None) if (cfg.n_heads % max(msize, 1) == 0)
        else (B, None, None, mp),
        "state_mamba": (B, mp, None, None),
        "enc": (B, None, None),
    }
    if cfg.family == "hybrid" and model_ax:
        d_inner = cfg.ssm_expand * cfg.d_model
        if (d_inner // cfg.ssm_head_dim) % msize:
            act["state_mamba"] = (B, None, mp, None)
    if sp and sp_ring:
        # pure sequence parallelism: the residual stream and the FFN hidden
        # stay seq-sharded over ``model`` between blocks
        act["hidden"] = (B, mp, None)
        act["ffn_h"] = (B, mp, None)
    act.update(act_overrides or {})
    if cfg.n_experts and model_ax and msize > 1 and cfg.n_experts % msize != 0:
        warnings.warn(
            f"make_recipe: n_experts={cfg.n_experts} does not divide the model axis "
            f"({msize}); the 'moe_buf'/'moe_buf_g' kinds replicate the expert buffers",
            stacklevel=2,
        )
    return Recipe(mesh=mesh, bindings=bind, act_specs=act, attn_mode=attn_mode,
                  batch_axes=batch_axes, sp_ring=sp_ring)


def fit_spec(spec: Spec, shape: tuple, mesh) -> Spec:
    """``spec`` with the entries whose mesh-axis product does not divide
    their dim dropped (a batch of 1 cannot shard over data = 2), padded
    with ``None`` to one entry per dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            if dim % math.prod(mesh.shape[a] for a in axes):
                entry = None
        out.append(entry)
    return tuple(out)


def _batch_entry(recipe: Recipe):
    b = recipe.batch_axes
    return b if len(b) > 1 else (b[0] if b else None)


def _batch_spec(recipe: Recipe, name: str, shape) -> Spec:
    spec = recipe.spec("tokens") if name in ("tokens", "labels", "loss_mask") else \
        recipe.spec("hidden") if name == "embeds" else \
        recipe.spec("enc") if name == "image_embeds" else ()
    return fit_spec(spec or (), tuple(shape), recipe.mesh)


def batch_shardings(recipe: Recipe, batch) -> dict:
    """Each leaf's spec of a batch dict (tokens, labels, loss_mask), after
    :func:`fit_spec`: the reference's ``batch_shardings``, with the spec
    tuple in place of a ``NamedSharding``."""
    return {name: _batch_spec(recipe, name, leaf.shape) for name, leaf in batch.items()}


class RankBatch(dict):
    """This rank's blocks of a batch's leaves under a recipe, as
    :func:`local_batch` cuts them: the form every entry point takes under
    an active recipe (``lm.forward``, ``lm.loss_fn``, ``lm.decode_step``
    and the trainer's steps).  ``shapes`` holds each leaf's global shape,
    which the blocks alone cannot tell (6 rows on 4 ``data`` ranks are
    either a 24-row batch split or a 6-row batch held whole);
    ``microbatches`` is the number of microbatches the rows are laid out
    for (:func:`local_batch`), 1 for the block of one batch or of one
    microbatch."""

    def __init__(self, blocks, shapes, microbatches: int = 1):
        super().__init__(blocks)
        self.shapes = {name: tuple(s) for name, s in shapes.items()}
        self.microbatches = microbatches

    def map(self, fn) -> "RankBatch":
        """``fn`` applied to every block (a move to the device, a cast), the
        global shapes kept."""
        return RankBatch({k: fn(v) for k, v in self.items()}, self.shapes, self.microbatches)


def _leaf_spec(recipe: Recipe, name: str, shape, *, decode: bool) -> Spec:
    """One leaf's spec under :func:`batch_shardings` for a leaf of global
    ``shape`` (one microbatch's); ``decode`` cuts the rows alone, the
    sequence whole."""
    spec = _batch_spec(recipe, name, shape)
    return spec[:1] + (None,) * (len(spec) - 1) if decode else spec


def _micro_shape(name, shape, k: int) -> tuple:
    shape = tuple(shape)
    if shape[0] % k:
        raise ValueError(f"batch {shape[0]} (leaf {name!r} of shape {shape}) does not divide "
                         f"into {k} microbatches")
    return (shape[0] // k,) + shape[1:]


def local_batch_shapes(recipe: Recipe, shapes, *, microbatches: int = 1,
                       decode: bool = False) -> dict:
    """``{name: shape}`` of this rank's blocks (:func:`local_batch`) of a
    batch whose leaves have the global ``shapes``, without a batch."""
    out = {}
    for name, shape in shapes.items():
        shape = _micro_shape(name, shape, microbatches)
        loc = local_shape(shape, _leaf_spec(recipe, name, shape, decode=decode), recipe.mesh)
        out[name] = (microbatches * loc[0],) + loc[1:]
    return out


def local_batch(recipe: Recipe, batch, *, microbatches: int = 1,
                decode: bool = False) -> RankBatch:
    """This rank's blocks of the whole ``batch`` (numpy arrays or tensors;
    cut on the host, so that only the blocks reach the device), as the
    reference places a batch by :func:`batch_shardings`: token ids,
    labels, the mask and the VLM's image by rows over the batch axes, the
    audio family's ``embeds`` by the ``hidden`` spec (under ``sp_ring``
    also by sequence over ``model``, where it divides S).  A dim the axes
    do not divide is held whole (:func:`fit_spec`: B = 1 on every rank).
    ``decode``: the rows alone, every leaf's sequence whole (a decode
    step's input).

    With ``microbatches=k`` the global batch is taken as ``k`` consecutive
    microbatches of ``B/k`` rows (the trainer's split) and the block lays
    out this rank's rows of each, microbatch 0's first
    (:func:`batch_rows` of ``B/k``), so that the trainer's consecutive split
    of the block gives each microbatch's block.  The result carries the
    global shapes (:class:`RankBatch`)."""
    if isinstance(batch, RankBatch):
        raise TypeError("local_batch: the batch is already this rank's blocks")
    k = microbatches
    mesh = recipe.mesh
    coords = mesh.coords()
    blocks, shapes = {}, {}
    for name, x in batch.items():
        shape = _micro_shape(name, x.shape, k)
        idx = [slice(None)]  # every microbatch
        for n, entry in zip(shape, _leaf_spec(recipe, name, shape, decode=decode)):
            if entry is None:
                idx.append(slice(None))
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            sizes = [mesh.shape[a] for a in axes]
            size = n // math.prod(sizes)
            i = mixed_radix_join([coords[a] for a in axes], sizes)
            idx.append(slice(i * size, (i + 1) * size))
        blk = x.reshape((k,) + shape)[tuple(idx)]
        blk = blk.reshape((k * blk.shape[1],) + tuple(blk.shape[2:]))
        blocks[name] = blk.contiguous() if isinstance(blk, torch.Tensor) else \
            np.ascontiguousarray(blk)
        shapes[name] = tuple(x.shape)
    return RankBatch(blocks, shapes, k)


def rank_batch(recipe: Recipe, batch, fn: str, *, decode: bool = False) -> RankBatch:
    """``batch`` checked to be this rank's blocks of one batch under
    ``recipe`` (a :class:`RankBatch` of one microbatch whose blocks have
    the shapes :func:`local_batch` cuts): what ``fn``, an entry point,
    takes.  A whole dict raises ``TypeError``: no entry point narrows a
    whole batch."""
    if not isinstance(batch, RankBatch):
        raise TypeError(f"{fn}: under a recipe the batch is this rank's blocks, "
                        f"sharding.local_batch(recipe, batch), not a whole {type(batch).__name__}")
    if batch.microbatches != 1:
        raise ValueError(f"{fn}: the blocks are laid out for {batch.microbatches} microbatches: "
                         "split them first (the trainer's step does)")
    want = local_batch_shapes(recipe, batch.shapes, decode=decode)
    for name, x in batch.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{fn}: leaf {name!r} has shape {tuple(x.shape)}, this rank's "
                             f"block of {batch.shapes[name]} is {want[name]}")
    return batch


def decode_state_shardings(recipe: Recipe, state):
    """Each leaf's spec of a decode state (the stacked caches and states,
    whole shapes; a tensor on the ``meta`` device will do), after
    :func:`fit_spec`, in the state's own structure: the reference's
    ``decode_state_shardings``.  Leading stack dims (layers, super-blocks)
    replicate; the trailing dims take the recipe's cache and state specs, so
    the K/V caches shard their heads over ``model`` where the KV groups
    divide it, else their sequence; lengths and positions replicate."""
    B = _batch_entry(recipe)
    kinds = {"k": "cache_kv", "v": "cache_kv", "c": "cache_mla", "kr": "cache_mla",
             "wkv": "state_rwkv", "ssm": "state_mamba"}

    def one(name, leaf):
        nd = leaf.ndim
        if name in kinds:
            spec = recipe.spec(kinds[name])
        elif name in ("shift", "cm_shift"):
            spec = (B, None)
        elif name == "conv":
            spec = (B, None, None)
        else:  # lengths, positions
            spec = ()
        spec = (None,) * (nd - len(spec)) + tuple(spec) if spec else ()
        return fit_spec(spec, tuple(leaf.shape), recipe.mesh)

    def walk(x, name):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v, f) for f, v in zip(x._fields, x)))
        return one(name, x)

    return walk(state, None)


def recipe_pspecs(recipe: Recipe, spec_tree):
    """:meth:`Recipe.param_pspecs` with one entry per buffer axis (what
    :func:`repro_torch.models.weights.shard_params` cuts by)."""
    pspecs = recipe.param_pspecs(spec_tree)

    def pad(s, p):
        return tuple(p) + (None,) * (len(s.shape) - len(p))

    return _map2(pad, spec_tree, pspecs)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` buffer cut by ``spec``."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            n //= math.prod(mesh.shape[a] for a in axes)
        out.append(n)
    return tuple(out)


def spec_axes(spec) -> tuple:
    """The mesh axes a spec names, in order."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` in x's dtype, accumulated and returned in
    float32 (the reference's ``preferred_element_type=float32``): a
    tensor-parallel partial, summed over the ranks before it is rounded
    once to the activation dtype.  On the card, cuBLAS's bf16 product with
    a float32 output (no upcast copies, and a tensor-core GEMM); on the CPU,
    or when a gradient is wanted, a product of float32 upcasts (exact:
    the product of two bf16 values is exact in float32)."""
    w = w.to(x.dtype)
    if on_card(x) and x.dtype != torch.float32 and not (
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


_CURRENT: list[Recipe] = []


@contextlib.contextmanager
def use_recipe(recipe: Recipe | None):
    """Make ``recipe`` the active one inside the block (``None``: no
    change)."""
    if recipe is None:
        yield
        return
    _CURRENT.append(recipe)
    try:
        yield
    finally:
        _CURRENT.pop()


def current_recipe() -> Recipe | None:
    return _CURRENT[-1] if _CURRENT else None


@dataclasses.dataclass(frozen=True)
class TokenShard:
    """This rank's block of a ``(B, S)`` token grid under an ``sp_ring``
    recipe: batch rows ``[row0, row0 + n_rows)`` (the batch split over
    ``batch_axes``; none, and every row, when they do not divide it) and
    sequence chunk ``chunk`` of the ``R = |model|`` chunks of ``cap``
    positions the sequence pads to (:func:`ragged_seq_extents`)."""

    mesh: Any
    batch_axes: tuple[str, ...]
    B: int
    S: int
    cap: int
    row0: int
    n_rows: int
    chunk: int

    def gather(self, x):
        """The whole ``(B, S, ...)`` grid from every rank's ``(n_rows, cap,
        ...)`` block, padding dropped; the same on every rank.

        Differentiable for a consumer that every rank runs alike (the LM
        head and its loss): the backward hands this rank its own block of
        the cotangent (:meth:`local`), which is the whole gradient of that
        block because every rank's cotangent is the same."""
        x = all_gather(x, self.mesh, "model", 1, split=False)[:, :self.S]
        for a in reversed(self.batch_axes):  # innermost batch axis first
            x = all_gather(x, self.mesh, a, 0, split=False)
        return x

    def partial(self, t):
        """``t``, a tensor every rank holds whole (a parameter), as used by
        this rank's block of the grid.  The forward is the identity; the
        backward sums the cotangent over the ranks that hold the other
        blocks (``model`` and the split batch axes), so a parameter's
        gradient comes out whole on every rank: the transpose of a
        replicated operand's broadcast, which GSPMD inserts by itself."""
        return sum_grads(t, self.mesh, ("model",) + self.batch_axes)

    def local(self, y):
        """This rank's ``(n_rows, cap, ...)`` block of a whole ``(B, S, ...)``
        grid, zero-padded past ``S``: for a tensor the program made whole
        (the whole grid's MoE output), never for the batch, which enters as
        this rank's blocks (:func:`local_batch`)."""
        return self.local_seq(y[self.row0:self.row0 + self.n_rows])

    def gather_seq(self, x):
        """The whole ``(n_rows, S, ...)`` sequence of this rank's rows from
        every ``model`` rank's ``(n_rows, cap, ...)`` chunk, padding dropped:
        the input of a recurrent mixer, which scans the whole sequence on
        every rank (the reference's GSPMD program gathers it so).  Each rank
        keeps only its chunk of what it computes from it
        (:meth:`local_seq`), so its cotangent is a partial: the backward
        reduce-scatters it over ``model``."""
        return all_gather(x, self.mesh, "model", 1, split=True)[:, :self.S]

    def local_seq(self, y):
        """This rank's ``(n_rows, cap, ...)`` chunk of a whole ``(n_rows, S,
        ...)`` sequence of its rows, zero-padded past ``S``: the inverse of
        :meth:`gather_seq`."""
        R = self.mesh.shape.get("model", 1)
        y = torch.nn.functional.pad(y, [0, 0] * (y.ndim - 2) + [0, R * self.cap - self.S])
        return y[:, self.chunk * self.cap:(self.chunk + 1) * self.cap]


def token_shard(recipe: Recipe, B: int, S: int) -> TokenShard:
    """This process's :class:`TokenShard` of a ``(B, S)`` token grid under
    ``recipe`` (the ``tokens`` spec's batch axes, where they divide B)."""
    mesh = recipe.mesh
    batch_axes, row0, n_rows = batch_rows(recipe, B)
    cap, _ = ragged_seq_extents(S, mesh.shape.get("model", 1))
    return TokenShard(mesh=mesh, batch_axes=batch_axes, B=B, S=S, cap=cap, row0=row0,
                      n_rows=n_rows, chunk=mesh.coords().get("model", 0))


def batch_rows(recipe: Recipe, B: int) -> tuple[tuple[str, ...], int, int]:
    """``(batch_axes, row0, n_rows)``: this process's rows of a ``B``-row
    batch, split over the ``tokens`` spec's batch axes where they divide B
    (no axes, and every row, otherwise)."""
    mesh = recipe.mesh
    entry = fit_spec(recipe.spec("tokens")[:1], (B,), mesh)[0]
    batch_axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    sizes = [mesh.shape[a] for a in batch_axes]
    n_rows = B // math.prod(sizes)
    coords = mesh.coords()
    return batch_axes, mixed_radix_join([coords[a] for a in batch_axes], sizes) * n_rows, n_rows


def logits_spec(recipe: Recipe, B: int) -> Spec:
    """The spec of the ``(B, S, vocab_padded)`` logits of a ``B``-row batch
    as every rank of the port holds them under ``recipe``: the recipe's
    ``logits`` spec, rows over the batch axes where they divide B
    (:func:`batch_rows`), the vocab over ``model`` where the recipe cuts
    ``v`` (the head's columns), else whole."""
    batch_axes, _, _ = batch_rows(recipe, B)
    rows = None if not batch_axes else batch_axes[0] if len(batch_axes) == 1 else batch_axes
    cut = recipe.mesh.shape.get("model", 1) > 1 and recipe.bindings.get("v") == "model"
    return (rows, None, "model" if cut else None)


class _SumPartials(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over mesh axes
    (:meth:`TokenShard.partial`), through the comm layer's
    ``MPI_Iallreduce``."""

    @staticmethod
    def forward(ctx, mesh, axes, t):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, d):
        for a in ctx.axes:
            d = shard_all_reduce_start(d, a, mesh=ctx.mesh).wait()
        return None, None, d


# ------------------------------------------------- the per-rank program ----

def _wants_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(x, mesh, axis: str, dim: int, *, split: bool):
    """``x`` gathered over mesh ``axis`` along ``dim`` (rank order).  Its
    backward: the cotangent reduce-scattered over ``axis`` when the ranks'
    work is split there (``split``: each holds a partial of the whole
    cotangent), else this rank's own block of it (every rank holds the
    whole, the same).  Nothing moves on an axis of one rank."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    if _wants_grad(x):
        return _Gather.apply(mesh, axis, dim, split, x)
    return shard_all_gather_start(x, axis, mesh=mesh, axis=dim).wait()


def all_reduce(x, mesh, axis: str):
    """The sum of ``x`` over mesh ``axis`` (tensor-parallel partials); its
    backward is the identity, every rank holding the whole cotangent."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    if _wants_grad(x):
        return _Reduce.apply(mesh, axis, x)
    return shard_all_reduce_start(x, axis, mesh=mesh).wait()


def scatter(x, mesh, axis: str, dim: int, *, split: bool):
    """This rank's block of ``x`` along ``dim`` over mesh ``axis`` (rank
    order; ``x``'s size there divides into the axis's ranks): the converse
    of :func:`all_gather`.  ``split``: each rank holds a partial of the
    whole, and the block is of their sum (a reduce-scatter); else every
    rank holds the same whole ``x`` and takes its own block.  Its backward
    all-gathers the cotangent, so every rank holds the whole of it.
    Nothing moves on an axis of one rank."""
    R = mesh.shape.get(axis, 1)
    if R == 1:
        return x
    if _wants_grad(x):
        return _Scatter.apply(mesh, axis, dim, split, x)
    if split:
        return shard_reduce_scatter_start(x, axis, mesh=mesh, axis=dim).wait()
    n = x.shape[dim] // R  # a copy: a view of the block would keep the whole alive
    return x.narrow(dim, mesh.coords()[axis] * n, n).clone()


def sum_grads(x, mesh, axes):
    """``x`` as it is, with its cotangent summed over ``axes`` in the
    backward: where a tensor every rank of ``axes`` holds whole (a weight,
    or the residual stream entering a tensor-parallel block) feeds work
    that the ranks split, each rank's cotangent is a partial."""
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes or not _wants_grad(x):
        return x
    return _SumPartials.apply(mesh, axes, x)


def gather_cut(t, spec, mesh, *, skip=(), split=()):
    """``t``, this rank's block of a buffer cut by ``spec``, gathered over
    every mesh axis the spec names but those in ``skip`` (the inverse of
    the cut: a dim cut over several axes is gathered innermost first).  Its
    backward (:func:`all_gather`) reduce-scatters over the axes in
    ``split`` and hands back this rank's block over the others."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            for a in reversed((entry,) if isinstance(entry, str) else tuple(entry)):
                if a not in skip:
                    t = all_gather(t, mesh, a, dim, split=a in split)
    return t


def sum_stat(x, mesh, axis: str):
    """The sum of ``x`` over mesh ``axis``, where each rank goes on to use
    the sum in work of its own (a norm's sum of squares over a dim the ranks
    cut): every rank's cotangent of the sum is a partial, so the backward
    sums them too."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    if _wants_grad(x):
        return _ReduceStat.apply(mesh, axis, x)
    return shard_all_reduce_start(x, axis, mesh=mesh).wait()


def lse_merge(s, c, mesh, axis: str):
    """``softmax(s) @ c`` over keys that the ranks of mesh ``axis`` hold in
    blocks, in float32: ``s (..., Tr)`` this rank's masked float32 scores of
    its block of keys (masked ones at the finite ``-1e30``), ``c (..., Tr,
    k)`` their values.  The ranks' partial softmaxes merge by their
    log-sum-exp: the max is all-reduced first, then each rank's sums
    ``sum exp(s - max)`` and unnormalized ``exp(s - max) @ c`` in one
    all-reduce.  A row whose keys are all masked on every rank comes out as
    the softmax of its ``-1e30`` scores does, the mean of every key's
    value; on a rank that sees none of a row's keys ``exp(-1e30 - max)``
    is 0.  The same result on every rank; no gradient (serving)."""
    mx = shard_all_reduce_start(s.amax(dim=-1, keepdim=True), axis, mesh=mesh, op="max").wait()
    p = torch.exp(s - mx)
    part = torch.cat([torch.matmul(p, c.float()), p.sum(dim=-1, keepdim=True)], dim=-1)
    part = shard_all_reduce_start(part, axis, mesh=mesh).wait()
    return part[..., :-1] / part[..., -1:]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, split, x):
        ctx.meta = (mesh, axis, dim, split, x.shape[dim])
        return shard_all_gather_start(x, axis, mesh=mesh, axis=dim).wait()

    @staticmethod
    def backward(ctx, d):
        mesh, axis, dim, split, n = ctx.meta
        if split:
            d = shard_reduce_scatter_start(d.contiguous(), axis, mesh=mesh, axis=dim).wait()
        else:  # a copy: a view of the block would keep the whole cotangent alive
            d = d.narrow(dim, mesh.coords()[axis] * n, n).clone()
        return None, None, None, None, d


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, split, x):
        ctx.meta = (mesh, axis, dim)
        return scatter(x, mesh, axis, dim, split=split)  # no grad in here: the plain path

    @staticmethod
    def backward(ctx, d):
        mesh, axis, dim = ctx.meta
        return None, None, None, None, shard_all_gather_start(d, axis, mesh=mesh, axis=dim).wait()


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        return shard_all_reduce_start(x, axis, mesh=mesh).wait()

    @staticmethod
    def backward(ctx, d):
        return None, None, d


class _ReduceStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.meta = (mesh, axis)
        return shard_all_reduce_start(x, axis, mesh=mesh).wait()

    @staticmethod
    def backward(ctx, d):
        mesh, axis = ctx.meta
        return None, None, shard_all_reduce_start(d.contiguous(), axis, mesh=mesh).wait()


@dataclasses.dataclass(frozen=True)
class Placement:
    """This rank's part of a ``tp`` or plain ``sp`` recipe's program over a
    ``(B, ...)`` batch: rows ``[row0, row0 + n_rows)`` (the batch split
    over ``batch_axes``, the ``tokens`` spec's axes where they divide B;
    none, and every row, otherwise), and the ``model`` axis of ``M`` ranks,
    this one at ``mr``."""

    recipe: Recipe
    batch_axes: tuple[str, ...]
    row0: int
    n_rows: int
    # set where the rows' residual stream is carried cut over ``model`` by
    # sequence (plain ``sp``'s cache-less forward): the rows' S positions
    # pad to M chunks of ``cap`` and this rank holds chunk ``mr``
    S: int | None = None

    @property
    def mesh(self):
        return self.recipe.mesh

    @property
    def cap(self) -> int:
        return ragged_seq_extents(self.S, self.M)[0]

    def chunk_positions(self, positions):
        """The ``(cap,)`` absolute positions of this rank's chunk, from the
        rows' ``(S,)`` ones; the padding's go on past the last (as
        :func:`repro_torch.models.lm._forward_sp_ring`'s)."""
        pad = torch.arange(self.M * self.cap - self.S, device=positions.device)
        pos = torch.cat([positions, positions[-1] + 1 + pad])
        return pos[self.mr * self.cap:(self.mr + 1) * self.cap]

    def gather_seq(self, x, dim: int = 1, *, split: bool = True):
        """The rows' whole sequence of ``S`` positions from every ``model``
        rank's chunk ``x`` (along ``dim``), the padding dropped: the
        counterpart of :meth:`TokenShard.gather_seq`.  ``split``: each rank
        goes on with work of its own on it (its ``f`` columns, its vocab
        block, its chunk's queries), so its cotangent is a partial and the
        backward reduce-scatters it; else every rank does the same work and
        the backward takes this rank's chunk of the cotangent."""
        return all_gather(x, self.mesh, "model", dim, split=split).narrow(dim, 0, self.S)

    def scatter_seq(self, y, *, split: bool = True):
        """This rank's ``(n_rows, cap, ...)`` chunk of the rows' whole
        ``(n_rows, S, ...)`` ``y``, padded past ``S`` with zeros: the
        counterpart of :meth:`TokenShard.local_seq`.  ``split``: ``y`` is
        this rank's partial and the chunk is of the ranks' sum (a
        reduce-scatter); else every rank holds the same ``y``.  Either
        way the backward all-gathers the cotangent (:func:`scatter`)."""
        if self.M * self.cap != self.S:  # rebound: the unpadded y goes before the scatter
            y = torch.nn.functional.pad(y, [0, 0] * (y.ndim - 2) + [0, self.M * self.cap - self.S])
        return scatter(y, self.mesh, "model", 1, split=split)

    def for_chunk(self, t):
        """Weight ``t``, whole on every ``model`` rank, used by this rank's
        chunk alone when the stream is cut by sequence (its gradient then
        summed over ``model``); else as it is."""
        return t if self.S is None else self.enter_model(t)

    @property
    def M(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def mr(self) -> int:
        return self.mesh.coords().get("model", 0)

    def local_rows(self, x):
        """This rank's rows of a whole ``(B, ...)`` tensor: the per-row
        positions and counts, which every rank holds whole, or a tensor the
        program made whole; never the batch, which enters as this rank's
        blocks (:func:`local_batch`)."""
        return x if not self.batch_axes else x.narrow(0, self.row0, self.n_rows)

    def gather_rows(self, x):
        """The whole ``(B, ...)`` tensor from every rank's rows; the
        backward hands each rank its own rows of the cotangent."""
        for a in reversed(self.batch_axes):  # innermost batch axis first
            x = all_gather(x, self.mesh, a, 0, split=False)
        return x

    def use(self, t, spec):
        """Weight ``t`` (this rank's block, cut by ``spec``) ready for this
        rank's work: gathered over every axis but ``model`` it is cut over
        (FSDP), and with its gradient summed over the batch axes that split
        the work and do not cut it."""
        t = gather_cut(t, spec, self.mesh, skip=("model",), split=self.batch_axes)
        return sum_grads(t, self.mesh, [a for a in self.batch_axes if a not in spec_axes(spec)])

    def use_tree(self, tree, specs):
        if isinstance(tree, dict):
            return {k: self.use_tree(v, specs[k]) for k, v in tree.items()}
        return self.use(tree, specs)

    def enter_model(self, x):
        """``x``, held whole by every ``model`` rank, entering work they
        split: the cotangent is summed over ``model`` in the backward."""
        return sum_grads(x, self.mesh, ("model",))

    def sum_model(self, x):
        return all_reduce(x, self.mesh, "model")

    def gather_model(self, x, dim: int):
        """The ``model`` ranks' blocks of ``x`` put together along ``dim``;
        every rank carries on with the same whole tensor, so the backward
        is this rank's own block of the cotangent."""
        return all_gather(x, self.mesh, "model", dim, split=False)

    def sum_model_stat(self, x):
        """:func:`sum_stat` over ``model``: a float32 per-row statistic of
        the columns this rank holds, summed over the ranks that hold the
        others (the Mamba2 gated norm's sum of squares)."""
        return sum_stat(x, self.mesh, "model")

    def block(self, t, dim: int, start: int, n: int, full: int, *, split: bool):
        """Block ``[start, start + n)`` along ``dim`` of a weight of ``full``
        entries there, ``t`` as this rank holds it: whole, or cut over
        ``model`` in rank order.  ``split``: the ``model`` ranks take
        different blocks (each weight's cotangent is then a partial);
        else every rank runs the same work on the same block.

        A cut that is already the block is used as it is; another cut is
        gathered first (its backward reduce-scatters where ``split``, else
        takes this rank's block); a whole weight is sliced, its gradient
        summed over ``model`` where ``split``."""
        if t.shape[dim] != full:
            if split and t.shape[dim] == n and start == self.mr * n:
                return t
            t = all_gather(t, self.mesh, "model", dim, split=split)
        elif split:
            t = self.enter_model(t)
        return t if n == full else t.narrow(dim, start, n)


def placement(recipe: Recipe, B: int) -> Placement:
    """This process's :class:`Placement` of a ``B``-row batch under
    ``recipe``.  Creates every mesh axis's process group first, in one
    order on every rank (group creation is collective)."""
    mesh = recipe.mesh
    for a in mesh.axis_names:
        mesh.create_groups((a,))
    batch_axes, row0, n_rows = batch_rows(recipe, B)
    return Placement(recipe=recipe, batch_axes=batch_axes, row0=row0, n_rows=n_rows)
