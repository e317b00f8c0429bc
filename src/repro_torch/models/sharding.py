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
there is no ``shard_act``: the code that runs under a recipe cuts its own
chunks.  In this slice a recipe distributes the sequence over ``model`` and
the batch over the ``data`` axes, under the sequence-parallel ring mode
(``attn_mode="sp_ring"``, :func:`repro_torch.models.lm.forward`): every rank
keeps its contiguous, padded chunk of the residual stream through the
blocks and the attention runs as a double-buffered ring of KV blocks
(:func:`repro_torch.models.attention.ring_attention_seq`).  A MoE block
takes the chunk (:class:`TokenShard` says which block of the token grid it
is) by expert parallelism or by the whole grid's dispatch
(:func:`repro_torch.models.ffn.moe_ffn`).  Parameters stay whole on every
rank; the FSDP and tensor-parallel weight bindings are derived here and
wait for the GSPMD-form slice (ROADMAP.md queue 1, item 8c).  Training
under the recipe differentiates through the ring and the final gather and
sums each parameter's partial gradients over the ranks
(:meth:`TokenShard.partial`).

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

import torch

from repro_torch.core.dims import mixed_radix_join
from repro_torch.core.p2p import shard_all_gather_start, shard_all_reduce_start

__all__ = ["Recipe", "make_recipe", "use_recipe", "current_recipe", "fit_spec",
           "ragged_seq_extents", "ragged_expert_extents", "ragged_grad_extents", "TokenShard",
           "token_shard", "PRIORITY"]

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
        if torch.is_grad_enabled() and x.requires_grad:
            return _GatherGrid.apply(self, x)
        return self._gather(x)

    def _gather(self, x):
        if self.mesh.shape.get("model", 1) > 1:
            x = shard_all_gather_start(x, "model", mesh=self.mesh, axis=1).wait()
        x = x[:, :self.S]
        for a in reversed(self.batch_axes):  # innermost batch axis first
            x = shard_all_gather_start(x, a, mesh=self.mesh, axis=0).wait()
        return x

    def partial(self, t):
        """``t``, a tensor every rank holds whole (a parameter), as used by
        this rank's block of the grid.  The forward is the identity; the
        backward sums the cotangent over the ranks that hold the other
        blocks (``model`` and the split batch axes), so a parameter's
        gradient comes out whole on every rank: the transpose of a
        replicated operand's broadcast, which GSPMD inserts by itself."""
        if not (torch.is_grad_enabled() and t.requires_grad):
            return t
        axes = tuple(a for a in ("model",) + self.batch_axes if self.mesh.shape.get(a, 1) > 1)
        return _SumPartials.apply(self.mesh, axes, t) if axes else t

    def local(self, y):
        """This rank's ``(n_rows, cap, ...)`` block of a whole ``(B, S, ...)``
        grid, zero-padded past ``S``."""
        y = y[self.row0:self.row0 + self.n_rows]
        R = self.mesh.shape.get("model", 1)
        y = torch.nn.functional.pad(y, [0, 0] * (y.ndim - 2) + [0, R * self.cap - self.S])
        return y[:, self.chunk * self.cap:(self.chunk + 1) * self.cap]


def token_shard(recipe: Recipe, B: int, S: int) -> TokenShard:
    """This process's :class:`TokenShard` of a ``(B, S)`` token grid under
    ``recipe`` (the ``tokens`` spec's batch axes, where they divide B)."""
    mesh = recipe.mesh
    entry = fit_spec(recipe.spec("tokens")[:1], (B,), mesh)[0]
    batch_axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    sizes = [mesh.shape[a] for a in batch_axes]
    n_rows = B // math.prod(sizes)
    coords = mesh.coords()
    row0 = mixed_radix_join([coords[a] for a in batch_axes], sizes) * n_rows
    cap, _ = ragged_seq_extents(S, mesh.shape.get("model", 1))
    return TokenShard(mesh=mesh, batch_axes=batch_axes, B=B, S=S, cap=cap, row0=row0,
                      n_rows=n_rows, chunk=coords.get("model", 0))


class _GatherGrid(torch.autograd.Function):
    """:meth:`TokenShard.gather` with a gradient: the backward is this
    rank's own block of the cotangent (:meth:`TokenShard.local`)."""

    @staticmethod
    def forward(ctx, shard, x):
        ctx.shard = shard
        return shard._gather(x)

    @staticmethod
    def backward(ctx, d):
        return None, ctx.shard.local(d)


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
