"""The train steps: loss and gradients with microbatch accumulation, and
the AdamW update, as one program per rank (the reference's GSPMD baseline)
and as the explicit ZeRO-2 comm program.  The port of
``src/repro/train/trainer.py``.

``make_train_step(cfg, recipe, ocfg, microbatches=k)`` is the baseline:
without a recipe it is the single-device step (the numerics oracle); under
a recipe every rank is handed its blocks of the batch
(``sharding.local_batch(recipe, batch, microbatches=k)``: its rows of
each microbatch, one microbatch after another), runs its part of
:func:`repro_torch.models.lm.forward`
and its backward on its shards of the parameters
(``weights.shard_params_by_recipe``), the gradients flowing back through
the explicit collectives (:class:`repro_torch.models.sharding.Placement`;
under ``sp_ring`` the ring's transfers carry the gradient back and the
partial gradients are summed over the ranks), so each rank gets the
gradients of its shards and AdamW updates them; the global clip norm adds
each shard's squares once.  Under ``sp_ring`` whole parameters are taken
too, and every rank then computes the same whole update.

``make_zero_train_step(cfg, mesh, ocfg, ...)`` is the training twin of the
tensor-parallel decode (:mod:`repro_torch.serve.tp_decode`): one rank's
program over the ``data`` axis that states its communication, declared as
a :func:`repro_torch.core.plan.bucket` comm plan:

  * gradients pack into size-thresholded, dtype-homogeneous **buckets**
    (MPI counts/displacements over the flattened param tree,
    :mod:`repro_torch.train.buckets`);
  * each bucket's ``MPI_Ireduce_scatter``
    (:func:`repro_torch.core.collectives.shard_reduce_scatterv_start`) is
    issued before any wait: every reduction in flight at once;
  * the global clip norm is one scalar all-reduce of the per-shard sums of
    squares;
  * AdamW runs on this rank's **1/R optimizer shard** only
    (:func:`repro_torch.train.optimizer.init_zero_opt_state`);
  * each updated parameter shard's ``MPI_Iallgatherv``
    (:func:`~repro_torch.core.collectives.shard_all_gatherv_start`)
    regathers the whole parameters for the next forward.

Microbatching (both steps): the batch splits into ``k`` microbatches whose
gradients add up in a Python loop (the reference's ``lax.scan``), then
divide by ``k``; per-microbatch aux metrics are averaged alongside the
loss.  Microbatch ``i`` is rows ``[i*B/k, (i+1)*B/k)`` of the global batch;
under a recipe the rank's blocks hold its rows of each in that order, so
the same consecutive split of the blocks gives each microbatch's.  Remat
comes from ``cfg.remat`` inside the model.  Parameters are
float32 masters and stay so: the gradients are float32 (see
:mod:`repro_torch.models.lm`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.collectives import shard_all_gatherv_start, shard_reduce_scatterv_start
from repro_torch.core.p2p import shard_all_reduce_start
from repro_torch.core.plan import bucket as bucket_plan
from repro_torch.core.plan import intent_of
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.sharding import RankBatch, recipe_pspecs, spec_axes, use_recipe

from .buckets import assign_buckets, pack_bucket, unpack_bucket
from .optimizer import (OptConfig, OptState, _clip_scale, _step_scalars, adamw_leaf_update,
                        apply_updates, compress_leaf, lr_at_step)

__all__ = ["make_train_step", "make_eval_step", "make_serve_step", "make_zero_train_step",
           "make_zero_update", "zero_local_batch",
           "ZERO_TRAIN_PLAN_INTENT", "OPTIMIZER_RANGE", "zero_train_buckets"]

# the declared overlap intent of the bucketed gradient schedule
ZERO_TRAIN_PLAN_INTENT = intent_of("bucket")
# the profiler range around the optimizer's update, which a device-time
# breakdown reads
OPTIMIZER_RANGE = "train.optimizer"


def _split_batch(batch, k: int) -> list[dict]:
    """``k`` microbatches of ``batch``: each leaf's leading (batch) dim cut
    into ``k`` consecutive blocks.  A :class:`RankBatch` must be laid out
    for ``k`` microbatches; each part is then the rank's blocks of one
    microbatch, whose global shapes have ``B/k`` rows."""
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} (leaf {name!r} of shape {tuple(x.shape)}) "
                             f"does not divide into {k} microbatches")
    parts = [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
              for name, x in batch.items()} for i in range(k)]
    if not isinstance(batch, RankBatch):
        return parts
    if batch.microbatches != k:
        raise ValueError(f"the rank's blocks are laid out for {batch.microbatches} microbatches, "
                         f"the step takes {k}: sharding.local_batch(..., microbatches={k})")
    shapes = {name: (s[0] // k,) + s[1:] for name, s in batch.shapes.items()}
    return [RankBatch(part, shapes) for part in parts]


def _rank_blocks(recipe, batch, fn: str, microbatches: int = 1):
    """``batch`` as a step under ``recipe`` takes it: this rank's blocks
    (a :class:`RankBatch`) laid out for the step's ``microbatches``; a
    whole dict raises ``TypeError``."""
    if recipe is None:
        return batch
    if not isinstance(batch, RankBatch):
        raise TypeError(f"{fn}: under a recipe the batch is this rank's blocks, "
                        "sharding.local_batch(recipe, batch, microbatches=...), not a whole "
                        f"{type(batch).__name__}")
    if batch.microbatches != microbatches:
        raise ValueError(f"{fn}: the rank's blocks are laid out for {batch.microbatches} "
                         f"microbatches, the step takes {microbatches}")
    return batch


def _accum_loss_grads(params, batch, cfg, microbatches: int):
    """``(loss, metrics, grads)``: the loss and metrics detached float32
    scalars, the gradients a float32 tree shaped like ``params``, summed
    over the microbatches and divided by their count (the reference's
    scan, which starts from zeros)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    parts = [batch] if microbatches == 1 else _split_batch(batch, microbatches)
    loss_sum, metric_sum = None, None
    for micro in parts:
        loss, metrics = lm.loss_fn(live, micro, cfg)
        loss.backward()  # sums into the leaves' .grad: g1 + g2 + ...
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        metric_sum = metrics if metric_sum is None else \
            {k: metric_sum[k] + v for k, v in metrics.items()}
    grads = [p.grad for p in leaves]
    if microbatches > 1:
        grads = [g / microbatches for g in grads]
        loss_sum = loss_sum / microbatches
        metric_sum = {k: v / microbatches for k, v in metric_sum.items()}
    return loss_sum, metric_sum, tree_unflatten(params, grads)


def make_train_step(cfg, recipe, ocfg: OptConfig, *, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    metrics)``: the gradients of :func:`repro_torch.models.lm.loss_fn`
    (under ``recipe`` when one is given) and one AdamW step
    (:func:`repro_torch.train.optimizer.apply_updates`).  Under ``recipe``
    ``batch`` is this rank's blocks laid out for the step's microbatches
    (``sharding.local_batch(recipe, batch, microbatches=microbatches)``).
    ``params`` are not modified; ``metrics`` holds ``loss``, the loss function's metrics,
    ``grad_norm`` and ``lr``."""

    def train_step(params, opt_state, batch):
        batch = _rank_blocks(recipe, batch, "make_train_step", microbatches)
        with use_recipe(recipe):
            loss, metrics, grads = _accum_loss_grads(params, batch, cfg, microbatches)
        cut = None if recipe is None else _shard_cut(params, cfg, recipe)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            new_params, new_opt, opt_metrics = apply_updates(params, grads, opt_state, ocfg,
                                                             cut=cut)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def _shard_cut(params, cfg, recipe):
    """``apply_updates``'s ``cut`` for this rank's shards under ``recipe``
    (``None`` when no leaf is cut): the leaves' sums of squares added per
    group of leaves cut over the same mesh axes, each group's sum added
    over those axes once; and each cut leaf's int8 ``amax``, the largest
    magnitude over its shards."""
    mesh = recipe.mesh
    for a in mesh.axis_names:  # group creation is collective: one order on every rank
        mesh.create_groups((a,))
    specs = lm.build_specs(cfg)

    def axes_of(t, spec, pspec):
        if isinstance(t, dict):
            return {k: axes_of(t[k], spec[k], pspec[k]) for k in t}
        if tuple(t.shape) == spec.shape:
            return ()
        return tuple(a for a in spec_axes(pspec) if mesh.shape[a] > 1)

    axes = axes_of(params, specs, recipe_pspecs(recipe, specs))
    leaf_axes = tree_leaves(axes)
    if not any(leaf_axes):
        return None

    def reduce_sq(sums):
        groups: dict = {}
        for sq, ax in zip(sums, leaf_axes):
            groups[ax] = groups[ax] + sq if ax in groups else sq
        total = None
        for ax, g in groups.items():
            for a in ax:
                g = shard_all_reduce_start(g, a, mesh=mesh).wait()
            total = g if total is None else total + g
        return total

    def amax_for(ax):
        def amax(m):
            m = m.clone()
            for a in ax:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group((a,)))
            return m
        return amax if ax else None

    return reduce_sq, tree_map(amax_for, axes)


def make_eval_step(cfg, recipe):
    """``eval_step(params, batch) -> {"loss", ...}`` without a gradient;
    under ``recipe`` ``batch`` is this rank's blocks
    (``sharding.local_batch(recipe, batch)``)."""
    def eval_step(params, batch):
        batch = _rank_blocks(recipe, batch, "make_eval_step")
        with use_recipe(recipe), torch.no_grad():
            loss, metrics = lm.loss_fn(params, batch, cfg)
        return {"loss": loss, **metrics}

    return eval_step


def make_serve_step(cfg, recipe):
    """``serve_step(params, state, batch) -> (logits, new_state)``: one
    :func:`repro_torch.models.lm.decode_step` under ``recipe``, without a
    gradient (the reference's ``make_serve_step``; the dry run's decode
    program).  Under ``recipe`` ``batch`` is this rank's rows
    (``sharding.local_batch(recipe, batch, decode=True)``) and the logits
    are this rank's block, as the reference's step returns its cut array
    (``lm.gather_logits``)."""
    def serve_step(params, state, batch):
        batch = _rank_blocks(recipe, batch, "make_serve_step")
        with use_recipe(recipe), torch.no_grad():
            return lm.decode_step(params, state, batch, cfg)

    return serve_step


# ====================================================== explicit ZeRO step ====

def zero_local_batch(mesh, batch) -> dict:
    """This rank's block of the global ``batch`` for
    :func:`make_zero_train_step`: rows ``[r*n, (r+1)*n)`` of every leaf,
    ``r`` the rank's ``data`` coordinate and ``n = B / |data|`` (the
    reference's ``shard_map`` block ``P("data")``).  Numpy arrays or
    tensors; cut on the host, so that only the block reaches the device."""
    R = _data_ranks(mesh)
    r = mesh.coords()["data"]
    out = {}
    for name, x in batch.items():
        if x.shape[0] % R:
            raise ValueError(f"global batch {x.shape[0]} (leaf {name!r}) does not split over "
                             f"{R} data ranks")
        n = x.shape[0] // R
        out[name] = x[r * n:(r + 1) * n]
    return out

def zero_train_buckets(cfg, *, bucket_bytes: int, ranks: int):
    """The step's bucket tables, from the parameter specs (no allocation)."""
    return assign_buckets(lm.build_specs(cfg), bucket_bytes=bucket_bytes, ranks=ranks)


def _data_ranks(mesh) -> int:
    if "data" not in mesh.shape:
        raise ValueError(f"zero train step needs a 'data' mesh axis, have {dict(mesh.shape)}")
    for name, size in mesh.shape.items():
        if name != "data" and size != 1:
            raise ValueError(f"zero train step is data-parallel only: mesh axis {name!r} has "
                             f"size {size} (use make_train_step under a recipe)")
    return mesh.shape["data"]


def make_zero_update(cfg, mesh, ocfg: OptConfig, *, bucket_bytes: int = 4 << 20,
                     double_buffer: bool = True):
    """The ZeRO step's communication and update, apart from the gradients:
    ``update(params, opt_state, grads) -> (new_params, new_opt,
    grad_norm)``, where ``grads`` are this rank's (its local-mean loss's)
    and ``opt_state`` holds this rank's moment shards.  ``double_buffer``
    picks the plan's interpretation (bitwise equal by construction)."""
    R = _data_ranks(mesh)
    buckets = zero_train_buckets(cfg, bucket_bytes=bucket_bytes, ranks=R)
    compress = ocfg.compress == "int8"
    inv_R = 1.0 / R

    def update(params, opt_state: OptState, grads):
        ridx = mesh.coords()["data"]
        p_leaves = tree_leaves(params)
        g_leaves = tree_leaves(grads)
        step = opt_state.step + 1
        lr, b1c, b2c = _step_scalars(step, ocfg)
        # the shard-local optimizer state the stages write, and the norm
        new_mu: list = [None] * len(buckets)
        new_nu: list = [None] * len(buckets)
        new_err: list = [None] * len(buckets)
        norm_cell: list = [None]

        def transfer(_state, s):
            # each bucket packed as it is issued: the packing of bucket s + 1
            # runs while bucket s is in flight
            return shard_reduce_scatterv_start(pack_bucket(g_leaves, buckets[s]), "data",
                                               extents=buckets[s].extents, mesh=mesh)

        def reduce(arrived):
            # the mean gradient on this rank's shards (int8 error feedback
            # when compressing), then the global clip scale from one scalar
            # all-reduce of the shards' sums of squares
            shards = []
            sq = torch.zeros((), dtype=torch.float32, device=arrived[0].device)
            for s, a in enumerate(arrived):
                g = a.float() * inv_R
                if compress:
                    g, new_err[s] = compress_leaf(g, opt_state.err[s])
                shards.append(g)
                sq = sq + torch.dot(g, g)
            gnorm = torch.sqrt(shard_all_reduce_start(sq, "data", mesh=mesh).wait())
            norm_cell[0] = gnorm
            return {"shards": shards, "scale": _clip_scale(gnorm, ocfg)}

        def compute(gval, _arrived_s, s):
            b = buckets[s]
            p_shard = pack_bucket(p_leaves, b)[ridx * b.cap:(ridx + 1) * b.cap]
            new_p, new_mu[s], new_nu[s] = adamw_leaf_update(
                p_shard, gval["shards"][s], opt_state.mu[s], opt_state.nu[s],
                scale=gval["scale"], lr=lr, b1c=b1c, b2c=b2c, ocfg=ocfg)
            return new_p

        def combine(p_shard, s):
            return shard_all_gatherv_start(p_shard, "data", extents=buckets[s].extents,
                                           mesh=mesh)

        gathered = bucket_plan(len(buckets), transfer=transfer, reduce=reduce, compute=compute,
                               combine=combine).run(None, None, double_buffer=double_buffer)
        out_leaves: list = [None] * len(p_leaves)
        for b, flat in zip(buckets, gathered):
            for i, leaf in zip(b.indices, unpack_bucket(flat, b)):
                out_leaves[i] = leaf
        new_opt = OptState(step=step, mu=tuple(new_mu), nu=tuple(new_nu),
                           err=tuple(new_err) if compress else ())
        return tree_unflatten(params, out_leaves), new_opt, norm_cell[0]

    return update


def make_zero_train_step(cfg, mesh, ocfg: OptConfig, *, microbatches: int = 1,
                         bucket_bytes: int = 4 << 20, double_buffer: bool = True):
    """Build the explicit ZeRO-2 ``train_step(params, opt_state, batch)``,
    one rank's program over the ``data`` axis of ``mesh`` (its other axes
    must have one rank: the explicit step is data-parallel).

    ``params`` are whole on every rank; ``opt_state`` comes from
    :func:`repro_torch.train.optimizer.init_zero_opt_state` over the same
    bucket tables (``zero_train_buckets(cfg, bucket_bytes=...,
    ranks=mesh.shape['data'])``) and holds this rank's shards; ``batch`` is
    this rank's contiguous block of the global batch's rows
    (:func:`zero_local_batch`, the reference's ``P("data")`` block), which
    it splits into its ``microbatches``.  Per step
    the rank takes gradients of its *local-mean* loss, the bucket plan
    reduce-scatters them (:func:`make_zero_update`), and the loss and
    metrics are averaged over the ranks.  Summing the rank partials and
    dividing by a power-of-two rank count is exact in float32, so on a
    uniform batch the step computes the single-device step's mean gradient.

    ``ocfg.compress="int8"`` quantizes each *reduced bucket shard* with a
    sharded error-feedback residual (the wire moves float32 gradients; the
    per-shard int8 scales replace the baseline's per-leaf ones)."""
    R = _data_ranks(mesh)
    update = make_zero_update(cfg, mesh, ocfg, bucket_bytes=bucket_bytes,
                              double_buffer=double_buffer)
    inv_R = 1.0 / R

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = _accum_loss_grads(params, batch, cfg, microbatches)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            new_params, new_opt, gnorm = update(params, opt_state, grads)
        names = ["loss", *metrics]
        sums = shard_all_reduce_start(torch.stack([loss, *metrics.values()]), "data",
                                      mesh=mesh).wait() * inv_R
        out = {name: sums[i] for i, name in enumerate(names)}
        return new_params, new_opt, {**out, "grad_norm": gnorm, "lr": lr_at_step(new_opt.step,
                                                                                 ocfg)}

    return train_step
