"""Carrying weights into the port.

:func:`params_from_jax` takes the reference's parameter tree as nested dicts
of numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives) and makes
the port's parameters on a device, so that both packages run the same
weights.  :func:`cast_params` makes the activation-dtype copy of a
parameter tree once, at load: every use of a weight in the reference casts
it with ``.astype(x.dtype)``, which gives the same bits as casting once,
and casting the full-width float32 weights at every use would move about
23 GB per decode step.  :func:`shard_params` cuts this rank's shard of a
parameter tree out of the whole tree, following a tree of specs such as
:func:`repro_torch.serve.tp_decode.tp_decode_specs`'s;
:func:`shard_params_by_recipe` cuts by a sharding recipe's bindings, and
:func:`gather_params` puts a recipe's shards back together (what a
checkpoint stores).
:func:`opt_state_from_jax` does for the reference's optimizer state what
:func:`params_from_jax` does for its parameters, so that both packages can
start from a mid-training state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dims import mixed_radix_join, prod
from repro_torch.core.dist import resolve_device

from .module import tree_map

__all__ = ["params_from_jax", "opt_state_from_jax", "cast_params", "shard_params",
           "shard_params_by_recipe", "gather_params"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: numpy cannot hand it over
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(tree, *, device="cuda") -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's parameters on ``device``, leaf for leaf, dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def opt_state_from_jax(state, *, device="cuda", buckets=None, rank: int | None = None):
    """The reference's ``OptState`` as numpy (its fields ``step``, ``mu``,
    ``nu``, ``err`` as a mapping or a named tuple) as the port's
    :class:`repro_torch.train.optimizer.OptState` on ``device``.  Per-leaf
    moments (trees) carry over leaf for leaf.  ZeRO-flat moments (a tuple
    of ``(padded,)`` buffers, one per bucket) are cut to rank ``rank``'s
    ``(cap,)`` shards of ``buckets``, the state the port's ZeRO step keeps
    on that rank."""
    from repro_torch.train.optimizer import OptState

    fields = dict(state) if isinstance(state, dict) else state._asdict()
    dev = resolve_device(device)

    def moments(m):
        if isinstance(m, dict):
            return params_from_jax(m, device=dev)
        flats = tuple(_tensor(a, dev) for a in m)
        if buckets is None:
            return flats
        if len(flats) != len(buckets) or rank is None:
            raise ValueError(f"{len(flats)} flat moments for {len(buckets)} buckets, rank {rank}")
        return tuple(f[rank * b.cap:(rank + 1) * b.cap].clone() for f, b in zip(flats, buckets))

    return OptState(step=_tensor(np.asarray(fields["step"], dtype=np.int32), dev),
                    mu=moments(fields["mu"]), nu=moments(fields["nu"]),
                    err=moments(fields["err"]) if len(fields["err"]) else ())


def cast_params(params, dtype: torch.dtype) -> dict:
    """A copy of ``params`` with every floating-point leaf in ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)


def shard_params(params, specs, mesh) -> dict:
    """This rank's shard of ``params``: each leaf cut along every dim whose
    spec entry (one per dim, as a ``PartitionSpec``'s: a mesh axis, a tuple
    of them, or ``None``) names mesh axes, to the block at this process's
    coordinates.  A leaf the mesh does not cut (every named axis of one
    rank) is a view of the whole tensor, not a copy; a cut leaf is a
    contiguous copy of its block."""
    if isinstance(params, dict):
        missing = set(params) - set(specs)
        if missing:
            raise ValueError(f"no spec for parameters {sorted(missing)}")
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    if len(specs) != params.ndim:
        raise ValueError(f"spec {specs} does not fit a tensor of shape {tuple(params.shape)}")
    coords, t = mesh.coords(), params
    for dim, entry in enumerate(specs):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = prod(mesh.shape[a] for a in axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {axes} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mixed_radix_join([coords[a] for a in axes],
                                           [mesh.shape[a] for a in axes]) * size, size)
    return t.contiguous()


def shard_params_by_recipe(params, specs, recipe) -> dict:
    """This rank's shard of the whole parameter tree ``params`` under
    ``recipe``: each leaf cut by its spec in ``recipe.param_pspecs(specs)``
    (``specs`` the :class:`~repro_torch.models.module.ParamSpec` tree,
    ``lm.build_specs(cfg)``), with :func:`shard_params`.  A leaf that only
    one-rank axes cut stays a view of the whole tensor."""
    from .sharding import recipe_pspecs

    return shard_params(params, recipe_pspecs(recipe, specs), recipe.mesh)


def gather_params(shards, specs, recipe) -> dict:
    """The whole parameter tree, on every rank, from every rank's
    :func:`shard_params_by_recipe` shard: each cut dim all-gathered over its
    mesh axes (the inverse of the cut, bitwise).  Collective: every rank of
    the mesh calls it."""
    from .sharding import gather_cut, recipe_pspecs

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k]) for k in t}
        with torch.no_grad():
            return gather_cut(t, spec, recipe.mesh)

    return walk(shards, recipe_pspecs(recipe, specs))
