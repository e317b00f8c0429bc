"""Parameter substrate: every model weight is declared through the layout
algebra (a :class:`~repro_torch.core.layout.Layout` with named dims).

Model code never writes a shape by hand: it declares logical dims
(``m``=d_model, ``f``=d_ff, ``h``=heads, ``v``=vocab, ``l``=layers, ...)
and the layout gives the buffer's shape and physical order.  A sharding
recipe binds dims to mesh axes, and :func:`param_pspecs` derives every
weight's spec from its layout and the bindings, as the reference's does; a
spec is a tuple with one entry per buffer axis (a mesh axis, a tuple of
them, or ``None``), trailing ``None`` entries dropped, the reference's
``PartitionSpec``.  The reference's ``param_shardings`` and
``abstract_params`` (``NamedSharding`` and ``ShapeDtypeStruct`` trees) have
no counterpart: a torch tensor is cut by its spec
(:func:`repro_torch.models.weights.shard_params_by_recipe`).

Parameter trees are nested dicts whose leaves are :class:`ParamSpec` (the
declaration) or tensors (the weights).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dims import LayoutError
from repro_torch.core.layout import Layout, scalar, torch_dtype, vector

__all__ = ["ParamSpec", "pspec", "init_params", "stack_specs", "tree_size", "tree_map",
           "tree_leaves", "tree_unflatten", "partition_spec", "param_pspecs"]

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                 torch.float16: np.float16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative weight: layout (named dims, physical order) + init law."""

    layout: Layout
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: float | None = None  # stddev override for 'normal'
    fan_in_dims: tuple[str, ...] = ()  # dims whose product is fan-in (default: all but last)

    @property
    def shape(self) -> tuple[int, ...]:
        return self.layout.shape

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.layout.dtype)

    def initialize(self, generator: torch.Generator, device) -> torch.Tensor:
        shape, dtype = self.shape, self.dtype
        if self.init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if self.init == "embed":
            x = torch.randn(shape, dtype=torch.float32, device=device, generator=generator)
            return (x * (self.scale or 0.02)).to(dtype)
        # truncated-normal fan-in init: a unit normal cut at +-2, times std
        if self.scale is not None:
            std = self.scale
        else:
            if self.fan_in_dims:
                fan_in = int(np.prod([self.layout.dim_size(d) for d in self.fan_in_dims]))
            else:
                fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            std = fan_in ** -0.5
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (x * std).to(dtype)


def pspec(*dims: tuple[str, int], dtype=torch.float32, init: str = "normal",
          scale: float | None = None, fan_in: tuple[str, ...] = ()) -> ParamSpec:
    """``pspec(('m', 3072), ('f', 8192))`` — dims listed outer..inner; the
    buffer's shape is the listed sizes, row-major."""
    if dtype not in _NUMPY_DTYPES:
        raise TypeError(f"parameters are declared in {list(_NUMPY_DTYPES)}, got {dtype}")
    layout = scalar(_NUMPY_DTYPES[dtype])
    for name, size in reversed(dims):  # vector() prepends: apply inner first
        layout = layout ^ vector(name, int(size))
    return ParamSpec(layout=layout, init=init, scale=scale, fan_in_dims=tuple(fan_in))


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested-dict tree, in sorted key order (JAX's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, taken in
    :func:`tree_leaves` order."""
    return _build(tree, iter(leaves))


def _build(t, it):
    # a module-level recursion: a recursive closure is a reference cycle
    # that would keep ``leaves`` (a step's gradients) alive until the
    # cyclic garbage collector runs
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def stack_specs(tree, num: int, dim: str = "l"):
    """Add a leading stacked-layer dim to every spec."""
    return tree_map(lambda s: dataclasses.replace(s, layout=s.layout ^ vector(dim, num)), tree)


def init_params(tree, generator: torch.Generator, device) -> dict:
    """Weights for every spec of ``tree``, drawn from ``generator`` leaf by
    leaf in sorted key order, on ``device``."""
    if isinstance(tree, dict):
        return {k: init_params(tree[k], generator, device) for k in sorted(tree)}
    return tree.initialize(generator, device)


def tree_size(tree) -> int:
    """Total element count of a spec/tensor tree."""
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(tree))


def partition_spec(layout: Layout, bindings, *, priority=None) -> tuple:
    """The spec of a buffer in ``layout`` under dim -> mesh-axis
    ``bindings`` (the reference's ``repro.core.dist.partition_spec``).

    A binding key names a physical axis or a logical dim that maps to one
    physical axis; its value is a mesh axis or a tuple of them.  When two
    dims of one buffer bind the same mesh axis, the one earlier in
    ``priority`` (default: the bindings' order) takes it and the other
    replicates.  Unbound axes replicate; trailing ``None`` entries are
    dropped."""
    order = list(priority) if priority is not None else list(bindings)
    order += [k for k in bindings if k not in order]
    used: set[str] = set()
    norm: dict[str, tuple[str, ...]] = {}
    for key in order:
        val = bindings.get(key)
        if val is None:
            continue
        if any(a.name == key for a in layout.axes):
            target = key
        else:
            daxs = dict(layout.dim_map).get(key)
            if daxs is None:
                continue  # the binding does not concern this layout
            if len(daxs) != 1:
                raise LayoutError(f"cannot bind blocked dim {key!r} (axes {daxs}) to mesh axes "
                                  f"{val!r}; bind one of its physical axes instead")
            target = daxs[0]
        if target in norm:
            raise LayoutError(f"axis {target!r} bound twice")
        val_axes = (val,) if isinstance(val, str) else tuple(val)
        if any(ax in used for ax in val_axes):
            continue  # the mesh axis went to a dim earlier in priority
        used.update(val_axes)
        norm[target] = val_axes
    entries = [None if a.name not in norm else
               (norm[a.name] if len(norm[a.name]) > 1 else norm[a.name][0]) for a in layout.axes]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_pspecs(tree, bindings, priority=None):
    """The spec tree of a :class:`ParamSpec` tree under ``bindings`` (the
    reference's ``param_pspecs``): each weight's :func:`partition_spec`."""
    return tree_map(lambda s: partition_spec(s.layout, bindings, priority=priority), tree)
