"""Carrying weights into the port.

:func:`params_from_jax` takes the reference's parameter tree as nested dicts
of numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives) and makes
the port's parameters on a device, so that both packages run the same
weights.  :func:`cast_params` makes the activation-dtype copy of a
parameter tree once, at load: every use of a weight in the reference casts
it with ``.astype(x.dtype)``, which gives the same bits as casting once,
and casting the full-width float32 weights at every use would move about
23 GB per decode step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dist import resolve_device

from .module import tree_map

__all__ = ["params_from_jax", "cast_params"]


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


def cast_params(params, dtype: torch.dtype) -> dict:
    """A copy of ``params`` with every floating-point leaf in ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)
