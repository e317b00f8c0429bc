"""AdamW + schedule + clipping + optional int8 error-feedback compression:
the port of ``src/repro/train/optimizer.py``.

Two state layouts share the same update math (:func:`adamw_leaf_update`):

* :func:`init_opt_state` — moments as trees mirroring the params, for the
  single-program step (:func:`repro_torch.train.trainer.make_train_step`);
* :func:`init_zero_opt_state` — moments as per-bucket flat ``(cap,)``
  tensors: this rank's 1/R shard of each bucket
  (:mod:`repro_torch.train.buckets`), which the explicit ZeRO step updates.
  The reference holds the whole ``(padded,)`` buffers sharded over
  ``data``; here every rank holds its own shard only.

Every scalar of the update (the learning rate, the bias corrections, the
clip scale) is a float32 tensor computed as the reference computes it:
Python floats are float64, and would change the last bits.

Gradient compression (``compress="int8"``): symmetric per-tensor int8
quantization with an error-feedback residual, per parameter leaf in the
single-program step and per reduced bucket shard in the ZeRO step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.module import tree_leaves, tree_map

__all__ = ["OptConfig", "OptState", "init_opt_state", "init_zero_opt_state",
           "apply_updates", "adamw_leaf_update", "compress_leaf", "lr_at_step"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress: str = "none"  # none | int8


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates taken so far
    mu: Any  # first moment (a params tree, or a tuple of flat shards)
    nu: Any  # second moment
    err: Any  # error-feedback residual (only when compressing; else ())


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def init_opt_state(params, ocfg: OptConfig) -> OptState:
    """Zero float32 moments (and residuals when compressing) shaped like
    ``params``, step 0."""
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=_zeros_like_tree(params),
        nu=_zeros_like_tree(params),
        err=_zeros_like_tree(params) if ocfg.compress == "int8" else (),
    )


def lr_at_step(step: torch.Tensor, ocfg: OptConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``, a float32 scalar
    of the int32 ``step``, in the reference's float32 operations."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - ocfg.warmup_steps) / max(ocfg.total_steps - ocfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return ocfg.lr * warm * (ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * cos)


def init_zero_opt_state(params, buckets, ocfg: OptConfig) -> OptState:
    """ZeRO-partitioned optimizer state: for every bucket
    (:class:`~repro_torch.train.buckets.GradBucket`) this rank's ``(cap,)``
    float32 shard of the moments, matching its reduce-scattered gradient
    slice; ``err`` carries the per-shard error-feedback residual when
    compressing.  ``params`` gives only the device."""
    dev = tree_leaves(params)[0].device
    flats = lambda: tuple(torch.zeros((b.cap,), dtype=torch.float32, device=dev)
                          for b in buckets)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=flats(),
        nu=flats(),
        err=flats() if ocfg.compress == "int8" else (),
    )


def _quantize_int8(g, amax=None):
    scale = torch.clamp(g.abs().max() if amax is None else amax(g.abs().max()),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_leaf(g, e, amax=None):
    """Quantize one leaf's (grad + residual) to int8; returns the
    dequantized grad and the new residual.  The int8 tensor is the
    compressed representation (per-leaf symmetric scale).  ``amax`` maps
    the shard's largest magnitude to the whole leaf's, for a leaf cut over
    ranks."""
    x = g.float() + e
    q, scale = _quantize_int8(x, amax)
    deq = q.float() * scale
    return deq.to(g.dtype), x - deq


def _step_scalars(step, ocfg: OptConfig):
    """``(lr, b1c, b2c)`` of update number ``step`` (int32 tensor)."""
    sf = step.float()
    return (lr_at_step(step, ocfg), 1 - torch.pow(torch.tensor(ocfg.b1, device=sf.device), sf),
            1 - torch.pow(torch.tensor(ocfg.b2, device=sf.device), sf))


def adamw_leaf_update(p, g, mu, nu, *, scale, lr, b1c, b2c, ocfg: OptConfig):
    """One leaf's (or flat shard's) AdamW update: the single source of the
    update math, shared by the single-program step (per param leaf) and the
    ZeRO step (per bucket shard, where ``p``/``g`` are flat ``(cap,)``
    slices).  ``scale`` is the global-norm clip factor; ``b1c``/``b2c`` the
    bias corrections.  Returns ``(new_p, new_mu, new_nu)``."""
    g = g.float() * scale
    mu = ocfg.b1 * mu + (1 - ocfg.b1) * g
    nu = ocfg.b2 * nu + (1 - ocfg.b2) * torch.square(g)
    mhat = mu / b1c
    nhat = nu / b2c
    delta = mhat / (torch.sqrt(nhat) + ocfg.eps) + ocfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), mu, nu


def _clip_scale(gnorm, ocfg: OptConfig):
    return torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def apply_updates(params, grads, state: OptState, ocfg: OptConfig, *, cut=None):
    """One AdamW step over a params tree.  Returns ``(new_params,
    new_state, metrics)`` with ``metrics = {"grad_norm", "lr"}``.

    ``cut`` (optional) is ``(reduce_sq, amax)`` for a tree of this rank's
    shards: ``reduce_sq(sums)`` turns the leaves' local sums of squares
    (in leaf order) into the whole tree's, counting every shard once, and
    ``amax`` is a tree like ``params`` of each leaf's int8 ``amax``
    (:func:`compress_leaf`)."""
    err = state.err
    if ocfg.compress == "int8":
        amax = tree_map(lambda _: None, grads) if cut is None else cut[1]
        pairs = tree_map(lambda gea: compress_leaf(*gea), _zip(grads, err, amax))
        grads = tree_map(lambda pr: pr[0], pairs)
        err = tree_map(lambda pr: pr[1], pairs)

    # global-norm clip: the leaves' sums of squares added in leaf order
    leaves = tree_leaves(grads)
    if cut is None:
        sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for g in leaves:
            sq = sq + torch.sum(torch.square(g.float()))
    else:
        sq = cut[0]([torch.sum(torch.square(g.float())) for g in leaves])
    gnorm = torch.sqrt(sq)
    scale = _clip_scale(gnorm, ocfg)

    step = state.step + 1
    lr, b1c, b2c = _step_scalars(step, ocfg)
    out = tree_map(lambda a: adamw_leaf_update(*a, scale=scale, lr=lr, b1c=b1c, b2c=b2c,
                                               ocfg=ocfg),
                   _zip(params, grads, state.mu, state.nu))
    new_state = OptState(step=step, mu=tree_map(lambda o: o[1], out),
                         nu=tree_map(lambda o: o[2], out), err=err)
    return tree_map(lambda o: o[0], out), new_state, {"grad_norm": gnorm, "lr": lr}


def _zip(*trees):
    """One tree whose leaves are tuples of the trees' leaves (a tuple is a
    leaf to :func:`tree_map`)."""
    if isinstance(trees[0], dict):
        return {k: _zip(*(t[k] for t in trees)) for k in trees[0]}
    return tuple(trees)
