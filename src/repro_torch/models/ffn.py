"""Feed-forward family: SwiGLU, the GELU MLP, and the top-k MoE (with
arctic's optional parallel dense residual branch).

The products are plain ``torch.matmul``/``bmm`` in the activation dtype: in
the reference they sit outside any Pallas kernel (XLA's dots and einsums).

MoE dispatch modes
------------------
All three share the router (softmax top-k, renormalized gates) and the
capacity-based slotting (slot = expert base + running per-expert counter;
overflowing choices drop; GShard aux loss).  They differ in where the
routed tokens go:

``dense`` (:func:`moe_ffn` with ``groups <= 1``)
    One global ``(E*C, m)`` scatter buffer; the running counter spans every
    token.  Decode (S == 1) always takes this mode, dropless (C = T).
``grouped`` (``groups > 1``, GShard-style, :func:`_moe_grouped`)
    Tokens split into G groups along the batch, each with its own capacity
    and slot counter.
``expert-parallel`` (``dispatch="ep"``, :func:`moe_expert_parallel`)
    Experts split over the ``model`` ranks in a ragged ceil-split
    (:func:`repro_torch.models.sharding.ragged_expert_extents`: E need not
    divide the axis), tokens over the (data, model) ranks.  The
    per-(rank, expert) counts table, the ``MPI_Alltoallv`` counts, drives
    a ragged :func:`repro_torch.core.collectives.all_to_allv_start` to the
    owner ranks, the expert GEMMs run on the resident rows only, and the
    inverse all-to-all brings the rows back, the two legs scheduled by a
    :func:`repro_torch.core.plan.dispatch` comm plan double-buffered over
    expert groups.

Routing takes the top k as k rounds of a masked ``argmax`` (ties to the
lowest index, as ``jax.lax.top_k``); ``torch.topk`` leaves the order of
ties unspecified.  The scatter into the expert buffers is ``index_add_``:
each kept choice owns its slot, and a dropped choice adds a zero row, so
the sum does not depend on the order of the adds.

The dense and grouped paths mark their three stages with profiler ranges,
``moe.route`` (router, top-k, slots and the scatter into the expert
buffer), ``moe.experts`` (the expert GEMMs) and ``moe.combine`` (the
gather back and the gate-weighted sum), so a ``torch.profiler`` trace can
split a forward's device time by stage; outside a profile a range costs a
few microseconds of host time.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core.collectives import (DistBag, all_reduce_start, all_reduce_tie,
                                          all_to_allv_start, all_to_allv_tie, grid_extents,
                                          rank_map)
from repro_torch.core.dims import ceil_div, prod
from repro_torch.core.dist import mpi_cart_traverser, mpi_traverser
from repro_torch.core.layout import layout_dtype, scalar, vector
from repro_torch.core.plan import dispatch as dispatch_plan, intent_of
from repro_torch.core.traverser import traverser

from .module import pspec
from .sharding import all_reduce, current_recipe, partial_product, ragged_expert_extents

__all__ = ["swiglu_specs", "swiglu", "gelu_mlp_specs", "gelu_mlp", "ffn_placed", "moe_specs",
           "moe_ffn", "moe_placed",
           "moe_ep_counts", "moe_ep_schedule", "moe_comm_model", "moe_expert_parallel",
           "MOE_DISPATCH_PLAN_INTENT"]


def swiglu_specs(d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_gate": pspec(("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_up": pspec(("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_down": pspec(("f", d_ff), ("m", d_model), dtype=dtype, fan_in=("f",)),
    }


def swiglu(p, x):
    g = torch.matmul(x, p["w_gate"].to(x.dtype))
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, p["w_down"].to(x.dtype))


def gelu_mlp_specs(d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_in": pspec(("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_out": pspec(("f", d_ff), ("m", d_model), dtype=dtype, fan_in=("f",)),
        "b_in": pspec(("f", d_ff), dtype=dtype, init="zeros"),
        "b_out": pspec(("m", d_model), dtype=dtype, init="zeros"),
    }


def gelu_mlp(p, x):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(torch.matmul(x, p["w_in"].to(x.dtype)) + p["b_in"].to(x.dtype), approximate="tanh")
    return torch.matmul(h, p["w_out"].to(x.dtype)) + p["b_out"].to(x.dtype)


def ffn_placed(p, x, *, kind: str, d_ff: int, place):
    """This rank's part of the SwiGLU (``kind="swiglu"``) or GELU MLP
    (``"gelu"``) under a ``tp``/``sp`` recipe
    (:class:`repro_torch.models.sharding.Placement`).  Where ``f`` is bound
    to ``model`` the rank holds its block of the hidden columns: its float32
    partial of the down projection is summed over ``model`` and rounded
    once (the GELU's output bias added after); else every rank runs the
    whole FFN.  ``x`` is whole over ``model``, and so is the result; where
    the residual stream is cut by sequence (``place.S`` set) ``x`` and the
    result are this rank's chunk: the chunks are gathered along the
    sequence and the partial reduce-scattered back to them (rounded once),
    or, with ``f`` whole, the FFN runs on the chunk."""
    w_in = p["w_gate"] if kind == "swiglu" else p["w_in"]
    if place.M == 1 or w_in.shape[1] == d_ff:
        if place.S is not None:
            p = {k: place.for_chunk(w) for k, w in p.items()}
        return swiglu(p, x) if kind == "swiglu" else gelu_mlp(p, x)
    if place.S is None:
        xn, reduce = place.enter_model(x), place.sum_model
    else:
        xn, reduce = place.gather_seq(x), place.scatter_seq
    if kind == "swiglu":
        h = F.silu(torch.matmul(xn, p["w_gate"].to(x.dtype))) * \
            torch.matmul(xn, p["w_up"].to(x.dtype))
        return reduce(partial_product(h, p["w_down"])).to(x.dtype)
    h = F.gelu(torch.matmul(xn, p["w_in"].to(x.dtype)) + p["b_in"].to(x.dtype),
               approximate="tanh")
    out = reduce(partial_product(h, p["w_out"])).to(x.dtype)
    return out + place.for_chunk(p["b_out"]).to(x.dtype)


# ------------------------------------------------------------------- MoE ----

def moe_specs(d_model: int, d_ff: int, n_experts: int, *, dense_residual: bool = False,
              dtype=torch.float32) -> dict:
    s = {
        "router": pspec(("m", d_model), ("e", n_experts), dtype=dtype, scale=0.02),
        "w_gate": pspec(("e", n_experts), ("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_up": pspec(("e", n_experts), ("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_down": pspec(("e", n_experts), ("f", d_ff), ("m", d_model), dtype=dtype,
                        fan_in=("f",)),
    }
    if dense_residual:
        s["residual"] = swiglu_specs(d_model, d_ff, dtype)
    return s


def _topk(probs, k: int):
    """Top-k along the last dim as k masked ``argmax`` rounds: the lowest
    index wins a tie, as in ``jax.lax.top_k``."""
    vals, idxs = [], []
    cur = probs
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _route(x, router, top_k: int):
    """``(probs, gate values, expert indices)`` of tokens ``x (..., m)``:
    float32 softmax over the router logits, top-k, gates renormalized."""
    logits = torch.matmul(x, router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _topk(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _positions(gate_idx, E: int):
    """Each choice's running position in its expert: the number of earlier
    choices (token-major, then k) of the same expert, over the
    second-to-last dim of ``gate_idx (..., T, k)``."""
    *lead, T, k = gate_idx.shape
    # (..., E, T*k): the running count is a scan along the inner dim (on the
    # card a scan along the outer dim of 16 columns is the slower kernel)
    flat = F.one_hot(gate_idx, E).reshape(*lead, T * k, E).transpose(-1, -2).contiguous()
    pos = flat.cumsum(-1) - flat
    return (pos * flat).sum(-2).reshape(gate_idx.shape)


def _top1_load(gate_idx, E: int):
    """Float32 count of tokens whose first choice is each expert."""
    first = gate_idx[..., 0].reshape(-1)
    return torch.zeros((E,), dtype=torch.float32, device=first.device).index_add_(
        0, first, torch.ones(first.shape, dtype=torch.float32, device=first.device))


def _experts(be, wg, wu, wd):
    """SwiGLU of every expert on its rows: ``be (E, C, m)`` -> ``(E, C, m)``."""
    g = torch.bmm(be, wg.to(be.dtype))
    u = torch.bmm(be, wu.to(be.dtype))
    return torch.bmm(F.silu(g) * u, wd.to(be.dtype))


def _combine(rows, slot, gate_vals, w):
    """Each token's output: its choices' expert rows, weighted by the gates
    of the kept choices, summed over k."""
    T, k = slot.shape
    yt = rows[slot.reshape(-1)].reshape(T, k, rows.shape[-1])
    return (yt * (gate_vals.to(rows.dtype) * w)[..., None]).sum(dim=1)


class _PartialCombine(torch.autograd.Function):
    """The float32 partial of the placed MoE's combine, ``(T, m)``: the sum
    over the ``k`` choices of ``ye[local[:, j]].float() * wk[:, j].float()``
    (``ye (rows, m)`` the experts' rows, ``local (T, k)`` each choice's row,
    ``wk (T, k)`` its weight), one choice's rows upcast at a time.  It
    saves ``ye`` and ``wk`` in their own dtypes and rebuilds a choice's
    float32 rows in the backward, whose gradients are the composite's
    (``(ye[local].float() * wk.float()[..., None]).sum(1)``) op by op."""

    @staticmethod
    def forward(ctx, ye, local, wk):
        ctx.save_for_backward(ye, local, wk)
        y = None
        for j in range(local.shape[1]):
            t = ye[local[:, j]].float().mul_(wk[:, j, None].float())
            y = t if y is None else y.add_(t)
        return y

    @staticmethod
    def backward(ctx, g):
        ye, local, wk = ctx.saved_tensors
        dye = torch.zeros_like(ye) if ctx.needs_input_grad[0] else None
        dwk = wk.new_empty(wk.shape, dtype=torch.float32) if ctx.needs_input_grad[2] else None
        for j in range(local.shape[1]):
            if dwk is not None:
                dwk[:, j] = (g * ye[local[:, j]].float()).sum(dim=-1)
            if dye is not None:  # a kept choice's row takes its cotangent alone
                dye.index_put_((local[:, j],), (g * wk[:, j, None].float()).to(ye.dtype),
                               accumulate=True)
        return dye, None, None if dwk is None else dwk.to(wk.dtype)


def moe_ffn(p, x, *, n_experts: int, top_k: int = 2, capacity_factor: float = 1.25,
            aux_loss_weight: float = 0.01, groups: int = 0, dispatch: str = "auto",
            shard=None):
    """x (B, S, m) -> ``(y (B, S, m), aux_loss scalar)``, the reference's
    ``moe_ffn``.

    Capacity C = round(top_k * T / E * capacity_factor) (at least top_k);
    overflowing choices are dropped (Switch/GShard); the aux loss is the
    GShard load-balancing loss.  ``groups > 1`` with S > 1 and B a multiple
    of it is grouped dispatch (:func:`_moe_grouped`); S == 1 (decode) is
    dropless, C = T.

    ``shard`` (a :class:`repro_torch.models.sharding.TokenShard`) says that
    ``x`` is this rank's block of a token grid under an ``sp_ring`` recipe,
    and the result is this rank's block of the output.
    ``dispatch="ep"`` then runs :func:`moe_expert_parallel` on the block
    when the recipe can host it.  When it cannot (see
    :func:`_ep_ineligible`), and for ``dispatch="auto"``, the hidden states
    are gathered over the token ranks and every rank computes the whole
    grid's dense or grouped dispatch, as the reference computes it: one
    capacity and one running counter over all B*S tokens, so each rank
    keeps and drops the same tokens as a single process would.  A rank
    routing its own block with a local capacity would drop other tokens.
    The fallback from ``"ep"`` warns, as the reference does."""
    if dispatch not in ("auto", "ep"):
        raise ValueError(f"moe_ffn: unknown dispatch {dispatch!r} (have 'auto', 'ep')")
    B, S = (shard.B, shard.S) if shard is not None else x.shape[:2]
    if dispatch == "ep":
        recipe = current_recipe()
        if recipe is not None and shard is None:
            why = "the whole token grid is on this process (no token shard)"
        else:
            why = _ep_ineligible(recipe, B, S)
        if why is None:
            return moe_expert_parallel(p, x, n_experts=n_experts, top_k=top_k,
                                       capacity_factor=capacity_factor,
                                       aux_loss_weight=aux_loss_weight, recipe=recipe)
        warnings.warn(f"moe_ffn: dispatch='ep' requested but {why}; falling back to the "
                      "dense/grouped capacity dispatch", stacklevel=2)
    if shard is not None:
        y, aux = moe_ffn(p, shard.gather(x), n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, aux_loss_weight=aux_loss_weight,
                         groups=groups)
        if shard.n_rows == B and shard.cap == S:  # this rank's block is the whole grid
            return shard.local(y), aux
        # the aux loss from this rank's own tokens' statistics, summed over
        # the token ranks: each rank's gradient of it is then its own share
        valid = max(0, min(shard.cap, S - shard.chunk * shard.cap))
        probs, _, gate_idx = _route(x[:, :valid].reshape(-1, x.shape[-1]), p["router"], top_k)
        sums = torch.cat([probs.sum(0), _top1_load(gate_idx, n_experts)])
        for a in ("model",) + shard.batch_axes:
            sums = all_reduce(sums, shard.mesh, a)
        return shard.local(y), _aux(sums, B * S, n_experts, aux_loss_weight)
    if groups and groups > 1 and S > 1 and B % groups == 0:
        return _moe_grouped(p, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor,
                            aux_loss_weight=aux_loss_weight, groups=groups)
    m = x.shape[-1]
    E, T = n_experts, B * S
    # decode: dropless (C = T lets any routing fit), so serving never drops
    C = T if S == 1 else int(max(top_k, round(top_k * T / E * capacity_factor)))
    xt = x.reshape(T, m)
    with record_function("moe.route"):
        probs, gate_vals, gate_idx = _route(xt, p["router"], top_k)
        aux = E * torch.sum(probs.mean(dim=0) * (_top1_load(gate_idx, E) / T)) * aux_loss_weight
        pos = _positions(gate_idx, E)  # (T, k)
        w = (pos < C).to(x.dtype)  # dispatch weight (0 drops the overflow)
        slot = gate_idx * C + pos.clamp_max(C - 1)
        buf = x.new_zeros((E * C, m)).index_add_(
            0, slot.reshape(-1), (xt[:, None, :] * w[..., None]).reshape(T * top_k, m))
    with record_function("moe.experts"):
        ye = _experts(buf.view(E, C, m), p["w_gate"], p["w_up"], p["w_down"])
    with record_function("moe.combine"):
        y = _combine(ye.view(E * C, m), slot, gate_vals, w).reshape(B, S, m)
    if "residual" in p:
        y = y + swiglu(p["residual"], x)
    return y, aux


def _moe_grouped(p, x, *, n_experts: int, top_k: int, capacity_factor: float,
                 aux_loss_weight: float, groups: int):
    """Grouped-dispatch MoE: tokens ``(G, Tg, m)``, each group with its own
    capacity ``Cg`` and running counter, buffers ``(G, E, Cg, m)``."""
    B, S, m = x.shape
    E, G, T = n_experts, groups, B * S
    Tg = T // G
    Cg = int(max(top_k, round(top_k * Tg / E * capacity_factor)))
    xg = x.reshape(G, Tg, m)
    with record_function("moe.route"):
        probs, gate_vals, gate_idx = _route(xg, p["router"], top_k)  # (G, Tg, E), (G, Tg, k)
        # the aux loss over the whole batch (the same statistic as ungrouped)
        aux = E * torch.sum(probs.reshape(T, E).mean(dim=0) * (_top1_load(gate_idx, E) / T)) \
            * aux_loss_weight
        pos = _positions(gate_idx, E)  # the counter runs over Tg only
        w = (pos < Cg).to(x.dtype)
        group0 = torch.arange(G, device=x.device)[:, None, None] * (E * Cg)
        slot = (group0 + gate_idx * Cg + pos.clamp_max(Cg - 1)).reshape(T, top_k)
        buf = x.new_zeros((G * E * Cg, m)).index_add_(
            0, slot.reshape(-1), (xg[:, :, None, :] * w[..., None]).reshape(T * top_k, m))
    with record_function("moe.experts"):
        # batched over E: (G, E, Cg, m) -> (E, G*Cg, m), each expert's weights read once
        be = buf.view(G, E, Cg, m).transpose(0, 1).reshape(E, G * Cg, m)
        ye = _experts(be, p["w_gate"], p["w_up"], p["w_down"]).view(E, G, Cg, m).transpose(0, 1)
    with record_function("moe.combine"):
        y = _combine(ye.reshape(G * E * Cg, m), slot, gate_vals.reshape(T, top_k),
                     w.reshape(T, top_k)).reshape(B, S, m)
    if "residual" in p:
        y = y + swiglu(p["residual"], x)
    return y, aux


def _aux(sums, T: int, E: int, aux_loss_weight: float):
    """The GShard aux loss from the router's per-expert probability sums and
    top-1 counts over ``T`` tokens, ``sums = [probs sum (E), counts (E)]``."""
    return E * torch.sum((sums[:E] / T) * (sums[E:] / T)) * aux_loss_weight


def moe_placed(p, x, *, place, n_experts: int, d_ff: int, top_k: int = 2,
               capacity_factor: float = 1.25, aux_loss_weight: float = 0.01, groups: int = 0,
               dispatch: str = "auto"):
    """This rank's part of :func:`moe_ffn` under a ``tp``/``sp`` recipe
    (:class:`repro_torch.models.sharding.Placement`): ``x (Bl, S, m)`` is
    this rank's rows, whole over ``model``; ``p`` the layer's weights with
    their ``m`` dim gathered, the experts (``e``) or else their hidden
    columns (``f``), and the router's ``e``, cut over ``model`` where the
    recipe binds them.  Returns ``(y (Bl, S, m), aux)``, both the same on
    every ``model`` rank.

    * ``dispatch="ep"`` where the recipe's grid hosts it
      (:func:`_ep_ineligible` of the whole ``(B, S)``): the rank's token
      shard, its rows at positions ``[mr * Sr, (mr + 1) * Sr)``, goes
      through :func:`moe_expert_parallel`, and the shards' outputs are
      gathered over ``model`` along the sequence (the reference's ``(D, R,
      Bd, Sr)`` split).  Elsewhere it falls back with the reference's
      warning.
    * Otherwise the capacity dispatch over the tokens the reference routes
      together: the dense path (one capacity and one running counter over
      all ``B * S`` tokens) gathers the rows over the batch axes that cut
      B; the grouped path uses the rank's rows as they are where they form
      whole groups, else gathers them; decode (S == 1) is dropless, so the
      rank routes its own rows.  Where ``e`` is cut the rank's dispatch
      buffer holds its own experts' rows alone (another rank's experts'
      choices weigh 0, as overflowing ones do), where ``f`` is cut every
      expert's rows, on its columns; either way a float32 partial of the
      combine (:class:`_PartialCombine`) is summed over ``model`` and
      rounded once.  The aux loss comes from the rank's own rows'
      statistics summed over the batch axes, so each rank's gradient of it
      is its own rows' share.  On one rank of every axis this is
      :func:`moe_ffn` itself.

    Where the residual stream is cut by sequence (``place.S`` set) ``x``
    and ``y`` are this rank's ``(Bl, cap, m)`` chunks: the expert-parallel
    token shard is the chunk itself; otherwise the rank gathers its rows'
    whole sequence first (the same on every ``model`` rank, so routing,
    capacity and the aux statistics see every position and no padding),
    and the summed partial is reduce-scattered back to the chunk (a whole
    output: the rank takes its chunk), the dense residual run on the
    chunk as :func:`ffn_placed` runs it."""
    if dispatch not in ("auto", "ep"):
        raise ValueError(f"moe_placed: unknown dispatch {dispatch!r} (have 'auto', 'ep')")
    recipe, mesh = place.recipe, place.mesh
    Bl, S, m = x.shape
    S = place.S or S
    D = prod(mesh.shape[a] for a in place.batch_axes)
    B, E = Bl * D, n_experts
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=capacity_factor,
              aux_loss_weight=aux_loss_weight)
    if dispatch == "ep":
        why = _ep_ineligible(recipe, B, S)
        if why is None:
            return _moe_ep_placed(p, x, place=place, d_ff=d_ff, **kw)
        warnings.warn(f"moe_ffn: dispatch='ep' requested but {why}; falling back to the "
                      "dense/grouped capacity dispatch", stacklevel=2)
    xc = x  # the chunk, where the stream is cut by sequence
    if place.S is not None:  # the rows' whole sequence, the same on every model rank
        x = place.gather_seq(x, split=False)
    El = p["w_gate"].shape[0]
    split = place.M > 1 and (El != E or p["w_gate"].shape[2] != d_ff)
    if not split and D == 1:
        y, aux = moe_ffn(p, x, groups=groups, **kw)
        return (y if place.S is None else place.scatter_seq(y, split=False)), aux
    grouped = bool(groups) and groups > 1 and S > 1 and B % groups == 0
    gather = S > 1 and D > 1 and (not grouped or Bl % (B // groups))
    xr = place.gather_rows(x) if gather else x  # the rows routed together
    Br = xr.shape[0]
    G = (groups * Br) // B if grouped else 1
    Tg = Br * S // G
    if S == 1:  # decode: dropless
        C = Tg
    else:
        C = int(max(top_k, round(top_k * (B * S // (groups if grouped else 1)) / E
                                 * capacity_factor)))
    router = place.block(p["router"], 1, 0, E, E, split=False)
    xg = xr.reshape(G, Tg, m)
    with record_function("moe.route"):
        probs, gate_vals, gate_idx = _route(xg, router, top_k)  # (G, Tg, E), (G, Tg, k)
        own = slice(place.row0 * S, (place.row0 + Bl) * S) if gather else slice(None)
        sums = torch.cat([probs.reshape(-1, E)[own].sum(0),
                          _top1_load(gate_idx.reshape(-1, top_k)[own], E)])
        for a in place.batch_axes:
            sums = all_reduce(sums, mesh, a)
        aux = _aux(sums, B * S, E, aux_loss_weight)
        pos = _positions(gate_idx, E)  # the counter runs over each group's tokens
        e0 = place.mr * El if El != E else 0
        # the dispatch weight: 0 drops the overflow and the choices of
        # another rank's experts, which this rank's buffer has no rows for
        w = ((pos < C) & (gate_idx >= e0) & (gate_idx < e0 + El)).to(x.dtype)
        slot = (torch.arange(G, device=x.device)[:, None, None] * (El * C)
                + (gate_idx - e0).clamp(0, El - 1) * C + pos.clamp_max(C - 1))
        xe = place.enter_model(xg) if split else xg
        buf = x.new_zeros((G * El * C, m))
        for j in range(top_k):  # a kept choice's slot takes its row alone
            buf.index_put_((slot[..., j].reshape(-1),), (xe * w[..., j, None]).reshape(-1, m),
                           accumulate=True)
    with record_function("moe.experts"):
        be = buf.view(G, El, C, m).transpose(0, 1).reshape(El, G * C, m)
        del buf
        if El == E and split:  # every expert on this rank's hidden columns: a partial
            h = F.silu(torch.bmm(be, p["w_gate"].to(x.dtype))) * \
                torch.bmm(be, p["w_up"].to(x.dtype))
            ye = torch.bmm(h.float(), p["w_down"].float())
        else:
            ye = _experts(be, p["w_gate"], p["w_up"], p["w_down"])
        ye = ye.view(El, G, C, m).transpose(0, 1).reshape(G * El * C, m)
    with record_function("moe.combine"):
        gv = place.enter_model(gate_vals) if split else gate_vals
        wk = (gv.to(x.dtype) * w).reshape(-1, top_k)
        if split:
            y = _PartialCombine.apply(ye, slot.reshape(-1, top_k), wk).reshape(Br, S, m)
        else:
            y = (ye[slot.reshape(-1)].reshape(-1, top_k, m) * wk[..., None]).sum(dim=1)
            y = y.reshape(Br, S, m)
    if gather:
        y = place.local_rows(y)
    if place.S is not None:
        y = place.scatter_seq(y, split=split).to(x.dtype)
    elif split:
        y = place.sum_model(y).to(x.dtype)
    if "residual" in p:
        y = y + ffn_placed(p["residual"], xc, kind="swiglu", d_ff=d_ff, place=place)
    return y, aux


def _moe_ep_placed(p, x, *, place, d_ff: int, n_experts: int, top_k: int,
                   capacity_factor: float, aux_loss_weight: float):
    """:func:`moe_placed`'s expert-parallel path: this rank's token shard
    through :func:`moe_expert_parallel`, on its own experts where ``e`` is
    cut and on weights gathered over ``model`` otherwise (every rank's work
    differs, so a gathered weight's gradient is reduce-scattered and a whole
    one's summed); the shards' outputs gathered over ``model``."""
    Bl, S, _ = x.shape
    E, Sr, mr = n_experts, S // place.M, place.mr

    def whole(w, dim, full):
        return place.block(w, dim, 0, full, full, split=True)

    pe = {"router": whole(p["router"], 1, E)}
    for k, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        pe[k] = p[k] if p[k].shape[0] != E else whole(p[k], dim, d_ff)
    if "residual" in p:
        pe["residual"] = {k: whole(p["residual"][k], dim, d_ff)
                          for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0))}
    if place.S is not None:  # x is the token shard (S divides model: cap == Sr)
        return moe_expert_parallel(pe, x, n_experts=E, top_k=top_k,
                                   capacity_factor=capacity_factor,
                                   aux_loss_weight=aux_loss_weight, recipe=place.recipe)
    xs = place.enter_model(x)[:, mr * Sr:(mr + 1) * Sr]
    y, aux = moe_expert_parallel(pe, xs, n_experts=E, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 aux_loss_weight=aux_loss_weight, recipe=place.recipe)
    return place.gather_model(y, 1), aux


# ------------------------------------------------- expert-parallel MoE ----
# Declared overlap intent of the dispatch comm plan.
MOE_DISPATCH_PLAN_INTENT = intent_of("dispatch")


def _ep_ineligible(recipe, B: int, S: int) -> str | None:
    """Why the expert-parallel path cannot run under ``recipe`` for a
    ``(B, S)`` token grid (None = it can)."""
    if recipe is None:
        return "no active sharding recipe"
    mesh = recipe.mesh
    if "model" not in mesh.axis_names or mesh.shape["model"] <= 1:
        return "recipe has no model axis of size > 1 to shard experts over"
    if not recipe.batch_axes:
        return "recipe has no data/pod axes to shard tokens over"
    if S == 1:
        return "decode (S == 1) stays on the dense dropless path"
    R = mesh.shape["model"]
    D = prod(mesh.shape[a] for a in recipe.batch_axes)
    if B % D or S % R:
        return (f"token grid (B={B}, S={S}) does not divide the "
                f"(data={D}, model={R}) mesh")
    return None


def moe_ep_counts(E: int, tokens_per_shard: int, top_k: int,
                  capacity_factor: float) -> tuple[int, ...]:
    """Balanced static counts table: per-expert capacity *per token shard*
    (the ``MPI_Alltoallv`` sendcounts each source rank contributes)."""
    c = int(max(1, round(top_k * tokens_per_shard * capacity_factor / E)))
    return (c,) * E


@dataclasses.dataclass(frozen=True)
class _EpGroup:
    """One plan step: a contiguous slice of every rank's local expert range."""
    lo: int               # local expert index range [lo, hi) on every rank
    hi: int
    gsz: int              # hi - lo (expert slots batched per GEMM)
    gbase: int            # first packed row of this group in the scatter buffer
    Sg: int               # routed rows per source shard (= sum of se)
    se: tuple[int, ...]   # dispatch split extents: rows for each dest rank
    cap_s: int            # wire capacity per (source, dest) block = max(se)
    c_max: int            # max per-expert count in this group (GEMM row cap)
    fwd: np.ndarray       # (R, gsz*R*c_max) arrived-row gather table (-1 = pad)
    inv: np.ndarray       # (R, R*cap_s) GEMM-output repack table (-1 = pad)


@dataclasses.dataclass(frozen=True)
class _EpSchedule:
    E: int
    R: int
    cap_e: int
    e_exts: tuple[int, ...]
    counts: tuple[int, ...]
    Q: int                        # total packed rows per source shard
    comb_base: np.ndarray         # (E,) packed-row base per expert
    groups: tuple[_EpGroup, ...]  # nonempty groups only, in packed order


def moe_ep_schedule(E: int, R: int, counts, n_groups: int) -> _EpSchedule:
    """Host-side plan of the expert-parallel exchange.

    Experts split contiguously over the R model ranks
    (:func:`ragged_expert_extents`); each rank's local range splits into
    ``n_groups`` plan steps.  Rows pack in (group, dest rank, local expert,
    slot) order, so one group is a contiguous slice of the scatter buffer
    and the combine legs' outputs concatenate back into exactly that order.
    ``counts[e]`` may be zero (zero-token experts ride through as zero
    split extents); groups whose total is zero are dropped from the step
    list."""
    cap_e, e_exts = ragged_expert_extents(E, R)
    n_groups = max(1, min(int(n_groups), cap_e))
    cap_g = ceil_div(cap_e, n_groups)
    counts = tuple(int(c) for c in counts)
    if len(counts) != E:
        raise ValueError(f"moe_ep_schedule: {len(counts)} counts for {E} experts")
    if min(counts) < 0:
        raise ValueError("moe_ep_schedule: negative counts")

    comb_base = np.zeros((E,), np.int64)
    groups: list[_EpGroup] = []
    off = 0
    for gi in range(n_groups):
        lo, hi = gi * cap_g, min((gi + 1) * cap_g, cap_e)
        if lo >= hi:
            continue
        gsz = hi - lo
        gbase = off
        se = []
        c_max = 0
        for j in range(R):
            sj = 0
            for l in range(lo, min(hi, e_exts[j])):
                e = j * cap_e + l
                comb_base[e] = off
                off += counts[e]
                sj += counts[e]
                c_max = max(c_max, counts[e])
            se.append(sj)
        Sg = off - gbase
        if Sg == 0:
            continue
        cap_s = max(se)
        fwd = np.full((R, gsz, R, c_max), -1, np.int64)
        inv = np.full((R, R, cap_s), -1, np.int64)
        for j in range(R):
            rowbase = 0
            for lrel in range(gsz):
                l = lo + lrel
                if l >= e_exts[j]:
                    continue
                e = j * cap_e + l
                for c in range(counts[e]):
                    for r in range(R):
                        fwd[j, lrel, r, c] = r * cap_s + rowbase + c
                        inv[j, r, rowbase + c] = (lrel * R + r) * c_max + c
                rowbase += counts[e]
        groups.append(_EpGroup(
            lo=lo, hi=hi, gsz=gsz, gbase=gbase, Sg=Sg, se=tuple(se),
            cap_s=cap_s, c_max=c_max,
            fwd=fwd.reshape(R, gsz * R * c_max).astype(np.int32),
            inv=inv.reshape(R, R * cap_s).astype(np.int32),
        ))
    return _EpSchedule(E=E, R=R, cap_e=cap_e, e_exts=e_exts, counts=counts,
                       Q=off, comb_base=comb_base, groups=tuple(groups))


def moe_comm_model(sched: _EpSchedule, *, d_model: int, itemsize: int,
                   dense_capacity: int | None = None) -> dict:
    """Modeled all-to-all bytes of one expert-parallel MoE call, per shard.

    ``wire_bytes`` counts each leg's R padded ``(cap_s, m)`` blocks, the
    reference's wire convention; ``valid_bytes`` the counts table's routed
    rows (``Sg`` per shard per leg), what this port's split sizes put on
    the wire.  ``dense_capacity`` (the dense path's global C) adds the
    replication the dense modes pay instead: every model rank materializes
    the full ``(E*C, m)`` buffer."""
    wire = sum(2 * sched.R * g.cap_s * d_model * itemsize for g in sched.groups)
    valid = sum(2 * g.Sg * d_model * itemsize for g in sched.groups)
    out = {
        "wire_bytes": wire,
        "valid_bytes": valid,
        "valid_fractions": {"all-to-all": (valid / wire) if wire else 1.0},
    }
    if dense_capacity is not None:
        out["dense_replication_bytes"] = (
            2 * (sched.R - 1) * sched.E * dense_capacity * d_model * itemsize)
    return out


def _take_rows(rows, idx):
    """``rows[idx]`` with a zero row wherever ``idx`` is -1."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])[idx]


def moe_expert_parallel(p, x, *, n_experts: int, top_k: int = 2,
                        capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
                        recipe=None, n_groups: int = 0, counts=None,
                        double_buffer: bool = True):
    """Expert-parallel MoE as one rank's program (see the module docstring).

    ``x (Bd, Sr, m)`` is this rank's token shard: batch rows ``[d*Bd,
    (d+1)*Bd)`` and positions ``[r*Sr, (r+1)*Sr)`` at the rank's ``data``
    coordinate(s) ``d`` and ``model`` coordinate ``r`` (the ``sp_ring``
    forward's chunk when S divides the ring).  Routing and the slot
    assignment run on the shard against the static ``counts`` table
    (per-expert capacity per source shard, zeros allowed).  Per expert
    group the packed rows go by :func:`all_to_allv_start` over ``model`` to
    the experts' owners, :func:`rank_map` runs the owner's expert GEMMs on
    the rows that arrived, through the ``fwd``/``inv`` tables, and the
    combine all-to-all brings them back; a :func:`dispatch` comm plan
    schedules both legs, double-buffered over groups
    (``double_buffer=False`` is the blocking form, bitwise the same).
    Parameters are whole on every rank, each rank reading a view of its own
    experts, or the expert weights are this rank's ``E / R`` (a recipe
    cutting ``e`` over ``model``).  The aux loss's per-expert sums run over
    every token, so one all-reduce over the token ranks carries them,
    issued before the dispatch and waited after it.  Returns this shard's
    ``(y (Bd, Sr, m), aux)``.

    Differentiable: each leg's arrived rows are tied to the rows sent
    (:func:`repro_torch.core.collectives.all_to_allv_tie`, whose backward
    is the reverse leg), and the aux sums to this rank's own
    (:func:`repro_torch.core.collectives.all_reduce_tie`: every rank uses
    the same sums, so the backward is the identity)."""
    r = recipe or current_recipe()
    Bd, Sr, m = x.shape
    if r is None:
        raise ValueError("moe_expert_parallel: no active sharding recipe")
    mesh = r.mesh
    R = int(mesh.shape.get("model", 1))
    bax = tuple(r.batch_axes)
    D = prod(mesh.shape[a] for a in bax)
    why = _ep_ineligible(r, Bd * D, Sr * R)
    if why:
        raise ValueError(f"moe_expert_parallel: {why}")
    E, Tl = n_experts, Bd * Sr
    if counts is None:
        counts = moe_ep_counts(E, Tl, top_k, capacity_factor)
    cap_e, e_exts = ragged_expert_extents(E, R)
    sched = moe_ep_schedule(E, R, counts, n_groups or min(2, cap_e))
    if not sched.groups:
        raise ValueError("moe_expert_parallel: all-zero counts table")
    dev = x.device

    xt = x.reshape(Tl, m)
    probs, gate_vals, gate_idx = _route(xt, p["router"], top_k)
    # the aux loss's sums over every token: one all-reduce over the token
    # ranks, in flight while the experts run
    f32 = scalar(np.float32) ^ vector("e", 2 * E)
    tok = mpi_traverser("T", traverser(scalar(np.float32) ^ vector("T", D * R)), mesh,
                        axes=bax + ("model",))
    own_sums = torch.cat([probs.sum(0), _top1_load(gate_idx, E)])
    stats = all_reduce_start(DistBag(own_sums, f32, tok, ("T",)))

    # shard-local slot assignment against the packed static counts table
    counts_t = torch.tensor(sched.counts, device=dev)
    pos = _positions(gate_idx, E)
    cnt_k = counts_t[gate_idx]
    w = (pos < cnt_k).to(x.dtype)
    slot = torch.tensor(sched.comb_base, device=dev)[gate_idx] + torch.minimum(
        pos, (cnt_k - 1).clamp_min(0))
    # a dropped choice of a zero-count expert past the last packed row adds
    # (and reads) a zero-weighted row: keep its index inside the buffer
    slot = slot.clamp_max(sched.Q - 1)
    buf = x.new_zeros((sched.Q, m)).index_add_(
        0, slot.reshape(-1), (xt[:, None, :] * w[..., None]).reshape(Tl * top_k, m))

    el = layout_dtype(x.dtype)
    dt = mpi_cart_traverser({"D": bax, "M": ("model",)},
                            traverser(scalar(el) ^ vector("D", D) ^ vector("M", R)), mesh)
    in_ext = grid_extents(dt, ("D", "M"), {"M": ("r", (1,) * R)})
    j = dt.coord("M")
    e_base = 0 if p["w_gate"].shape[0] == E else j * cap_e  # the rank's cut of the experts
    steps = []
    for g in sched.groups:
        lo = j * cap_e + g.lo - e_base  # this rank's experts of the group: views, no copy
        n_real = max(0, min(g.hi, e_exts[j]) - g.lo)
        steps.append({
            "g": g,
            "in_tile": scalar(el) ^ vector("em", m) ^ vector("q", g.Sg) ^ vector("r", 1),
            "out_tile": scalar(el) ^ vector("em", m) ^ vector("q", g.cap_s) ^ vector("r", R),
            "out_ext": grid_extents(dt, ("D", "M"), {"M": ("q", g.se)}),
            "n_real": n_real,
            "w": tuple(p[k][lo:lo + n_real] for k in ("w_gate", "w_up", "w_down")),
            "fwd": torch.from_numpy(g.fwd[j].astype(np.int64)).to(dev),
            "inv": torch.from_numpy(g.inv[j].astype(np.int64)).to(dev),
        })

    def transfer(state, s):
        st = steps[s]
        g = st["g"]
        blk = state[g.gbase:g.gbase + g.Sg].reshape(1, g.Sg, m)
        db = st["sent"] = DistBag(blk, st["in_tile"], dt, ("D", "M"), extents=in_ext)
        return all_to_allv_start(db, st["out_tile"], split_dim="q", concat_dim="r",
                                 split_extents=g.se, rank_dim="M")

    def compute(carry, arrived, s):
        st = steps[s]
        g = st["g"]
        arrived = all_to_allv_tie(st["sent"], arrived, split_dim="q", concat_dim="r",
                                  rank_dim="M")

        def gemm(rank, xb):
            rows = xb.data.reshape(R * g.cap_s, m)
            # this rank's experts of the group only: ``inv`` never reads a
            # slot past its last one (a trailing rank may own none)
            xe = _take_rows(rows, st["fwd"]).view(g.gsz, R * g.c_max, m)[:st["n_real"]]
            ye = _experts(xe, *st["w"]).reshape(-1, m)
            return _take_rows(ye, st["inv"]).view(R, g.cap_s, m)

        return rank_map(gemm, dt, arrived, out_tile_layout=st["out_tile"], rank_dim=("D", "M"),
                        out_extents=st["out_ext"])

    def combine(res, s):
        steps[s]["res"] = res
        return all_to_allv_start(res, steps[s]["in_tile"], split_dim="r", concat_dim="q",
                                 split_extents=(1,) * R, rank_dim="M")

    def epilogue(done, state):
        return torch.cat([all_to_allv_tie(st["res"], d, split_dim="r", concat_dim="q",
                                          rank_dim="M").data.reshape(-1, m)
                          for st, d in zip(steps, done)])

    plan = dispatch_plan(len(steps), transfer=transfer, compute=compute, combine=combine,
                         epilogue=epilogue)
    routed = plan.run(buf, None, double_buffer=double_buffer)  # (Q, m)
    y = _combine(routed, slot, gate_vals, w).reshape(Bd, Sr, m)
    if "residual" in p:
        y = y + swiglu(p["residual"], x)
    T = Tl * D * R
    return y, _aux(all_reduce_tie(own_sums, stats.wait()).data, T, E, aux_loss_weight)
