"""Explicit tensor-parallel decode on the comm layer: the port of
``src/repro/serve/tp_decode.py``.

The program says exactly which collective moves, when it is issued and
which compute hides it: the shard-level non-blocking twins
(:func:`repro_torch.core.p2p.shard_all_reduce_start` /
``shard_all_gather_start``) on the shared
:class:`repro_torch.core.request.Pending` request path, scheduled by a
declared :func:`repro_torch.core.plan.stagger` comm plan.

Per decode step and layer, this rank's rows of the batch are split into
``microbatches`` independent row groups.  Each microbatch's attention (and
FFN) produces a *partial* output on this rank's head (or ``d_ff``) shard and
issues its tensor-parallel ``Iallreduce`` over ``model``; because the
microbatches are mutually independent, microbatch ``i``'s reduction
completes behind microbatch ``i+1``'s compute, and each microbatch's
reduction is waited only where the next stage (the FFN, the next layer's
attention) first reads it, so the last microbatch's completes behind the
next stage's compute of the ones before it (:func:`stagger`).  With ``microbatches=1`` every reduction lands on the critical
path (the negative control).  The token embedding is, per microbatch, a
gather from this rank's vocab shard plus an all-reduce with exactly one
nonzero addend, bitwise the plain lookup, staggered the same way; the head is
vocab-sharded, and its logits come back with one ``Iallgather`` along the
vocab over ``model`` and one along the batch over ``data``, so that every
rank (each runs the same engine loop) holds every slot's logits.  The
audio family's frames (``embeds``) take the rank's rows plus sinusoidal
features of their positions, both in the activation dtype, as the
single-host step's :func:`repro_torch.models.lm.embed_inputs` does.

Per-rank state.  The reference's ``shard_map`` hands back global caches.
A step reads and writes, in place, only this rank's block ``k[l, rows_d,
groups_m]`` (and ``v``): the rows of its ``data`` coordinate and the KV
groups of its ``model`` coordinate (:func:`tp_block`).  It takes the K/V in
either of two layouts and tells them apart by shape, axis by axis: the
global allocation (``B`` rows, ``n_kv`` groups), which every rank of a mesh
without a sharding recipe holds, or the rank's block alone (``B / data``
rows, ``n_kv / model`` groups), which a recipe's ``lm.init_cache`` gives
each rank; an axis of one rank has the same slice in both.  In the global
allocation the other blocks go stale on this rank, and nothing reads them:
the engine's admission prefill (the single-host program on the whole
weights, on every rank) writes every group of the admitted slots and then
reads only what it wrote, and it discards its logits; the rows it leaves
idle keep their entries.  Lengths and positions are whole and replicated in
both layouts: every rank advances every row.  A block of the cache is a
strided view whose rows keep the 16-byte alignment the decode kernel wants,
so the kernel reads it in place.

Idle rows (``active`` False) do not write the cache and attend over it
unwritten, as the reference's ``masked_update`` does; their logits are
never sampled.  ``double_buffer=False`` is the blocking interpretation of
the same plans, bitwise equal.

Rounding.  The partial output projections (attention ``wo`` and the FFN's
``w_down`` / ``w_out``) stay float32 through the reduction and are rounded
to the activation dtype once, after the sum, as the reference's
``preferred_element_type=float32`` products are: a sum of rounded partials
is another function.  On the card the form is cuBLAS's bf16 product with a
float32 output (``torch.mm(..., out_dtype=torch.float32)``): the same
float32 accumulation as the single-host step's bf16 ``matmul``, without its
final round.  On the CPU, which has no such product, it is ``torch.matmul``
on float32 upcasts of the activation-dtype operands: upcasting is exact and
the product of two bf16 values is exact in float32, so the sum accumulates
in float32 with no bf16 round.  The reference pins every activation-dtype
boundary (``models/numerics.py``'s ``pin``) so that XLA cannot fold a
convert into a float32 neighbour; eager PyTorch rounds every op's output to
its dtype, so the port has no counterpart.

Scope, the reference's: the dense and audio families, with or without QKV
biases (bias shards ride the head and KV-group shards and are added between
each projection and rope), with the SwiGLU or the GELU MLP (its input bias
cut with its columns, its output bias added once, after the reduction: on
every rank before it, the sum would count it M times); heads, KV groups,
``d_ff`` and ``vocab_padded`` must divide the ``model`` axis, and batch
slots ``data`` x ``microbatches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.p2p import shard_all_gather_start, shard_all_reduce_start
from repro_torch.core.plan import intent_of, stagger
from repro_torch.core.request import Pending
from repro_torch.models import lm
from repro_torch.models.attention import (KVCache, _cache_update, _project, apply_rope,
                                          attention_decode, rope_angles)
from repro_torch.models.blocks import rmsnorm
from repro_torch.models.sharding import partial_product as _partial

__all__ = ["make_tp_decode_step", "tp_block", "tp_decode_specs", "DECODE_TP_PLAN_INTENT"]

# declared overlap intent of the decode schedule
DECODE_TP_PLAN_INTENT = intent_of("stagger")


def _check(cfg, mesh, slots: int, microbatches: int) -> None:
    if cfg.family not in ("dense", "audio"):
        raise ValueError(f"tp decode supports the dense and audio families, not {cfg.family!r}")
    if cfg.n_experts:
        raise ValueError("tp decode: MoE blocks not supported")
    for name in ("data", "model"):
        if name not in mesh.shape:
            raise ValueError(f"tp decode needs a (data, model) mesh, missing {name!r}")
    msize = mesh.shape["model"]
    for label, n in (("n_heads", cfg.n_heads), ("n_kv", cfg.n_kv),
                     ("d_ff", cfg.d_ff), ("vocab_padded", cfg.vocab_padded)):
        if n % msize:
            raise ValueError(f"tp decode: {label}={n} must divide model axis {msize}")
    dsize = mesh.shape["data"]
    if microbatches < 1 or slots % dsize or (slots // dsize) % microbatches:
        raise ValueError(
            f"tp decode: {slots} slots must split over data={dsize} x "
            f"microbatches={microbatches}"
        )


def tp_decode_specs(cfg, *, stacked: bool = True):
    """Spec trees (params, cache k/v, cache length) of the explicit TP
    decode layout: heads, KV groups, FFN hidden and vocab over ``model``,
    batch slots over ``data``, everything else replicated.  A spec has one
    entry per tensor dim, a mesh axis or ``None``, as the reference's
    ``PartitionSpec``; :func:`repro_torch.models.weights.shard_params` cuts
    a rank's parameters by it."""
    lead = (None,) if stacked else ()
    attn = {
        "wq": (*lead, None, "model", None),
        "wk": (*lead, None, "model", None),
        "wv": (*lead, None, "model", None),
        "wo": (*lead, "model", None, None),
    }
    if cfg.qkv_bias:
        # biases ride the head/KV-group shards of their projections
        attn["bq"] = (*lead, "model", None)
        attn["bk"] = (*lead, "model", None)
        attn["bv"] = (*lead, "model", None)
    if cfg.ffn_kind == "gelu":
        ffn = {"w_in": (*lead, None, "model"), "w_out": (*lead, "model", None),
               "b_in": (*lead, "model"), "b_out": (*lead, None)}
    else:
        ffn = {"w_gate": (*lead, None, "model"), "w_up": (*lead, None, "model"),
               "w_down": (*lead, "model", None)}
    params = {
        "final_norm": (None,),
        "blocks": {"ln1": (*lead, None), "ln2": (*lead, None), "attn": attn, "ffn": ffn},
    }
    if cfg.input_kind != "embeds":
        params["embed"] = ("model", None)
    if not cfg.tie_embeddings:
        params["lm_head"] = (None, "model")
    kv = (*lead, "data", "model", None, None)
    return params, kv, (*lead, "data")


def tp_block(cfg, mesh, slots: int) -> tuple[slice, slice]:
    """This rank's block of the TP decode's K/V: ``(rows, groups)``, its
    ``data`` coordinate's slice of the ``slots`` rows and its ``model``
    coordinate's slice of the KV groups."""
    coords = mesh.coords()
    Bl, gl = slots // mesh.shape["data"], cfg.n_kv // mesh.shape["model"]
    return (slice(coords["data"] * Bl, (coords["data"] + 1) * Bl),
            slice(coords["model"] * gl, (coords["model"] + 1) * gl))


def _own(n: int, whole: int, block: slice, what: str) -> slice:
    """This rank's slice of a cache axis of ``n`` entries: ``block`` of the
    global allocation's ``whole``, or all of an axis that holds the block
    alone."""
    if n == whole:
        return block
    if n == block.stop - block.start:
        return slice(None)
    raise ValueError(f"tp decode: a cache of {n} {what} is neither the whole {whole} "
                     f"nor this rank's {block.stop - block.start}")


def make_tp_decode_step(cfg, mesh, *, slots: int, microbatches: int = 2,
                        double_buffer: bool = True, attn_impl: str | None = None):
    """Build this rank's ``step(params, state, batch, active) -> (logits,
    new_state)``.

    ``params`` is this rank's shard (``shard_params(params,
    tp_decode_specs(cfg)[0], mesh)``); ``state`` the stacked
    :class:`repro_torch.models.lm.DecodeState` over all ``slots`` (the
    global allocation or this rank's block of it, see the module
    docstring), whose K/V are updated in place; ``batch`` holds
    ``tokens`` (B, S), or the audio family's ``embeds`` (B, S, m), for all
    slots; ``active`` (B,) bool marks the slots that carry a real token this step.  Returns every
    slot's (B, S, vocab_padded) logits, the same on every rank.
    ``attn_impl`` picks the attention path as ``cfg.attn_impl`` does
    (``None``: the decode kernel on the card, its plain version on the
    CPU)."""
    _check(cfg, mesh, slots, microbatches)
    for axis in ("data", "model"):  # collective: every rank builds the step
        mesh.create_groups((axis,))
    M, D = mesh.shape["model"], mesh.shape["data"]
    coords = mesh.coords()
    mb = microbatches
    Bl = slots // D
    bm = Bl // mb
    rows_d, groups = tp_block(cfg, mesh, slots)
    vl = cfg.vocab_padded // M
    v0 = coords["model"] * vl
    act_dt = cfg.act_dtype
    mbs = [slice(s * bm, (s + 1) * bm) for s in range(mb)]
    embeds_in = cfg.input_kind == "embeds"

    def reduce(part, _s):
        return shard_all_reduce_start(part, "model", mesh=mesh)

    def embed(params, batch, pos2d):
        """The embedding of every microbatch, as requests: the frames plus
        sinusoidal positions (no transfer), or each microbatch's local
        vocab-shard gather with its all-reduce (one nonzero addend) in
        flight, staggered like the blocks' reductions."""
        if embeds_in:  # the frames plus sinusoidal positions, in the activation dtype
            x = (batch["embeds"][rows_d].to(act_dt)
                 + lm._sinusoidal(pos2d, cfg.d_model).to(act_dt))
            return [Pending(lambda r=r: x[r], op="embed") for r in mbs]
        tokens = batch["tokens"][rows_d]
        table = params["embed"].to(act_dt)

        def lookup(_c, _s, s):
            loc = tokens[mbs[s]] - v0
            ok = (loc >= 0) & (loc < vl)
            e = table[loc.clamp(0, vl - 1)]
            return torch.where(ok[..., None], e, torch.zeros((), dtype=act_dt, device=e.device))

        return stagger(mb, transfer=reduce, compute=lookup).run(
            None, None, double_buffer=double_buffer)

    def step(params, state, batch, active):
        caches = state.caches
        rows_kv = _own(caches.k.shape[1], slots, rows_d, "rows")
        groups_kv = _own(caches.k.shape[2], cfg.n_kv, groups, "KV groups")
        act = active[rows_d]
        counts = act.to(torch.int32)
        S = batch["embeds" if embeds_in else "tokens"].shape[1]
        positions = state.positions[rows_d]
        pos2d = positions[:, None] + torch.arange(S, dtype=positions.dtype,
                                                  device=positions.device)[None, :]
        # each microbatch's last stage in flight, with the epilogue its sum
        # takes before it enters the microbatch's stream: a stage's compute
        # of microbatch s first settles s's previous stage, so that transfer
        # lands behind the compute of the microbatches before s
        inflight = [(req, lambda d: d) for req in embed(params, batch, pos2d)]
        xs: list = [None] * mb

        def settle(s):
            req, epilogue = inflight[s]
            d = epilogue(req.wait())
            xs[s] = d if xs[s] is None else xs[s] + d

        def run_stage(part, epilogue):
            def compute(_c, _s, s):
                settle(s)
                return part(s)

            reqs = stagger(mb, transfer=reduce, compute=compute).run(
                None, None, double_buffer=double_buffer)
            inflight[:] = [(req, epilogue) for req in reqs]

        blocks = params["blocks"]
        for l in range(cfg.n_layers):
            p = {k: v[l] for k, v in blocks["attn"].items()}
            f = {k: v[l] for k, v in blocks["ffn"].items()}
            ln1, ln2 = blocks["ln1"][l], blocks["ln2"][l]
            length = caches.length[l, rows_d]
            kc = caches.k[l, rows_kv, groups_kv]  # this rank's block, a view
            vc = caches.v[l, rows_kv, groups_kv]

            def attn_part(s, p=p, ln1=ln1, length=length, kc=kc, vc=vc):
                r = mbs[s]
                xn = rmsnorm(ln1, xs[s])
                q, k, v = _project(xn, p["wq"]), _project(xn, p["wk"]), _project(xn, p["wv"])
                if "bq" in p:  # the local bias shards, between projection and rope
                    q = q + p["bq"].to(xn.dtype)[None, :, None, :]
                    k = k + p["bk"].to(xn.dtype)[None, :, None, :]
                    v = v + p["bv"].to(xn.dtype)[None, :, None, :]
                cos, sin = rope_angles(pos2d[r], cfg.head_dim, cfg.rope_theta)
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
                _cache_update(kc[r], k, length[r], act[r])
                _cache_update(vc[r], v, length[r], act[r])
                o = attention_decode(q, kc[r], vc[r], length[r] + counts[r],
                                     q_positions=pos2d[r], impl=attn_impl, block=cfg.attn_block)
                B_, h, S_, d = o.shape
                # this rank's head shard of the output projection: the partial
                # the transfer stage reduces behind the next microbatch's math
                return _partial(o.transpose(1, 2).reshape(B_, S_, h * d),
                                p["wo"].reshape(h * d, -1))

            run_stage(attn_part, lambda d: d.to(act_dt))

            if cfg.ffn_kind == "gelu":
                def ffn_part(s, f=f, ln2=ln2):
                    xn = rmsnorm(ln2, xs[s])
                    h = F.gelu(torch.matmul(xn, f["w_in"].to(xn.dtype)) + f["b_in"].to(xn.dtype),
                               approximate="tanh")
                    return _partial(h, f["w_out"])

                def ffn_epilogue(d, f=f):
                    # round the float32 sum once, then add the replicated bias
                    return d.to(act_dt) + f["b_out"].to(act_dt)
            else:
                def ffn_part(s, f=f, ln2=ln2):
                    xn = rmsnorm(ln2, xs[s])
                    g = torch.matmul(xn, f["w_gate"].to(xn.dtype))
                    u = torch.matmul(xn, f["w_up"].to(xn.dtype))
                    return _partial(F.silu(g) * u, f["w_down"])

                def ffn_epilogue(d):
                    return d.to(act_dt)

            run_stage(ffn_part, ffn_epilogue)

        for s in range(mb):
            settle(s)
        xn = rmsnorm(params["final_norm"], torch.cat(xs, dim=0))
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        # vocab-sharded head: each rank's logit columns are full dots
        logits = torch.matmul(xn, head.to(xn.dtype))
        logits = shard_all_gather_start(logits, "model", mesh=mesh, axis=2).wait()
        logits = shard_all_gather_start(logits, "data", mesh=mesh, axis=0).wait()
        adv = active.to(torch.int32)
        new_len = (caches.length + adv[None, :]).to(caches.length.dtype)
        new_state = lm.DecodeState(caches=KVCache(caches.k, caches.v, new_len),
                                   positions=(state.positions + adv).to(state.positions.dtype))
        return logits, new_state

    return step
