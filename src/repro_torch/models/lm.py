"""The dense, MoE, MLA, VLM (llama-3.2-vision), audio (musicgen), SSM
(rwkv6) and hybrid (zamba2) language models: embeddings -> block stack ->
head, with the full-sequence forward and the serving decode step.

Layer parameters, like the reference's, are stacked on a leading ``l`` dim
(``params["blocks"]`` leaves are ``(L, ...)``), and so are the caches (K/V
for ``dense`` and ``moe``, the latent ``c``/``kr`` for ``mla``, the
recurrent states for ``ssm``); the reference's ``lax.scan`` over them
becomes a Python loop over the layer index.  The hybrid family stacks its
Mamba2 blocks by super-block, ``(n_shared, group_m, ...)``, with one LoRA
per shared application ``(n_shared, ...)``, one unstacked shared attention
block, and ``n_tail`` trailing Mamba2 blocks; its cache is the Mamba2
states stacked the same way and the shared block's ring-buffer K/V of
``min(max_len, shared_window)`` positions a application.  The VLM
family stacks its self-attention blocks by group, ``self_blocks``
``(n_cross, group_self, ...)``, each group followed by one gated
cross-attention block ``cross_blocks`` ``(n_cross, ...)`` over the image's
states ``batch["image_embeds"]`` (the ``tokens+image`` input kind); its
cache is the self blocks' K/V stacked the same way, and the image's K/V
are recomputed every step, as the reference does.  The audio family is the
dense stack (GELU MLP) over the ``embeds`` input kind: the stub codec's
frame embeddings plus sinusoidal positions (:func:`embed_inputs`), with no
``embed`` table.

Under an active recipe (:mod:`repro_torch.models.sharding`) the
parameters are this rank's shards (``weights.shard_params_by_recipe``) and
the program is this rank's part of the recipe's.  The batch is this rank's
blocks of it (:func:`repro_torch.models.sharding.local_batch`, the
reference's ``batch_shardings``), a
:class:`~repro_torch.models.sharding.RankBatch` that carries the global
shapes; a whole dict under a recipe raises ``TypeError``, and no path
narrows a whole batch.  Under ``tp`` and plain ``sp``
(:func:`_forward_placed`, :func:`_decode_placed`) a rank runs its rows of
the batch, gathers each block's FSDP-cut weights over ``data``
before the block, keeps the residual stream whole over ``model``, and
runs its heads (``tp``) or its chunk of the queries (``sp``) and its
block of the FFN's hidden columns, the partials summed over ``model``
(under plain ``sp`` the cache-less forward of the dense, MoE, audio and
VLM stacks carries the residual as the rank's chunk of the sequence instead,
as the reference's compiled program does: :func:`_forward_placed`); the
embedding and the head are vocab-sharded (a lookup whose all-reduce has one
nonzero addend, and the head's columns).  The logits stay cut as the
recipe's ``logits`` spec cuts them
(:func:`repro_torch.models.sharding.logits_spec`): every rank returns its
rows' block of the vocab, ``(B_local, S, vocab_padded / M)``, and nothing
on the training or serving path makes them whole (:func:`loss_fn` is
vocab-parallel; serving gathers the sampled position alone,
:func:`last_logits`); :func:`gather_logits` is for a caller that needs
them whole.  ``decode_step`` and :func:`init_cache` take the caches cut by
``decode_state_shardings``.
Under ``sp_ring`` the forward is sequence-parallel: each rank keeps its
contiguous, padded chunk of the residual stream (and its share of the
batch over the ``data`` axes) through every block, and attention runs as
the ``model``-axis ring, on whole weights, one layer at a time (each
block gathers its layer's cut leaves inside its checkpoint); its rows'
final states are gathered over ``model`` alone, and the head
makes the same block of the logits as under ``tp``.  A MoE block routes
the chunk by expert parallelism (``moe_dispatch="ep"``) where the recipe's
grid fits, else by the whole grid's dispatch
(:func:`repro_torch.models.ffn.moe_ffn`).  The SSM and hybrid families
run under every mode: under ``tp``/``sp`` their mixers by heads
(:func:`repro_torch.models.ssm.rwkv6_mix_placed`,
:func:`repro_torch.models.ssm.mamba2_mix_placed`; the recurrent states in
decode are the rank's blocks), and under ``sp_ring`` each recurrent block
runs over the sequence gathered over ``model`` and keeps the rank's chunk
(the reference's GSPMD program does the same), while zamba2's shared
attention rings.  The MLA family runs its heads (``tp``) or its query chunk
(``sp``) and, under ``sp_ring``, gathers its chunk's latents and runs one
carry step of its queries over the whole sequence; in decode its latent
caches are cut by sequence and the ranks' partial softmaxes merge by their
log-sum-exp (:func:`repro_torch.models.attention.mla_attention_placed`).
The MoE family's FFN under ``tp``/``sp`` is
:func:`repro_torch.models.ffn.moe_placed` (expert parallelism where the
grid hosts it, else the capacity dispatch over the tokens the reference
routes together, the experts or their columns split over ``model``), and
its aux loss is summed over the blocks as without a recipe.  The audio
family takes this rank's rows of the frames (under ``sp_ring`` its chunk of
them, as handed where ``model`` divides S, else cut from its rows' whole
sequence and padded with zero frames) and adds the sinusoid at their
absolute positions; it has no ``embed`` table, and its untied head is the vocab-cut
``lm_head``.  The VLM family runs each group's self blocks as the dense
family's, the nested ``(n_cross, group_self, ...)`` leaves bound with both
stack dims dropped, and each cross block over this rank's rows of the
image (the recipe's ``enc`` spec: the whole image on every ``model`` rank)
by heads (``tp``) or by the rank's chunk of the sequence, the residual
it carries (plain ``sp``,
:func:`repro_torch.models.attention.cross_attention_placed`); under
``sp_ring`` the chunk's queries attend over the whole image of its rows,
with no ring.  Its decode caches are the self blocks' K/V alone, cut as the
dense family's.  The explicit tensor-parallel decode step (the dense and
audio families) is :mod:`repro_torch.serve.tp_decode`.

Training (:func:`loss_fn`, :mod:`repro_torch.train.trainer`) differentiates
the float32 parameters themselves: every use casts a weight to the
activation dtype (``w.to(x.dtype)``), so the gradients come back float32,
as JAX's do.  ``cfg.remat == "block"`` checkpoints each block, and the
hybrid and VLM families each super-block too (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` per scanned body), when a gradient is being
taken.  Under a recipe each rank's gradients are those of its shards: the
collectives are differentiable (:class:`repro_torch.models.sharding.Placement`),
and under ``sp_ring`` the parameters used by this rank's chunk sum their
partial gradients over the ranks
(:meth:`repro_torch.models.sharding.TokenShard.partial`).  A checkpointed
block takes its layer's weights as the rank holds them and gathers them
first thing inside (:func:`_block`, :func:`_user`): the checkpoint keeps
the shards, which are views of the parameters, and its recompute gathers
again, so no layer's gathered weights outlive its block.  The stacks'
layers are taken by one ``unbind`` a leaf (:func:`_layers`), so a layer's
backward writes only its own slice of the stacked gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dist import resolve_device
from repro_torch.core.p2p import shard_all_reduce_start

from . import attention as attn_mod
from . import blocks as blk
from . import ssm as ssm_mod
from .module import init_params, pspec, stack_specs, tree_map, tree_size
from .sharding import (Placement, all_gather, all_reduce, batch_rows, current_recipe,
                       decode_state_shardings, gather_cut, local_shape, logits_spec, placement,
                       rank_batch, recipe_pspecs, spec_axes, sum_grads, token_shard)

__all__ = ["build_specs", "count_params", "embed_inputs", "lm_logits", "forward", "loss_fn",
           "gather_logits", "last_logits", "DecodeState", "init_cache", "decode_step",
           "init_model", "abstract_model", "hybrid_dims", "vlm_dims"]

_FAMILIES = ("dense", "moe", "mla", "vlm", "ssm", "hybrid", "audio")


# ================================================================= specs ====

def hybrid_dims(cfg) -> tuple[int, int, int]:
    """``(n_shared, group_m, n_tail)`` of the hybrid family: shared
    applications, Mamba2 blocks before each, and trailing Mamba2 blocks."""
    n_shared = cfg.n_layers // cfg.shared_every
    group_m = cfg.shared_every - 1
    return n_shared, group_m, cfg.n_layers - n_shared - n_shared * group_m


def vlm_dims(cfg) -> tuple[int, int]:
    """``(n_cross, group_self)`` of the VLM family: cross-attention blocks,
    and self-attention blocks before each."""
    n_cross = cfg.n_layers // cfg.cross_every
    group_self = cfg.cross_every - 1
    if cfg.n_layers != n_cross * cfg.cross_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of cross_every = "
                         f"{cfg.cross_every}")
    return n_cross, group_self


def build_specs(cfg) -> dict:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    dt = cfg.param_dtype
    specs: dict[str, Any] = {"final_norm": blk.norm_spec(cfg.d_model, dt)}
    if cfg.input_kind in ("tokens", "tokens+image"):
        specs["embed"] = pspec(("v", cfg.vocab_padded), ("m", cfg.d_model), dtype=dt,
                               init="embed")
    if not cfg.tie_embeddings:
        specs["lm_head"] = pspec(("m", cfg.d_model), ("v", cfg.vocab_padded), dtype=dt,
                                 fan_in=("m",))
    if cfg.family == "hybrid":
        n_shared, group_m, n_tail = hybrid_dims(cfg)
        specs["mamba_blocks"] = stack_specs(
            stack_specs(blk.mamba_block_specs(cfg), group_m, dim="l2"), n_shared)
        if n_tail:
            specs["tail_blocks"] = stack_specs(blk.mamba_block_specs(cfg), n_tail)
        specs["shared_block"] = blk.shared_attn_block_specs(cfg)
        specs["shared_lora"] = stack_specs(blk.shared_lora_specs(cfg, cfg.shared_lora_rank),
                                           n_shared)
        return specs
    if cfg.family == "vlm":
        n_cross, group_self = vlm_dims(cfg)
        specs["self_blocks"] = stack_specs(
            stack_specs(blk.attn_block_specs(cfg), group_self, dim="l2"), n_cross)
        specs["cross_blocks"] = stack_specs(blk.cross_block_specs(cfg), n_cross)
        return specs
    block_specs = {"mla": blk.mla_block_specs, "ssm": blk.rwkv_block_specs}.get(
        cfg.family, blk.attn_block_specs)
    specs["blocks"] = stack_specs(block_specs(cfg), cfg.n_layers)
    return specs


def count_params(cfg, *, active_only: bool = False) -> int:
    """Total parameter count, or with ``active_only`` the count a token
    uses: the MoE's unchosen experts' weights left out."""
    n = tree_size(build_specs(cfg))
    if active_only and cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.d_ff  # gate/up/down
        n -= (cfg.n_experts - cfg.moe_top_k) * per_expert * cfg.n_layers
    return int(n)


# ============================================================= embeddings ====

def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (...,) -> (..., d) float32 ``[sin, cos]`` features: shared
    (S,) and per-row (B, S) position grids alike (continuous batching
    offsets every slot on its own), the reference's ``_sinusoidal``."""
    half = d // 2
    scale = torch.tensor(-math.log(10000.0), dtype=torch.float32, device=positions.device)
    freq = torch.exp(scale * torch.arange(half, dtype=torch.float32, device=positions.device)
                     / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_inputs(params, batch, cfg, *, positions=None):
    """batch -> (B, S, m) activations in cfg.act_dtype: the token lookup,
    or for the ``embeds`` input kind ``batch["embeds"]`` plus sinusoidal
    features of ``positions`` ((S,) or per row (B, S); default
    ``arange(S)``), each cast to the activation dtype first and added there,
    in the reference's order of rounding."""
    if cfg.input_kind != "embeds":
        return params["embed"].to(cfg.act_dtype)[batch["tokens"]]
    x = batch["embeds"].to(cfg.act_dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    pe = _sinusoidal(positions, cfg.d_model).to(cfg.act_dtype)
    return x + (pe if pe.ndim == 3 else pe[None])


def _input_of(batch, cfg) -> torch.Tensor:
    """The batch's leading input: token ids (B, S), or the ``embeds`` input
    kind's frames (B, S, m)."""
    return batch["embeds" if cfg.input_kind == "embeds" else "tokens"]


def _global_rows_seq(batch, cfg) -> tuple[int, int]:
    """``(B, S)`` of the global batch whose blocks ``batch`` (a
    :class:`~repro_torch.models.sharding.RankBatch`) are."""
    return batch.shapes["embeds" if cfg.input_kind == "embeds" else "tokens"][:2]


def lm_logits(params, x, cfg):
    """(B, S, vocab_padded) logits; the tied head is ``x @ embed.T``."""
    x = blk.rmsnorm(params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head.to(x.dtype))


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(L, ...)`` leaves (views), for a
    step without a gradient (a layer's ``select`` writes a zero-filled
    ``(L, ...)`` gradient in the backward: :func:`_layers` does not)."""
    return tree_map(lambda t: t[i], tree)


def _layers(tree) -> list:
    """Every layer of a tree of stacked ``(L, ...)`` leaves, one tree of
    views a layer, taken by one ``unbind`` a leaf: its backward stacks the
    layers' gradients once, each into a slice of its own (the reference's
    scan returns the stacked gradient so)."""
    if isinstance(tree, dict):
        parts = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _remat(fn, cfg):
    """``fn`` checkpointed when ``cfg.remat`` is ``"block"`` and a gradient
    is being taken (the reference's ``_maybe_remat``): its activations are
    recomputed in the backward."""
    if cfg.remat != "block" or not torch.is_grad_enabled():
        return fn
    return lambda *args, **kw: checkpoint(fn, *args, use_reentrant=False, **kw)


def _block(cfg, use=None):
    """The family's block function (the hybrid's Mamba2 block), under
    :func:`_remat`.  With ``use`` it takes the layer's weights as this rank
    holds them and ``use`` makes them ready (gathers them) first thing
    inside the checkpoint: the checkpoint keeps the rank's shards, and its
    recompute gathers again, as the reference's ``jax.checkpoint`` of a
    body that takes the sharded layer."""
    fn = {"mla": blk.mla_block, "ssm": blk.rwkv_block,
          "hybrid": blk.mamba_block}.get(cfg.family, blk.attn_block)
    if use is None:
        return _remat(fn, cfg)
    return _remat(lambda p, *args, **kw: fn(use(p), *args, **kw), cfg)


# ================================================================ forward ====

def forward(params, batch, cfg, *, positions=None):
    """Full-sequence forward (prefill without cache).  Returns
    ``(logits, aux_loss)``; the aux loss sums the MoE blocks' (0 for the
    dense family).

    Under an active recipe every rank takes its blocks of the batch (a
    :class:`~repro_torch.models.sharding.RankBatch` from
    :func:`~repro_torch.models.sharding.local_batch`; a whole dict raises
    ``TypeError``) and this rank's shards of the parameters, computes only
    its own part (:func:`_forward_placed`, :func:`_forward_sp_ring`) and
    returns its block of the logits, cut by
    :func:`repro_torch.models.sharding.logits_spec` (:func:`gather_logits`
    makes them whole), and the aux loss, the same on every rank."""
    recipe = current_recipe()
    if recipe is not None:
        batch = rank_batch(recipe, batch, "lm.forward")
        if recipe.sp_ring:
            return _forward_sp_ring(params, batch, cfg, recipe, positions)
        return _forward_placed(params, batch, cfg, recipe, positions)
    x = embed_inputs(params, batch, cfg, positions=positions)
    block = _block(cfg)
    aux = 0.0
    if cfg.family == "ssm":
        for p in _layers(params["blocks"]):
            x, _, _ = block(p, x, cfg)
    elif cfg.family == "hybrid":
        x = _forward_hybrid(params, x, cfg, positions, use=_user(None, None))
    elif cfg.family == "vlm":
        x = _forward_vlm(params, x, batch["image_embeds"], cfg, positions, use=_user(None, None))
    else:
        for p in _layers(params["blocks"]):
            x, _, a = block(p, x, cfg, positions=positions)
            aux = aux + a
    return lm_logits(params, x, cfg), torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def _forward_hybrid(params, x, cfg, positions, *, use, place=None, shard=None):
    """The hybrid stack: ``n_shared`` super-blocks of ``group_m`` Mamba2
    blocks and the shared attention block under that application's LoRA
    (each super-block, and each Mamba2 block in it, under :func:`_remat`),
    then the tail's Mamba2 blocks.  ``params`` are as this rank holds them
    and ``use`` (:func:`_user`) makes a block's weights ready inside the
    checkpoint that runs it: each Mamba2 block's inside its own, the LoRA's
    and the shared block's inside the super-block's (the shared block is
    so gathered once a super-block, the reference's group closing over the
    sharded ``params["shared_block"]``).  Under a ``tp``/``sp`` recipe
    (``place``) ``x`` is this rank's rows; under ``sp_ring`` (``shard``)
    its chunk."""
    n_shared, group_m, n_tail = hybrid_dims(cfg)
    kw = dict(place=place, shard=shard)
    mamba = _block(cfg, lambda p: use(p, "mamba_blocks", 2))

    def group(p_mamba, p_lora, p_shared, x):
        for p in _layers(p_mamba):
            x, _, _ = mamba(p, x, cfg, **kw)
        x, _, _ = blk.shared_attn_block(use(p_shared, "shared_block", 0),
                                        use(p_lora, "shared_lora", 1), x, cfg,
                                        positions=positions, **kw)
        return x

    group = _remat(group, cfg)
    for p_mamba, p_lora in zip(_layers(params["mamba_blocks"]), _layers(params["shared_lora"])):
        x = group(p_mamba, p_lora, params["shared_block"], x)
    if n_tail:
        tail = _block(cfg, lambda p: use(p, "tail_blocks", 1))
        for p in _layers(params["tail_blocks"]):
            x, _, _ = tail(p, x, cfg, **kw)
    return x


def _forward_vlm(params, x, enc, cfg, positions, *, use, place=None, shard=None):
    """The VLM stack: ``n_cross`` groups of ``group_self`` self-attention
    blocks and one gated cross-attention block over the image's states
    ``enc`` (each group, and each self block in it, under :func:`_remat`,
    the reference's ``_maybe_remat`` of its scanned bodies).  ``params``
    are as this rank holds them and ``use`` (:func:`_user`) makes a block's
    weights ready inside the checkpoint that runs it: each self block's
    inside its own, the cross block's inside the group's.  Under a
    ``tp``/``sp`` recipe (``place``) ``enc`` are this rank's rows' images
    and ``x`` its rows, or where ``place.S`` is set (plain ``sp``) its
    chunk of their sequence: the group's checkpoint, each self block's and
    the cross block take the chunk, and the cross block's queries are the
    chunk's.  Under ``sp_ring`` (``shard``) ``x`` is this rank's chunk and
    ``enc`` its rows' images."""
    n_cross, group_self = vlm_dims(cfg)
    block = _block(cfg, lambda p: use(p, "self_blocks", 2))

    def group(p_self, p_cross, x):
        for p in _layers(p_self):
            x, _, _ = block(p, x, cfg, positions=positions, place=place, shard=shard)
        return blk.cross_block(use(p_cross, "cross_blocks", 1), x, enc, cfg, place=place)

    group = _remat(group, cfg)
    for p_self, p_cross in zip(_layers(params["self_blocks"]), _layers(params["cross_blocks"])):
        x = group(p_self, p_cross, x)
    return x


def _forward_sp_ring(params, batch, cfg, recipe, positions):
    """The forward on this rank of a sequence-parallel recipe's mesh.

    ``batch`` is this rank's blocks: its rows (every row where the batch
    axes do not divide B), token ids over their whole sequence, the
    ``embeds`` frames as this rank's chunk where ``model`` divides S (the
    recipe's ``hidden`` spec), else over their whole sequence, cut here
    (:meth:`TokenShard.local_seq`).  The sequence of S tokens pads to
    R = |model| chunks of ``cap`` (:func:`ragged_seq_extents`) and this rank
    keeps chunk ``r``, at absolute positions ``r*cap + i`` for RoPE, through
    every block (the recipe's ``hidden`` spec: (B, model, None)); attention
    is the ring, with the padded keys masked.  The blocks run on whole
    weights, one layer at a time: ``params`` are this rank's shards (or
    whole leaves) and each block gathers its layer whole inside its
    checkpoint (:func:`_user`; the hybrid's and the VLM's nested blocks as
    :func:`_forward_hybrid` and :func:`_forward_vlm` say).  The embedding
    and the final norm are gathered whole before and after the blocks.  The
    final norm runs on the chunk; the rank's rows' normed states are
    gathered along ``model`` alone, the padding dropped, and the head makes
    the rank's block of the logits (:func:`_head_sp_ring`).  Every rank
    returns the same aux loss."""
    specs, pspecs = _recipe_pspecs(cfg, recipe)
    inputs = _input_of(batch, cfg)
    B, S = _global_rows_seq(batch, cfg)
    dev = inputs.device
    shard = token_shard(recipe, B, S)
    use = _user(None, pspecs, shard=shard, specs=specs)
    if positions is None:
        positions = torch.arange(S, device=dev)
    pad = recipe.mesh.shape.get("model", 1) * shard.cap - S
    pos = torch.cat([positions, positions[-1] + 1 + torch.arange(pad, device=dev)])
    chunk = slice(shard.chunk * shard.cap, (shard.chunk + 1) * shard.cap)
    embed = None
    if cfg.input_kind == "embeds":  # the chunk's frames (zero past S), sinusoid at pos[chunk]
        frames = shard.local_seq(inputs) if inputs.shape[1] == S else inputs
        x = embed_inputs(params, {"embeds": frames}, cfg, positions=pos[chunk])
    else:
        embed = _gather_whole(params["embed"], specs["embed"].shape, pspecs["embed"], recipe.mesh)
        x = embed_inputs({"embed": shard.partial(embed)}, {"tokens": shard.local_seq(inputs)},
                         cfg)
    aux = 0.0
    if cfg.family == "hybrid":
        x = _forward_hybrid(params, x, cfg, pos[chunk], use=use, shard=shard)
    elif cfg.family == "vlm":  # the image split by the chunk's rows, never by sequence
        x = _forward_vlm(params, x, batch["image_embeds"], cfg, pos[chunk], use=use, shard=shard)
    else:
        block = _block(cfg, lambda p: use(p, "blocks", 1))
        kw = {} if cfg.family == "ssm" else {"positions": pos[chunk]}
        for p in _layers(params["blocks"]):
            x, _, a = block(p, x, cfg, shard=shard, **kw)
            aux = aux + a
    return (_head_sp_ring(params, embed, x, cfg, recipe, shard, use),
            torch.as_tensor(aux, dtype=torch.float32, device=x.device))


def _head_sp_ring(params, embed, x, cfg, recipe, shard, use):
    """This rank's block of the logits under ``sp_ring``
    (:func:`repro_torch.models.sharding.logits_spec`) from its chunk ``x``
    of the final states; ``embed`` the whole embedding the lookup took,
    ``use`` the forward's :func:`_user`.  Where the recipe cuts ``v``, each
    ``model`` rank applies its vocab block of the head to its rows' whole
    sequence, and the gather's cotangents are partials (reduce-scattered).
    An untied head cut over ``model`` is that block already: it is gathered
    over its other axes alone, as :meth:`Placement.use` gathers a weight
    for the rank's rows.  A tied head is the lookup's whole embedding (and
    a whole head is whole), narrowed, its gradient summed over the ranks
    (:meth:`TokenShard.partial`).  Where ``v`` is whole, every ``model``
    rank applies the whole head, the same work, so the head's gradient is
    summed over the batch axes alone."""
    mesh = recipe.mesh
    specs, pspecs = _recipe_pspecs(cfg, recipe)
    x = blk.rmsnorm(use(params["final_norm"], "final_norm", 0), x)
    cut = logits_spec(recipe, shard.B)[2] is not None
    if cut and not cfg.tie_embeddings and params["lm_head"].shape[1] != cfg.vocab_padded:
        rows = Placement(recipe=recipe, batch_axes=shard.batch_axes, row0=shard.row0,
                         n_rows=shard.n_rows)
        head = rows.use(params["lm_head"], pspecs["lm_head"])
        return torch.matmul(shard.gather_seq(x), head.to(x.dtype))
    head = embed.T if cfg.tie_embeddings else _gather_whole(
        params["lm_head"], specs["lm_head"].shape, pspecs["lm_head"], mesh)
    if not cut:
        x = all_gather(x, mesh, "model", 1, split=False)[:, :shard.S]
        return torch.matmul(x, sum_grads(head, mesh, shard.batch_axes).to(x.dtype))
    vl = cfg.vocab_padded // mesh.shape["model"]
    head = shard.partial(head).narrow(1, shard.chunk * vl, vl)
    return torch.matmul(shard.gather_seq(x), head.to(x.dtype))


# ======================================================== under a recipe ====

_PSPECS: dict = {}


def _recipe_pspecs(cfg, recipe):
    """The recipe's per-leaf specs of ``cfg``'s parameters, one entry per
    buffer axis (kept per recipe: a decode step asks every step)."""
    key = (id(recipe), cfg)
    hit = _PSPECS.get(key)
    if hit is None or hit[0] is not recipe:
        hit = _PSPECS[key] = (recipe, build_specs(cfg), recipe_pspecs(recipe, build_specs(cfg)))
    return hit[1], hit[2]


def _gather_whole(t, shape, spec, mesh):
    """``t`` whole: as it is where it has the whole ``shape``, else this
    rank's block of a leaf cut by ``spec``, gathered over its axes.  The
    gathers' backward hands a rank its own block of the gradient, which the
    sp_ring program makes whole on every rank."""
    return t if tuple(t.shape) == tuple(shape) else gather_cut(t, spec, mesh)


def _placed_pspecs(params, cfg, recipe):
    """The per-leaf specs of a ``tp``/``sp`` program, after checking that
    ``params`` are this rank's shards."""
    specs, pspecs = _recipe_pspecs(cfg, recipe)

    def check(t, spec, pspec, name):
        if isinstance(t, dict):
            for k in t:
                check(t[k], spec[k], pspec[k], f"{name}.{k}" if name else k)
            return
        want = local_shape(spec.shape, pspec, recipe.mesh)
        if tuple(t.shape) != want:
            raise ValueError(f"parameter {name!r} has shape {tuple(t.shape)}, this rank's shard "
                             f"is {want}: pass weights.shard_params_by_recipe(params, specs, "
                             "recipe)")

    check(params, specs, pspecs, "")
    return pspecs


def _layer_specs(pspecs):
    """The per-layer specs of stacked ``(L, ...)`` leaves' specs."""
    return tree_map(lambda s: s[1:], pspecs)


def _embed_placed(params, batch, cfg, place, pspecs, positions=None):
    """This rank's rows' embeddings, from its blocks ``batch`` (its rows,
    each over its whole sequence).  The ``embeds`` input kind: its rows
    of the frames plus the sinusoid at ``positions`` ((S,), or whole (B, S)
    per row), as :func:`embed_inputs`.  Tokens: a lookup into the vocab
    block this rank holds, zero elsewhere, summed over ``model`` (one
    nonzero addend: bitwise the plain lookup); the plain lookup where ``v``
    is whole.  Where the stream is cut by sequence (``place.S``) it is this
    rank's chunk: the frames' chunk (zero frames past S) plus the sinusoid
    at the chunk's ``positions``; the lookup's sum reduce-scattered to the
    chunk (its backward all-gathers the cotangent, so each vocab block
    gets every position's gradient), or the whole lookup's chunk."""
    if cfg.input_kind == "embeds":
        if positions is not None and positions.ndim == 2:
            positions = place.local_rows(positions)
        frames = batch["embeds"]
        if place.S is not None:
            frames = place.scatter_seq(frames, split=False)
        return embed_inputs(params, {"embeds": frames}, cfg, positions=positions)
    tokens = batch["tokens"]
    emb = place.use(params["embed"], pspecs["embed"]).to(cfg.act_dtype)
    if emb.shape[0] == cfg.vocab_padded:
        return emb[tokens] if place.S is None else place.scatter_seq(emb[tokens], split=False)
    vl = emb.shape[0]
    loc = tokens - place.mr * vl
    ok = (loc >= 0) & (loc < vl)
    e = torch.where(ok[..., None], emb[loc.clamp(0, vl - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return place.sum_model(e) if place.S is None else place.scatter_seq(e)


def _head_placed(params, x, cfg, place, pspecs):
    """This rank's block of the ``(B, S, vocab_padded)`` logits
    (:func:`repro_torch.models.sharding.logits_spec`) from its rows ``x``:
    its vocab block of the head's columns (full dots) where the recipe cuts
    ``v``, else all of them.  Where ``x`` is this rank's chunk of the
    sequence (``place.S``) the final norm runs on the chunk and the normed
    chunks are gathered along the sequence (for the vocab block, a gather
    whose backward reduce-scatters)."""
    x = blk.rmsnorm(place.for_chunk(place.use(params["final_norm"], pspecs["final_norm"])), x)
    if cfg.tie_embeddings:
        head = place.use(params["embed"], pspecs["embed"]).T
    else:
        head = place.use(params["lm_head"], pspecs["lm_head"])
    whole = head.shape[1] == cfg.vocab_padded
    if place.S is not None:
        return torch.matmul(place.gather_seq(x, split=not whole), head.to(x.dtype))
    if whole:
        return torch.matmul(x, head.to(x.dtype))
    return torch.matmul(place.enter_model(x), head.to(x.dtype))


# the families whose reference carries the residual stream cut by sequence
# under plain ``sp``: the flat stacks of ``attn_block``, and the VLM's
# groups of self blocks and a cross block
_SEQ_CUT_FAMILIES = ("dense", "moe", "audio", "vlm")


def _forward_placed(params, batch, cfg, recipe, positions):
    """The forward on this rank of a ``tp`` or plain ``sp`` recipe's mesh
    (see the module docstring): its rows, each block's weights gathered
    over ``data`` inside the block's checkpoint (:func:`_block`), the
    blocks' work split over ``model``.  Under plain ``sp`` with more than
    one ``model`` rank the dense, MoE, audio and VLM stacks carry the
    residual stream as this rank's ``(n_rows, cap, m)`` chunk of its rows'
    sequence between blocks (:attr:`repro_torch.models.sharding.Placement.S`),
    as the reference's compiled program does: it enters after the
    embedding, goes through every block (the VLM's self and cross blocks
    alike, the cross block's queries the chunk over its rows' whole image)
    and leaves at the head."""
    pspecs = _placed_pspecs(params, cfg, recipe)
    B, S = _global_rows_seq(batch, cfg)
    place = placement(recipe, B)
    if (recipe.attn_mode == "sp" and place.M > 1 and cfg.family in _SEQ_CUT_FAMILIES
            and (positions is None or positions.ndim == 1)):
        place = dataclasses.replace(place, S=S)
        if positions is None:
            positions = torch.arange(S, device=_input_of(batch, cfg).device)
        positions = place.chunk_positions(positions)
    x = _embed_placed(params, batch, cfg, place, pspecs, positions)
    aux = 0.0
    if cfg.family == "hybrid":
        x = _forward_hybrid(params, x, cfg, positions, use=_user(place, pspecs), place=place)
    elif cfg.family == "vlm":
        x = _forward_vlm(params, x, batch["image_embeds"], cfg, positions,
                         use=_user(place, pspecs), place=place)
    else:
        use = _user(place, pspecs)
        block = _block(cfg, lambda p: use(p, "blocks", 1))
        kw = {} if cfg.family == "ssm" else {"positions": positions}
        for p in _layers(params["blocks"]):
            x, _, a = block(p, x, cfg, place=place, **kw)
            aux = aux + a
    return (_head_placed(params, x, cfg, place, pspecs),
            torch.as_tensor(aux, dtype=torch.float32, device=x.device))


# ================================================================== loss ====

def loss_fn(params, batch, cfg):
    """Next-token cross-entropy (+ the MoE aux loss) of ``batch``
    (``tokens``, or ``embeds`` (B, S, m) for the audio family, and
    ``labels`` (B, S), the labels already shifted by the pipeline; the
    VLM's ``image_embeds``; an optional float ``loss_mask``).  Returns ``(loss,
    metrics)``: the loss a float32 scalar with its graph, the metrics
    (``nll``, ``aux``, ``ppl_proxy``) detached float32 scalars.

    Under an active recipe ``batch`` is this rank's blocks
    (:func:`repro_torch.models.sharding.local_batch`: its rows of the labels
    and the mask) and the loss is taken on this rank's block of the logits
    (:func:`forward`), the reference's function on its cut array: where
    the vocab is cut over ``model`` the log-sum-exp and the gold logit are
    vocab-parallel (:func:`_loss_terms`), and the masked sum of the
    rows' nll and their mask count are summed over the batch axes, so every
    rank ends with the same loss.  Those sums are all-reduces whose
    backward is the identity: each rank's backward gives the gradient of
    its own block, once."""
    recipe = current_recipe()
    if recipe is not None:
        batch = rank_batch(recipe, batch, "lm.loss_fn")
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    spec = None if recipe is None else logits_spec(recipe, batch.shapes["labels"][0])
    mesh = recipe.mesh if spec is not None and spec[2] is not None else None
    logz, gold = _loss_terms(logits, labels, mesh)
    mask = torch.ones_like(logz) if mask is None else mask.float()
    total, count = ((logz - gold) * mask).sum(), mask.sum()
    axes = [] if spec is None else [a for a in spec_axes(spec[:1]) if recipe.mesh.shape[a] > 1]
    if axes:
        both = torch.stack([total, count])
        for a in axes:
            both = all_reduce(both, recipe.mesh, a)
        total, count = both[0], both[1]
    nll = total / torch.clamp(count, min=1.0)
    loss = nll + aux
    nll, aux = nll.detach(), aux.detach()
    return loss, {"nll": nll, "aux": aux, "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}


def _loss_terms(logits, labels, mesh=None):
    """``(logz, gold)`` float32 per row and position from the logits block
    ``logits`` (B, S, V) in its own dtype, :class:`_LossTerms` in row
    chunks.  With ``mesh`` the block is this rank's vocab block (the
    ``model`` ranks' blocks in rank order, the padded columns counted as
    the reference counts them) and the terms are vocab-parallel: the rows'
    max all-reduced with ``max`` and detached, then ``sum exp(l - max)``
    and the gold logit (its owning rank's entry, zero on the others) summed
    over ``model`` in one all-reduce whose backward is the identity."""
    vl = logits.shape[-1]
    mx = logits.detach().amax(dim=-1).float()
    local = labels
    if mesh is not None:
        mx = shard_all_reduce_start(mx, "model", mesh=mesh, op="max").wait()
        local = labels - mesh.coords()["model"] * vl
    own = (local >= 0) & (local < vl)
    sums, gold = _LossTerms.apply(logits.reshape(-1, vl), mx.reshape(-1),
                                  local.clamp(0, vl - 1).reshape(-1), own.reshape(-1))
    sums, gold = sums.view(labels.shape), gold.view(labels.shape)
    if mesh is not None:
        parts = all_reduce(torch.stack([sums, gold], dim=-1), mesh, "model")
        sums, gold = parts[..., 0], parts[..., 1]
    return mx + torch.log(sums), gold


class _LossTerms(torch.autograd.Function):
    """``(sum exp(l - mx), l[local])`` float32 for each row of a logits block
    ``(N, V)`` in its own dtype, given each row's detached max ``mx``, its
    label's column ``local`` in the block and whether the block owns it
    (``own``; the gold logit of a row it does not own is 0).  It upcasts
    ``blocks.UPCAST_CHUNK // V`` rows at a time and saves the block in its own
    dtype; the backward rebuilds each chunk's ``exp(l - mx)`` from it and
    writes the cotangent straight into one tensor of the block's dtype, so
    no float32 storage the size of the block exists."""

    @staticmethod
    def forward(ctx, logits, mx, local, own):
        ctx.save_for_backward(logits, mx, local, own)
        sums = torch.empty_like(mx)
        gold = torch.empty_like(mx)
        for r in blk.row_chunks(*logits.shape):
            lf = logits[r].to(torch.float32, copy=True)
            gold[r] = torch.gather(lf, -1, local[r, None])[:, 0]
            sums[r] = lf.sub_(mx[r, None]).exp_().sum(dim=-1)
        return sums, torch.where(own, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))

    @staticmethod
    def backward(ctx, d_sums, d_gold):
        logits, mx, local, own = ctx.saved_tensors
        d_gold = torch.where(own, d_gold, torch.zeros((), dtype=d_gold.dtype,
                                                      device=d_gold.device))
        grad = torch.empty_like(logits)
        for r in blk.row_chunks(*logits.shape):
            d = logits[r].to(torch.float32, copy=True).sub_(mx[r, None]).exp_()
            grad[r] = d.mul_(d_sums[r, None]).scatter_add_(-1, local[r, None], d_gold[r, None])
        return grad, None, None, None


def _loss_terms_plain(logits, labels, mesh=None):
    """The plain version of :func:`_loss_terms`: the composite on a float32
    copy of the whole block, its graph saving that copy (the tests' oracle;
    the training path takes :func:`_loss_terms`)."""
    logits = logits.float()
    if mesh is None:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    vl = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    mx = shard_all_reduce_start(mx, "model", mesh=mesh, op="max").wait()
    local = labels - mesh.coords()["model"] * vl
    own = (local >= 0) & (local < vl)
    gold = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    gold = torch.where(own, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    parts = torch.stack([torch.exp(logits - mx[..., None]).sum(dim=-1), gold], dim=-1)
    parts = all_reduce(parts, mesh, "model")
    return mx + torch.log(parts[..., 0]), parts[..., 1]


def gather_logits(logits, recipe, B: int):
    """The whole ``(B, S, vocab_padded)`` logits from this rank's block
    ``logits`` of a ``B``-row batch under ``recipe`` (what :func:`forward`
    and :func:`decode_step` return under it; ``logits`` may be any slice of
    the block's positions): gathered over the vocab's and the rows' axes of
    :func:`repro_torch.models.sharding.logits_spec`, the same on every
    rank.  ``logits`` as it is without a recipe.  For a caller that needs
    the whole tensor; nothing on the training or serving path calls it on
    the whole ``(B, S, V)``."""
    if recipe is None:
        return logits
    return gather_cut(logits, logits_spec(recipe, B), recipe.mesh)


def last_logits(logits, counts, recipe=None):
    """``(B, vocab_padded)``: each row's logits at its last valid position,
    ``counts[b] - 1`` (position 0 of an idle row, ``counts[b] == 0``), from
    a step's logits and its whole ``counts`` (B,).  Under ``recipe``
    ``logits`` is this rank's block: its rows' ``(B_local, 1, V / M)``
    slice is gathered over ``model`` and the batch axes, the only whole
    logits serving holds."""
    B = counts.shape[0]
    if recipe is not None:
        _, row0, n_rows = batch_rows(recipe, B)
        counts = counts.narrow(0, row0, n_rows)
    pos = (counts.long() - 1).clamp(min=0).to(logits.device)
    rows = torch.arange(pos.shape[0], device=logits.device)
    return gather_logits(logits[rows, pos][:, None], recipe, B)[:, 0]


# ================================================================ caching ====

class DecodeState(NamedTuple):
    # KVCache: k/v (L, B, G, T, D); MLACache: c (L, B, T, kv_rank), kr (L, B, T, d_rope);
    # both with length (L, B); RWKVBlockState (ssm), the hybrid's and the VLM's dicts:
    # see init_cache
    caches: Any
    positions: torch.Tensor  # (B,) int32 next position


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda"):
    """Stacked per-layer cache in act_dtype, zero lengths: K/V, or for the
    MLA family the latent and rope-key caches.  The SSM family's is an
    :class:`blocks.RWKVBlockState` of (L, B, ...) states (the wkv state
    float32); the hybrid's a dict of the Mamba2 states, ``"mamba"``
    (n_shared, group_m, B, ...) and ``"tail"`` (n_tail, B, ...) (the ssm
    state float32), and the shared block's ``"shared"`` :class:`KVCache`
    (n_shared, B, n_kv, min(max_len, shared_window), head_dim), a ring
    buffer once a row's length passes its size.  The VLM's is ``{"self":
    KVCache}`` of its self blocks' K/V (n_cross, group_self, B, n_kv,
    max_len, head_dim), lengths (n_cross, group_self, B); its cross blocks
    keep none.

    Under an active recipe every leaf is this rank's block, cut by
    :func:`repro_torch.models.sharding.decode_state_shardings`: the K/V by
    heads over ``model`` where the KV groups divide it, else by sequence
    (whose length must then divide ``model``), the MLA family's latent
    caches by sequence (the same), the recurrent states by
    heads (else RWKV's value columns, Mamba2's head dim), rows over the
    batch axes where they divide ``batch_size``; the shifts and conv
    windows are whole over ``model``, and the lengths whole; the VLM's self
    blocks' K/V as the dense family's."""
    recipe = current_recipe()
    device = resolve_device(device)
    if recipe is not None:
        return _init_cache_placed(cfg, batch_size, max_len, device, recipe)
    return _init_cache_whole(cfg, batch_size, max_len, device)


def _init_cache_whole(cfg, B: int, max_len: int, device: torch.device):
    """:func:`init_cache`'s whole state on ``device`` (the ``meta`` device
    gives the shapes alone)."""
    L, dt = cfg.n_layers, cfg.act_dtype
    if cfg.family == "ssm":
        H = cfg.n_heads
        hd = cfg.d_model // H
        return blk.RWKVBlockState(
            time=ssm_mod.RWKVState(
                wkv=torch.zeros((L, B, H, hd, hd), dtype=torch.float32, device=device),
                shift=torch.zeros((L, B, cfg.d_model), dtype=dt, device=device)),
            cm_shift=torch.zeros((L, B, cfg.d_model), dtype=dt, device=device))
    if cfg.family == "hybrid":
        n_shared, group_m, n_tail = hybrid_dims(cfg)
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        conv_ch = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state

        def mstate(*lead):
            return ssm_mod.MambaState(
                ssm=torch.zeros((*lead, B, H, cfg.ssm_head_dim, cfg.ssm_state),
                                dtype=torch.float32, device=device),
                conv=torch.zeros((*lead, B, 3, conv_ch), dtype=dt, device=device))

        shape = (n_shared, B, cfg.n_kv, min(max_len, cfg.shared_window), cfg.head_dim)
        out = {"mamba": mstate(n_shared, group_m),
               "shared": attn_mod.KVCache(
                   k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   length=torch.zeros((n_shared, B), dtype=torch.int32, device=device))}
        if n_tail:
            out["tail"] = mstate(n_tail)
        return out
    if cfg.family == "vlm":
        lead = vlm_dims(cfg)
        shape = (*lead, B, cfg.n_kv, max_len, cfg.head_dim)
        return {"self": attn_mod.KVCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            length=torch.zeros((*lead, B), dtype=torch.int32, device=device))}
    length = torch.zeros((L, B), dtype=torch.int32, device=device)
    if cfg.family == "mla":
        return attn_mod.MLACache(
            c=torch.zeros((L, B, max_len, cfg.mla_kv_rank), dtype=dt, device=device),
            kr=torch.zeros((L, B, max_len, cfg.mla_d_rope), dtype=dt, device=device),
            length=length,
        )
    shape = (L, B, cfg.n_kv, max_len, cfg.head_dim)
    return attn_mod.KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                            v=torch.zeros(shape, dtype=dt, device=device), length=length)


def _init_cache_placed(cfg, B: int, max_len: int, device, recipe):
    """This rank's blocks of :func:`init_cache`'s state, each leaf zeros of
    its local shape under :func:`repro_torch.models.sharding.decode_state_shardings`."""
    M = recipe.mesh.shape.get("model", 1)
    T = min(max_len, cfg.shared_window) if cfg.family == "hybrid" else max_len
    if cfg.family != "ssm" and _seq_cut_cache(recipe, cfg) and T % M:
        raise ValueError(f"the caches' {T} positions must divide the model axis ({M}): the "
                         "recipe cuts them along their sequence")
    whole = _init_cache_whole(cfg, B, max_len, torch.device("meta"))
    specs = decode_state_shardings(recipe, whole)

    def mine(t, spec):
        if isinstance(t, dict):
            return {k: mine(t[k], spec[k]) for k in t}
        if isinstance(t, tuple):
            return type(t)(*(mine(a, b) for a, b in zip(t, spec)))
        return torch.zeros(local_shape(t.shape, spec, recipe.mesh), dtype=t.dtype, device=device)

    return mine(whole, specs)


def decode_step(params, state: DecodeState, batch, cfg, *, new_counts=None,
                prefill: bool = False):
    """One serve step: embed the new token(s) ``batch['tokens']`` (B, S), or
    the audio family's frames ``batch['embeds']`` (B, S, m) at each row's
    positions, run every block against the caches and return ``(logits,
    new DecodeState)``.  The VLM family reads ``batch['image_embeds']``
    (B, enc_len, enc_dim) every step; its cross blocks keep no cache.

    Every row runs at its own position (``state.positions[b]``) for RoPE and
    the causal mask.  ``new_counts`` (B,) int32 says how many of the chunk's
    S tokens are valid per row: rows with 0 are idle this step, keep their
    K/V (or recurrent state) and length, and do not advance; their logits
    are the reference's (see :func:`repro_torch.models.attention.gqa_attention`),
    except the hybrid family's, whose reference shared block attends
    with every row's length advanced and restores the idle rows after.
    The caches and states are updated **in place** (the state's tensors are
    the new state's); the lengths are new tensors.  ``prefill`` marks a
    whole-prompt chunk.  The MLA family runs the absorbed form against its
    latent caches (:func:`repro_torch.models.attention.mla_attention`); the
    SSM and hybrid families' recurrent states take the exact recurrence for
    S <= 4 and the chunked form (S a multiple of ``cfg.ssm_chunk``)
    otherwise, for every row, as the reference's.

    Under an active recipe ``params`` are this rank's shards and ``state``
    holds this rank's blocks of the caches and states
    (:func:`init_cache` under the recipe), with the lengths and positions
    whole; ``batch`` is this rank's rows of every leaf, each over its whole
    sequence (``sharding.local_batch(recipe, batch, decode=True)``),
    ``new_counts`` is whole, and the returned logits
    are this rank's block, cut as :func:`forward`'s (:func:`_decode_placed`;
    :func:`last_logits` gathers the positions a sampler reads)."""
    recipe = current_recipe()
    if recipe is not None:
        batch = rank_batch(recipe, batch, "lm.decode_step", decode=True)
        return _decode_placed(params, state, batch, cfg, recipe, new_counts, prefill)
    positions = state.positions
    S = _input_of(batch, cfg).shape[1]
    pos2d = positions[:, None] + torch.arange(S, dtype=positions.dtype,
                                              device=positions.device)[None, :]
    adv = S if new_counts is None else new_counts
    x = embed_inputs(params, batch, cfg, positions=pos2d)
    caches = state.caches
    if cfg.family == "vlm":
        x, new_caches = _decode_vlm(params, caches, x, batch["image_embeds"], cfg, pos2d,
                                    new_counts, prefill)
        return lm_logits(params, x, cfg), DecodeState(
            caches=new_caches, positions=(positions + adv).to(positions.dtype))
    if cfg.family in ("ssm", "hybrid"):
        active = None if new_counts is None else new_counts > 0
        if cfg.family == "ssm":
            x, new_caches = _decode_ssm(params, caches, x, cfg, active)
        else:
            x, new_caches = _decode_hybrid(params, caches, x, cfg, pos2d, new_counts, active)
        return lm_logits(params, x, cfg), DecodeState(
            caches=new_caches, positions=(positions + adv).to(positions.dtype))
    T = caches[0].shape[-2]  # k (L, B, G, T, D) or c (L, B, T, kv_rank)
    # every layer's lengths are the same: ask once per step, not per layer
    idle_read = None if new_counts is None else attn_mod.idle_rows_read_chunk(
        caches.length[0], new_counts, T, S)
    block = _block(cfg)
    lengths = []
    for i in range(cfg.n_layers):
        c = type(caches)(*(t[i] for t in caches))
        x, new_c, _ = block(_layer(params["blocks"], i), x, cfg, cache=c, positions=pos2d,
                            new_counts=new_counts, prefill=prefill, idle_read_chunk=idle_read)
        lengths.append(new_c.length)
    new_caches = caches._replace(length=torch.stack(lengths))
    logits = lm_logits(params, x, cfg)
    return logits, DecodeState(caches=new_caches, positions=(positions + adv).to(positions.dtype))


def _decode_vlm(params, caches, x, enc, cfg, pos2d, new_counts, prefill, *, place=None,
                pspecs=None):
    """The VLM stack's decode step: each group's self blocks against their
    K/V (updated in place, idle rows kept), then the group's cross block
    over ``enc``, which reads no cache.  Under ``place`` the K/V are this
    rank's blocks and ``x``, ``enc`` its rows, while ``pos2d``,
    ``new_counts`` and the lengths are whole; the cross blocks split their
    heads where the recipe cuts them, else run whole on every rank."""
    n_cross, group_self = vlm_dims(cfg)
    use = _user(place, pspecs)
    kv = caches["self"]
    T = kv.k.shape[-2] * (place.M if place is not None and _seq_cut_cache(place.recipe) else 1)
    # every block's lengths are the same: ask once per step
    idle_read = None if new_counts is None else attn_mod.idle_rows_read_chunk(
        kv.length[0, 0], new_counts, T, x.shape[1])
    block = _block(cfg)
    lengths = []
    for i in range(n_cross):
        p_self = _layer(params["self_blocks"], i)
        for j in range(group_self):
            c = attn_mod.KVCache(kv.k[i, j], kv.v[i, j], kv.length[i, j])
            x, new_c, _ = block(use(_layer(p_self, j), "self_blocks", 2), x, cfg, cache=c,
                                positions=pos2d, new_counts=new_counts, prefill=prefill,
                                idle_read_chunk=idle_read, place=place)
            lengths.append(new_c.length)
        x = blk.cross_block(use(_layer(params["cross_blocks"], i), "cross_blocks", 1), x, enc,
                            cfg, place=place)
    return x, {"self": kv._replace(length=torch.stack(lengths).reshape(kv.length.shape))}


def _decode_placed(params, state, batch, cfg, recipe, new_counts, prefill):
    """:func:`decode_step` on this rank of a recipe's mesh: its rows, its
    blocks of the caches, each block's weights gathered over ``data`` for
    the block (:func:`repro_torch.models.attention.gqa_attention_placed`);
    a whole-prompt ``prefill`` chunk under ``sp_ring`` runs the ring."""
    pspecs = _placed_pspecs(params, cfg, recipe)
    B, S = _global_rows_seq(batch, cfg)
    place = placement(recipe, B)
    positions = state.positions
    pos2d = positions[:, None] + torch.arange(S, dtype=positions.dtype,
                                              device=positions.device)[None, :]
    adv = S if new_counts is None else new_counts
    x = _embed_placed(params, batch, cfg, place, pspecs, pos2d)
    caches = state.caches
    if cfg.family == "vlm":
        x, new_caches = _decode_vlm(params, caches, x, batch["image_embeds"], cfg, pos2d,
                                    new_counts, prefill, place=place, pspecs=pspecs)
        return _head_placed(params, x, cfg, place, pspecs), DecodeState(
            caches=new_caches, positions=(positions + adv).to(positions.dtype))
    if cfg.family in ("ssm", "hybrid"):
        active = None if new_counts is None else place.local_rows(new_counts) > 0
        if cfg.family == "ssm":
            x, new_caches = _decode_ssm(params, caches, x, cfg, active, place=place, pspecs=pspecs)
        else:
            x, new_caches = _decode_hybrid(params, caches, x, cfg, pos2d, new_counts, active,
                                           place=place, pspecs=pspecs)
        return _head_placed(params, x, cfg, place, pspecs), DecodeState(
            caches=new_caches, positions=(positions + adv).to(positions.dtype))
    T = caches[0].shape[-2] * (place.M if _seq_cut_cache(recipe, cfg) else 1)
    idle_read = None if new_counts is None else attn_mod.idle_rows_read_chunk(
        caches.length[0], new_counts, T, S)
    layer_specs = _layer_specs(pspecs["blocks"])
    block = _block(cfg)
    lengths = []
    for i in range(cfg.n_layers):
        p = place.use_tree(_layer(params["blocks"], i), layer_specs)
        c = type(caches)(*(t[i] for t in caches))
        x, new_c, _ = block(p, x, cfg, cache=c, positions=pos2d, new_counts=new_counts,
                            prefill=prefill, idle_read_chunk=idle_read, place=place)
        lengths.append(new_c.length)
    logits = _head_placed(params, x, cfg, place, pspecs)
    return logits, DecodeState(caches=caches._replace(length=torch.stack(lengths)),
                               positions=(positions + adv).to(positions.dtype))


def _seq_cut_cache(recipe, cfg=None) -> bool:
    """Whether the recipe cuts the caches along their sequence: the K/V
    where the KV groups do not divide ``model``, the MLA family's latent
    caches always."""
    kind, dim = ("cache_mla", 1) if cfg is not None and cfg.family == "mla" else ("cache_kv", 2)
    return recipe.mesh.shape.get("model", 1) > 1 and recipe.spec(kind)[dim] == "model"


def _state_at(state, idx):
    """The layer ``idx`` views of a (nested) named tuple of stacked states."""
    return type(state)(*(_state_at(t, idx) if isinstance(t, tuple) else t[idx] for t in state))


def _state_leaves(state) -> list:
    return [leaf for t in state
            for leaf in (_state_leaves(t) if isinstance(t, tuple) else [t])]


def _store_state(dst, new, active) -> None:
    """Writes the layer state ``new`` into ``dst`` (views of the stacked
    state), in place, rows with ``active[b] == False`` kept as they were
    (the reference's ``_mask_rows``)."""
    for d, n in zip(_state_leaves(dst), _state_leaves(new)):
        if active is not None:
            n = torch.where(active.reshape((-1,) + (1,) * (n.ndim - 1)), n.to(d.dtype), d)
        d.copy_(n)


def _user(place, pspecs, *, shard=None, specs=None):
    """``use(tree, name, depth)``: layer weights of ``params[name]`` (a
    ``depth``-times stacked tree, as this rank holds them) ready for this
    rank's work: under ``place`` (``tp``/``sp``) gathered over ``data``
    (:meth:`repro_torch.models.sharding.Placement.use`); under ``shard``
    (``sp_ring``) gathered whole (``specs`` give the whole shapes) and used
    by this rank's chunk (:meth:`repro_torch.models.sharding.TokenShard.partial`);
    as they are with neither."""
    def use(tree, name, depth):
        if place is None and shard is None:
            return tree
        ps = pspecs[name]
        for _ in range(depth):
            ps = _layer_specs(ps)
        if place is not None:
            return place.use_tree(tree, ps)
        return _use_whole(tree, specs[name], ps, depth, shard)

    return use


def _use_whole(tree, spec, pspec, depth: int, shard):
    """:func:`_user`'s ``sp_ring`` form: each leaf gathered whole, then
    :meth:`TokenShard.partial`."""
    if isinstance(tree, dict):
        return {k: _use_whole(v, spec[k], pspec[k], depth, shard) for k, v in tree.items()}
    return shard.partial(_gather_whole(tree, spec.shape[depth:], pspec, shard.mesh))


def _decode_ssm(params, caches, x, cfg, active, *, place=None, pspecs=None):
    """The SSM stack's decode step; under ``place`` the states are this
    rank's blocks and ``x`` its rows."""
    use = _user(place, pspecs)
    for i in range(cfg.n_layers):
        c = _state_at(caches, i)
        x, new_c, _ = blk.rwkv_block(use(_layer(params["blocks"], i), "blocks", 1), x, cfg,
                                     state=c, place=place)
        _store_state(c, new_c, active)
    return x, caches


def _decode_hybrid(params, caches, x, cfg, pos2d, new_counts, active, *, place=None,
                   pspecs=None):
    """The hybrid stack's decode step; under ``place`` the states and the
    shared block's K/V are this rank's blocks and ``x`` its rows, while
    ``pos2d``, ``new_counts`` and the lengths are whole."""
    n_shared, group_m, n_tail = hybrid_dims(cfg)
    use = _user(place, pspecs)
    shared = caches["shared"]
    S = x.shape[1]
    T = shared.k.shape[-2] * (place.M if place is not None and _seq_cut_cache(place.recipe)
                              else 1)
    # every application's lengths are the same: ask once per step
    idle_read = None if new_counts is None else attn_mod.idle_rows_read_chunk(
        shared.length[0], new_counts, T, S)

    def mamba(p, c, x):
        x, new_c, _ = blk.mamba_block(p, x, cfg, state=c, place=place)
        _store_state(c, new_c, active)
        return x

    p_shared = use(params["shared_block"], "shared_block", 0)
    lengths = []
    for i in range(n_shared):
        p_group = _layer(params["mamba_blocks"], i)
        for j in range(group_m):
            x = mamba(use(_layer(p_group, j), "mamba_blocks", 2),
                      _state_at(caches["mamba"], (i, j)), x)
        x, new_c, _ = blk.shared_attn_block(
            p_shared, use(_layer(params["shared_lora"], i), "shared_lora", 1), x, cfg,
            cache=attn_mod.KVCache(shared.k[i], shared.v[i], shared.length[i]),
            positions=pos2d, window=cfg.shared_window, new_counts=new_counts,
            idle_read_chunk=idle_read, place=place)
        lengths.append(new_c.length)
    for i in range(n_tail):
        x = mamba(use(_layer(params["tail_blocks"], i), "tail_blocks", 1),
                  _state_at(caches["tail"], i), x)
    return x, {**caches, "shared": shared._replace(length=torch.stack(lengths))}


# =============================================================== helpers ====

def init_model(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Seeded random float32 parameters on ``device`` (``generator`` on the
    same device)."""
    return init_params(build_specs(cfg), generator, resolve_device(device))


def abstract_model(cfg, *, recipe=None, device="cuda") -> dict:
    """Uninitialized parameters in this rank's shapes (the reference's
    ``abstract_model``): each leaf an empty tensor of its whole shape, or
    under ``recipe`` of this rank's shard (the shape
    ``weights.shard_params_by_recipe`` cuts, from
    :meth:`repro_torch.models.sharding.Recipe.param_pspecs`; nothing whole
    is made and sliced).  Under the caller's ``FakeTensorMode`` nothing is
    allocated: the dry run's parameters, whose bytes are this rank's
    shards' alone."""
    dev = resolve_device(device)
    specs = build_specs(cfg)
    pspecs = None if recipe is None else recipe_pspecs(recipe, specs)

    def leaf(spec, pspec):
        if isinstance(spec, dict):
            return {k: leaf(spec[k], None if pspec is None else pspec[k]) for k in sorted(spec)}
        shape = spec.shape if pspec is None else local_shape(spec.shape, pspec, recipe.mesh)
        return torch.empty(shape, dtype=spec.dtype, device=dev)

    return leaf(specs, pspecs)

