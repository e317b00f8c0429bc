"""Decoder blocks: the dense, MoE and audio LMs' pre-norm GQA attention +
FFN (SwiGLU, the GELU MLP, or the top-k MoE); the MLA family's pre-norm
multi-head latent attention + SwiGLU; the VLM's gated cross-attention
block (Llama-3.2-Vision style); the SSM family's RWKV6 block (time mix,
then a token-shifted squared-ReLU channel mix); and the hybrid family's
Mamba2 block and its shared attention block (zamba2).  Every block takes
``place`` (its part of a ``tp``/``sp`` recipe's program), and every block
but the cross-attention block ``shard`` (its chunk of the sequence under
``sp_ring``); the cross-attention block runs a chunk as it runs any rows,
over the whole image of the chunk's rows.

The reference scans stacked layer parameters with ``lax.scan``; the port
keeps the stacked ``(L, ...)`` layout and loops over the layer index
(``repro_torch.models.lm``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import attention as attn
from . import ffn as ffn_mod
from . import ssm as ssm_mod
from .module import pspec
from .sharding import partial_product

__all__ = ["norm_spec", "rmsnorm", "attn_block_specs", "attn_block", "mla_block_specs",
           "mla_block", "cross_block_specs", "cross_block", "rwkv_block_specs", "RWKVBlockState",
           "rwkv_block", "mamba_block_specs",
           "mamba_block", "shared_attn_block_specs", "shared_lora_specs", "shared_attn_block"]


def norm_spec(d: int, dtype=torch.float32):
    return pspec(("m", d), dtype=dtype, init="ones")


# float32 elements that a training Function upcasts at a time (256 MiB):
# the loss's logits block (lm._LossTerms) and RMSNorm's backward go by whole
# rows, this many elements' worth of them at a time
UPCAST_CHUNK = 1 << 26


def row_chunks(n: int, width: int) -> list[slice]:
    """Slices of ``n`` rows of ``width`` columns, UPCAST_CHUNK elements'
    worth each (at least one row), the last ragged."""
    rows = max(1, UPCAST_CHUNK // width)
    return [slice(r, min(r + rows, n)) for r in range(0, n, rows)]


def rmsnorm(w, x, eps: float = 1e-5):
    """Normalized in float32, cast to x's dtype, then times the weight in
    x's dtype (the reference's order).  Its graph keeps ``x`` in its own
    dtype and the float32 ``(..., 1)`` reciprocal root (:class:`_RMSNorm`),
    no float32 copy of ``x``."""
    return _RMSNorm.apply(x, w, eps)


class _RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm`: the forward is the composite ``xf = x.float()``,
    ``r = rsqrt(mean(xf^2) + eps)``, ``(xf * r).to(x.dtype) * w.to(x.dtype)``;
    the backward recomputes ``xf`` and the normalized ``x`` by row chunks
    (:func:`row_chunks`) and writes out the composite's gradient op by op,
    so both are the composite's bitwise."""

    @staticmethod
    def forward(ctx, x, w, eps):
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, r)
        return (xf * r).to(x.dtype) * w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, r = ctx.saved_tensors
        wd, m = w.to(x.dtype), x.shape[-1]
        x2, g2, r2 = x.reshape(-1, m), g.reshape(-1, m), r.reshape(-1, 1)
        dx = torch.empty_like(x2) if ctx.needs_input_grad[0] else None
        gn = torch.empty_like(x2) if ctx.needs_input_grad[1] else None
        for rows in row_chunks(x2.shape[0], m):  # every op but wd's sum is by rows
            xf, gr, rr = x2[rows].to(torch.float32, copy=True), g2[rows], r2[rows]
            if gn is not None:  # out = n * wd: wd's share
                gn[rows] = gr * (xf * rr).to(x.dtype)
            if dx is not None:
                dn = (gr * wd).float()
                dr = (dn * xf).sum(dim=-1, keepdim=True)  # n = xf * r, r's share
                dv = -0.5 * dr * rr.pow(3)  # rsqrt
                # mean then square: dv / m at every column, times 2 xf; plus
                # xf's share of xf * r
                dx[rows] = dn.mul_(rr).add_(xf.mul_(2.0).mul_(dv / m))
        dw = None if gn is None else gn.sum(dim=0).to(w.dtype)  # summed to wd's shape
        return None if dx is None else dx.view(x.shape), dw, None


def attn_block_specs(cfg) -> dict:
    dt = cfg.param_dtype
    s = {
        "ln1": norm_spec(cfg.d_model, dt),
        "ln2": norm_spec(cfg.d_model, dt),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                               qkv_bias=cfg.qkv_bias, dtype=dt),
    }
    if cfg.ffn_kind == "moe":
        s["ffn"] = ffn_mod.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                     dense_residual=cfg.moe_dense_residual, dtype=dt)
    elif cfg.ffn_kind == "gelu":
        s["ffn"] = ffn_mod.gelu_mlp_specs(cfg.d_model, cfg.d_ff, dt)
    else:
        s["ffn"] = ffn_mod.swiglu_specs(cfg.d_model, cfg.d_ff, dt)
    return s


def attn_block(p, x, cfg, *, cache=None, positions=None, new_counts=None, prefill=False,
               idle_read_chunk=None, shard=None, place=None):
    """Pre-norm attention + FFN.  Returns ``(x, new_cache, aux_loss)``; the
    cache, if given, is updated in place, and the aux loss is the MoE's
    (the float 0.0 for the other FFNs: no kernel for a dense layer).  Under
    an ``sp_ring`` recipe ``x`` is this rank's block of the token grid that
    ``shard`` (a :class:`repro_torch.models.sharding.TokenShard`) describes
    (see :func:`repro_torch.models.attention.gqa_attention` and
    :func:`repro_torch.models.ffn.moe_ffn`); under a ``tp``/``sp`` recipe
    ``x`` is this rank's rows and ``place`` (a
    :class:`repro_torch.models.sharding.Placement`) its part of the
    recipe's program (:func:`repro_torch.models.attention.gqa_attention_placed`,
    :func:`repro_torch.models.ffn.ffn_placed`, the MoE's
    :func:`repro_torch.models.ffn.moe_placed`); where ``place.S`` is set,
    ``x`` is this rank's chunk of its rows' sequence, and the residual
    adds and both norms run on the chunk."""
    if place is not None:
        ln1, ln2 = place.for_chunk(p["ln1"]), place.for_chunk(p["ln2"])
        h, new_cache = attn.gqa_attention_placed(
            p["attn"], rmsnorm(ln1, x), place=place,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, positions=positions, cache=cache,
            attn_impl=cfg.attn_impl, block=cfg.attn_block, new_counts=new_counts,
            prefill=prefill, idle_read_chunk=idle_read_chunk)
        x = x + h
        if cfg.ffn_kind == "moe":
            f, aux = ffn_mod.moe_placed(
                p["ffn"], rmsnorm(ln2, x), place=place, n_experts=cfg.n_experts,
                d_ff=cfg.d_ff, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                groups=cfg.moe_groups, dispatch=cfg.moe_dispatch)
            return x + f, new_cache, aux
        f = ffn_mod.ffn_placed(p["ffn"], rmsnorm(ln2, x), kind=cfg.ffn_kind,
                               d_ff=cfg.d_ff, place=place)
        return x + f, new_cache, 0.0
    h, new_cache = attn.gqa_attention(
        p["attn"], rmsnorm(p["ln1"], x),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, positions=positions, cache=cache,
        attn_impl=cfg.attn_impl, block=cfg.attn_block,
        new_counts=new_counts, prefill=prefill, idle_read_chunk=idle_read_chunk,
        seq_len=None if shard is None else shard.S,
    )
    x = x + h
    aux = 0.0
    if cfg.ffn_kind == "moe":
        f, aux = ffn_mod.moe_ffn(p["ffn"], rmsnorm(p["ln2"], x), n_experts=cfg.n_experts,
                                 top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                                 groups=cfg.moe_groups, dispatch=cfg.moe_dispatch, shard=shard)
    elif cfg.ffn_kind == "gelu":
        f = ffn_mod.gelu_mlp(p["ffn"], rmsnorm(p["ln2"], x))
    else:
        f = ffn_mod.swiglu(p["ffn"], rmsnorm(p["ln2"], x))
    return x + f, new_cache, aux


def mla_block_specs(cfg) -> dict:
    dt = cfg.param_dtype
    return {
        "ln1": norm_spec(cfg.d_model, dt),
        "ln2": norm_spec(cfg.d_model, dt),
        "attn": attn.mla_specs(cfg.d_model, cfg.n_heads, q_rank=cfg.mla_q_rank,
                               kv_rank=cfg.mla_kv_rank, d_nope=cfg.mla_d_nope,
                               d_rope=cfg.mla_d_rope, d_v=cfg.mla_d_v, dtype=dt),
        "ffn": ffn_mod.swiglu_specs(cfg.d_model, cfg.d_ff, dt),
    }


def mla_block(p, x, cfg, *, cache=None, positions=None, new_counts=None, prefill=False,
              idle_read_chunk=None, place=None, shard=None):
    """Pre-norm MLA + SwiGLU.  Returns ``(x, new_cache, aux_loss)``, the aux
    loss the float 0.0; the latent caches, if given, are updated in place
    (:func:`repro_torch.models.attention.mla_attention`).  ``place`` and
    ``shard`` as for :func:`attn_block`
    (:func:`repro_torch.models.attention.mla_attention_placed`)."""
    kw = dict(n_heads=cfg.n_heads, d_nope=cfg.mla_d_nope, d_rope=cfg.mla_d_rope,
              d_v=cfg.mla_d_v, rope_theta=cfg.rope_theta, positions=positions, cache=cache,
              attn_impl=cfg.attn_impl, block=cfg.attn_block, new_counts=new_counts,
              prefill=prefill, idle_read_chunk=idle_read_chunk)
    xn = rmsnorm(p["ln1"], x)
    if place is not None or shard is not None:
        h, new_cache = attn.mla_attention_placed(p["attn"], xn, place=place, shard=shard, **kw)
    else:
        h, new_cache = attn.mla_attention(p["attn"], xn, **kw)
    x = x + h
    if place is not None:
        f = ffn_mod.ffn_placed(p["ffn"], rmsnorm(p["ln2"], x), kind="swiglu", d_ff=cfg.d_ff,
                               place=place)
    else:
        f = ffn_mod.swiglu(p["ffn"], rmsnorm(p["ln2"], x))
    return x + f, new_cache, 0.0


# ------------------------------------------------------------ cross block ----

def cross_block_specs(cfg) -> dict:
    dt = cfg.param_dtype
    return {
        "ln1": norm_spec(cfg.d_model, dt),
        "ln2": norm_spec(cfg.d_model, dt),
        "attn": attn.cross_attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                      cfg.enc_dim, dt),
        "ffn": ffn_mod.swiglu_specs(cfg.d_model, cfg.d_ff, dt),
        "gate_attn": pspec(("z", 1), dtype=dt, init="zeros"),
        "gate_ffn": pspec(("z", 1), dtype=dt, init="zeros"),
    }


def cross_block(p, x, enc, cfg, *, place=None):
    """The gated cross-attention block (Llama-3.2-Vision style): ``x +
    tanh(gate_attn) * cross_attention(...)``, then ``x + tanh(gate_ffn) *
    swiglu(...)``, each gate's tanh in x's dtype.  ``enc`` (B, enc_len,
    enc_dim) are the image's states; the block keeps no cache.  Under a
    ``tp``/``sp`` recipe ``x`` and ``enc`` are this rank's rows and
    ``place`` its part of the program: the attention by heads, or by the
    rank's chunk of the queries, through
    :func:`repro_torch.models.attention.cross_attention_placed`, and the
    SwiGLU's ``f`` columns (:func:`repro_torch.models.ffn.ffn_placed`).
    Where ``place.S`` is set, ``x`` is this rank's chunk of its rows'
    sequence: both norms, both gates and the residual adds run on the
    chunk, and the four whole weights, used by the chunk alone, sum their
    gradients over ``model`` (:meth:`Placement.for_chunk`); else the gates
    act on the whole sums."""
    if place is not None:
        p = {**p, **{k: place.for_chunk(p[k]) for k in ("ln1", "ln2", "gate_attn", "gate_ffn")}}
    xn = rmsnorm(p["ln1"], x)
    if place is not None:
        h = attn.cross_attention_placed(p["attn"], xn, enc, place=place, n_heads=cfg.n_heads,
                                        n_kv=cfg.n_kv, attn_impl=cfg.attn_impl,
                                        block=cfg.attn_block)
    else:
        h = attn.cross_attention(p["attn"], xn, enc, attn_impl=cfg.attn_impl,
                                 block=cfg.attn_block)
    x = x + torch.tanh(p["gate_attn"].to(x.dtype)) * h
    xn = rmsnorm(p["ln2"], x)
    if place is not None:
        f = ffn_mod.ffn_placed(p["ffn"], xn, kind="swiglu", d_ff=cfg.d_ff, place=place)
    else:
        f = ffn_mod.swiglu(p["ffn"], xn)
    return x + torch.tanh(p["gate_ffn"].to(x.dtype)) * f


# ------------------------------------------------------------- RWKV block ----

def rwkv_block_specs(cfg) -> dict:
    dt = cfg.param_dtype
    d = cfg.d_model
    return {
        "ln1": norm_spec(d, dt),
        "ln2": norm_spec(d, dt),
        "time_mix": ssm_mod.rwkv6_specs(d, cfg.n_heads, dtype=dt),
        # channel mix (token-shifted squared-relu FFN, Finch style)
        "cm_mix": pspec(("p", 2), ("m", d), dtype=dt, init="zeros"),
        "cm_k": pspec(("m", d), ("f", cfg.d_ff), dtype=dt, fan_in=("m",)),
        "cm_v": pspec(("f", cfg.d_ff), ("m", d), dtype=dt, fan_in=("f",)),
        "cm_r": pspec(("m", d), ("m2", d), dtype=dt, fan_in=("m",)),
    }


class RWKVBlockState(NamedTuple):
    time: ssm_mod.RWKVState
    cm_shift: torch.Tensor  # (B, m)


def _whole_sequence(block, p, x, cfg, shard, **kw):
    """``block`` under an ``sp_ring`` recipe: this rank's chunk ``x`` of
    the sequence gathered over ``model``, the block run over the whole
    sequence of the rank's rows (its scans and token shifts read across
    the chunks), and this rank's chunk of the result kept
    (:meth:`repro_torch.models.sharding.TokenShard.gather_seq`)."""
    y, _, aux = block(p, shard.gather_seq(x), cfg, **kw)
    return shard.local_seq(y), None, aux


def rwkv_block(p, x, cfg, *, state: RWKVBlockState | None = None, place=None, shard=None):
    """RWKV6 time mix, then the channel mix.  Returns ``(x, new_state,
    aux_loss)``, the aux loss the float 0.0; the state is new tensors.
    Under a ``tp``/``sp`` recipe ``x`` is this rank's rows and ``place``
    its part of the program: the time mix by heads
    (:func:`repro_torch.models.ssm.rwkv6_mix_placed`), the channel mix's
    ``f`` columns where the recipe cuts them, the partials summed over
    ``model``; ``state`` is then this rank's block.  Under ``sp_ring``
    (``shard``) the block runs over the gathered sequence."""
    if shard is not None:
        return _whole_sequence(rwkv_block, p, x, cfg, shard)
    tm = state.time if state is not None else None
    if place is not None:
        h, tstate = ssm_mod.rwkv6_mix_placed(p["time_mix"], rmsnorm(p["ln1"], x), place=place,
                                             n_heads=cfg.n_heads, chunk=cfg.ssm_chunk, state=tm)
    else:
        h, tstate = ssm_mod.rwkv6_mix(p["time_mix"], rmsnorm(p["ln1"], x), n_heads=cfg.n_heads,
                                      chunk=cfg.ssm_chunk, state=tm)
    x = x + h
    xn = rmsnorm(p["ln2"], x)
    prev = state.cm_shift[:, None].to(xn.dtype) if state is not None else \
        torch.zeros_like(xn[:, :1])
    xp = torch.cat([prev, xn[:, :-1]], dim=1)
    mix = p["cm_mix"].to(x.dtype)
    xk = xn + (xp - xn) * mix[0]
    xr = xn + (xp - xn) * mix[1]
    if place is not None and place.M > 1 and p["cm_k"].shape[1] != cfg.d_ff:
        # this rank's f columns: a float32 partial summed over model
        k = torch.square(F.relu(place.enter_model(xk) @ p["cm_k"].to(x.dtype)))
        kv = place.sum_model(partial_product(k, p["cm_v"])).to(x.dtype)
    else:
        k = torch.square(F.relu(xk @ p["cm_k"].to(x.dtype)))
        kv = k @ p["cm_v"].to(x.dtype)
    r = torch.sigmoid(xr @ p["cm_r"].to(x.dtype))
    return x + r * kv, RWKVBlockState(time=tstate, cm_shift=xn[:, -1]), 0.0


# ------------------------------------------------------------ Mamba block ----

def mamba_block_specs(cfg) -> dict:
    dt = cfg.param_dtype
    return {
        "ln": norm_spec(cfg.d_model, dt),
        "mix": ssm_mod.mamba2_specs(cfg.d_model, d_state=cfg.ssm_state,
                                    head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                                    n_groups=cfg.ssm_groups, dtype=dt),
    }


def mamba_block(p, x, cfg, *, state=None, place=None, shard=None):
    """Pre-norm Mamba2 with a residual.  Returns ``(x, new_state,
    aux_loss)``, the aux loss the float 0.0; the state is new tensors.
    ``place`` and ``shard`` as for :func:`rwkv_block`
    (:func:`repro_torch.models.ssm.mamba2_mix_placed`)."""
    if shard is not None:
        return _whole_sequence(mamba_block, p, x, cfg, shard)
    kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
              n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk, state=state)
    if place is not None:
        h, new_state = ssm_mod.mamba2_mix_placed(p["mix"], rmsnorm(p["ln"], x), place=place, **kw)
    else:
        h, new_state = ssm_mod.mamba2_mix(p["mix"], rmsnorm(p["ln"], x), **kw)
    return x + h, new_state, 0.0


# --------------------------------------------------- Zamba2 shared block ----

def shared_attn_block_specs(cfg) -> dict:
    """One shared transformer block; its per-application LoRA is
    :func:`shared_lora_specs`."""
    dt = cfg.param_dtype
    return {
        "ln1": norm_spec(cfg.d_model, dt),
        "ln2": norm_spec(cfg.d_model, dt),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, dtype=dt),
        "ffn": ffn_mod.swiglu_specs(cfg.d_model, cfg.d_ff, dt),
    }


def shared_lora_specs(cfg, rank: int = 8) -> dict:
    dt = cfg.param_dtype
    return {
        "lora_a": pspec(("m", cfg.d_model), ("r", rank), dtype=dt, scale=0.01),
        "lora_b": pspec(("r", rank), ("m", cfg.d_model), dtype=dt, init="zeros"),
    }


def shared_attn_block(p_shared, p_lora, x, cfg, *, cache=None, positions=None,
                      window: int | None = None, new_counts=None, idle_read_chunk=None,
                      place=None, shard=None):
    """The shared-weight attention block with its per-application LoRA on
    the block's input, then GQA attention and SwiGLU.  Returns ``(x,
    new_cache, aux_loss)``, the aux loss the float 0.0; the cache, if
    given, is updated in place.

    ``window`` is taken and not used, as in the reference: the window acts
    only through the size of the ring-buffer cache (``lm.init_cache``), so
    the forward attends over the whole causal prefix.  ``new_counts`` and
    ``idle_read_chunk`` as for :func:`attn_block`: a row with a count of 0
    keeps its K/V and length (the reference writes it and restores it
    after the block, ``lm._mask_rows``).  ``place`` and ``shard`` as for
    :func:`attn_block`; the LoRA acts on the block's input, whole over
    ``model``, on every rank."""
    del window
    dt = x.dtype
    xa = x + (x @ p_lora["lora_a"].to(dt)) @ p_lora["lora_b"].to(dt)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, positions=positions, cache=cache,
              attn_impl=cfg.attn_impl, block=cfg.attn_block,
              new_counts=new_counts, idle_read_chunk=idle_read_chunk)
    if place is not None:
        h, new_cache = attn.gqa_attention_placed(p_shared["attn"], rmsnorm(p_shared["ln1"], xa),
                                                 place=place, **kw)
        x = x + h
        f = ffn_mod.ffn_placed(p_shared["ffn"], rmsnorm(p_shared["ln2"], x), kind="swiglu",
                               d_ff=cfg.d_ff, place=place)
        return x + f, new_cache, 0.0
    h, new_cache = attn.gqa_attention(p_shared["attn"], rmsnorm(p_shared["ln1"], xa),
                                      seq_len=None if shard is None else shard.S, **kw)
    x = x + h
    f = ffn_mod.swiglu(p_shared["ffn"], rmsnorm(p_shared["ln2"], x))
    return x + f, new_cache, 0.0
