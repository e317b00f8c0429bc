"""Decoder blocks: the dense and MoE LMs' pre-norm GQA attention + FFN
(SwiGLU, the GELU MLP, or the top-k MoE), and the MLA family's pre-norm
multi-head latent attention + SwiGLU.

The reference scans stacked layer parameters with ``lax.scan``; the port
keeps the stacked ``(L, ...)`` layout and loops over the layer index
(``repro_torch.models.lm``).  The VLM cross-attention, SSM and hybrid
blocks wait for their families' slices (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn as ffn_mod
from .module import pspec

__all__ = ["norm_spec", "rmsnorm", "attn_block_specs", "attn_block", "mla_block_specs",
           "mla_block"]


def norm_spec(d: int, dtype=torch.float32):
    return pspec(("m", d), dtype=dtype, init="ones")


def rmsnorm(w, x, eps: float = 1e-5):
    """Normalized in float32, cast to x's dtype, then times the weight in
    x's dtype (the reference's order)."""
    xf = x.float()
    v = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype) * w.to(x.dtype)


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
               idle_read_chunk=None, shard=None):
    """Pre-norm attention + FFN.  Returns ``(x, new_cache, aux_loss)``; the
    cache, if given, is updated in place, and the aux loss is the MoE's
    (the float 0.0 for the other FFNs: no kernel for a dense layer).  Under a sequence-parallel recipe ``x`` is this
    rank's block of the token grid that ``shard`` (a
    :class:`repro_torch.models.sharding.TokenShard`) describes (see
    :func:`repro_torch.models.attention.gqa_attention` and
    :func:`repro_torch.models.ffn.moe_ffn`)."""
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
              idle_read_chunk=None):
    """Pre-norm MLA + SwiGLU.  Returns ``(x, new_cache, aux_loss)``, the aux
    loss the float 0.0; the latent caches, if given, are updated in place
    (:func:`repro_torch.models.attention.mla_attention`)."""
    h, new_cache = attn.mla_attention(
        p["attn"], rmsnorm(p["ln1"], x),
        n_heads=cfg.n_heads, d_nope=cfg.mla_d_nope, d_rope=cfg.mla_d_rope, d_v=cfg.mla_d_v,
        rope_theta=cfg.rope_theta, positions=positions, cache=cache,
        attn_impl=cfg.attn_impl, block=cfg.attn_block,
        new_counts=new_counts, prefill=prefill, idle_read_chunk=idle_read_chunk,
    )
    x = x + h
    f = ffn_mod.swiglu(p["ffn"], rmsnorm(p["ln2"], x))
    return x + f, new_cache, 0.0
