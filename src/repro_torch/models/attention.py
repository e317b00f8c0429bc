"""GQA attention (RoPE, optional QKV bias) of the dense LM and its KV cache;
MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style) and its
latent cache; the VLM's non-causal cross-attention to image states.

Attention dispatch
------------------
Both attention paths go through :mod:`repro_torch.kernels.ops`:

==========  ==================================  ==================================
Path        CUDA tensors (default)              CPU tensors (default)
==========  ==================================  ==================================
seq         ``flash_attention_kernel``          ``flash_attention_ref``
(forward)   (``impl="cuda"``)                   (its plain version, ``"ref"``)
ring step   ``flash_attention_kernel``, carry   ``flash_carry_ref``
(sp_ring)   form: one launch per held KV block  (its plain version, ``"ref"``)
decode      ``flash_decode_kernel`` + combine   ``flash_decode_ref``
(serving)   (``impl="cuda"``)                   (its plain version, ``"ref"``)
==========  ==================================  ==================================

``attn_impl="jnp"`` selects, for decode, the reference's dense path (all
scores at once, probabilities normalized and *then* rounded to the cache
dtype); on the seq and ring paths it means the plain version.

MLA's full-sequence path is the seq path with q/k of ``d_nope + d_rope``
and v of ``d_v`` (96 and 64 for minicpm3: the kernel's ``(96, 64)``
instance); its decode is the reference's absorbed form in plain PyTorch
products (no kernel, as in the reference).  The VLM's cross-attention is
the seq path, non-causal, with Sq (the text's length, 1 in a decode step)
over Skv (the image's 1024 positions); under a recipe each rank runs its
heads or its chunk of the queries over its rows' whole image
(:func:`cross_attention_placed`).

Under an active ``sp_ring`` recipe (:mod:`repro_torch.models.sharding`) the
seq path becomes the
sequence-parallel ring (:func:`ring_attention_seq`): every rank holds its
contiguous chunk of the sequence, and the KV blocks rotate around the
``model`` axis with :func:`repro_torch.core.p2p.shard_ring_shift_start`
issued *before* each step's local attention and waited after it
(double-buffered, like the SUMMA ring).  Under a ``tp`` or plain ``sp``
recipe, and in decode under any recipe, each rank runs its part of the
recipe's program (:func:`gqa_attention_placed`): its heads (``tp``) or its
chunk of the queries (``sp``) through the same kernels, its block of the
caches, and the collectives that put the results together; a whole-prompt
prefill chunk under ``sp_ring`` runs the ring over the chunk's fresh Q/K/V.

Rounding.  The reference wraps activation-dtype boundaries in ``pin`` (an
XLA barrier, ``repro/models/numerics.py``) so that the compiler cannot fold
a convert into a neighbouring float32 op.  Eager PyTorch rounds every op's
output to its dtype anyway, which is what ``pin`` forces, so the port has
no counterpart.

Weights are cast to the activation dtype at every use, like the reference's
``.astype(x.dtype)``; the cast is free when the caller hands in weights
already in that dtype (``repro_torch.models.weights.cast_params``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.p2p import shard_ring_shift_start
from repro_torch.core.plan import ring
from repro_torch.kernels import ops
from repro_torch.kernels.fake import is_fake
from repro_torch.kernels.ref import NEG_INF

from .module import pspec
from .sharding import all_gather, current_recipe, lse_merge, partial_product, ragged_seq_extents

__all__ = ["rope_angles", "apply_rope", "gqa_specs", "mla_specs", "attention_seq",
           "attention_decode", "ring_step_offsets", "ring_attention_seq", "KVCache",
           "gqa_attention", "gqa_attention_placed", "idle_rows_read_chunk", "MLACache",
           "mla_attention", "mla_attention_placed", "cross_attn_specs", "cross_attention",
           "cross_attention_placed"]


# ------------------------------------------------------------------ RoPE ----

def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions (...,) int -> cos/sin (..., dim/2) float32."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, D even); cos/sin (S, D/2) shared, or (B, S, D/2) per row
    (every slot rotates at its own absolute position).  The rotation is
    float32; the result is in x's dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        shape = [1] * (x.ndim - 2) + list(cos.shape)
    else:  # batched (B, S, D/2): broadcast over the head dims between B and S
        shape = [cos.shape[0]] + [1] * (x.ndim - cos.ndim) + list(cos.shape[1:])
    c, s = cos.reshape(shape), sin.reshape(shape)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------ param specs ----

def gqa_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int, *, qkv_bias: bool = False,
              dtype=torch.float32) -> dict:
    s = {
        "wq": pspec(("m", d_model), ("h", n_heads), ("d", head_dim), dtype=dtype, fan_in=("m",)),
        "wk": pspec(("m", d_model), ("g", n_kv), ("d", head_dim), dtype=dtype, fan_in=("m",)),
        "wv": pspec(("m", d_model), ("g", n_kv), ("d", head_dim), dtype=dtype, fan_in=("m",)),
        "wo": pspec(("h", n_heads), ("d", head_dim), ("m", d_model), dtype=dtype,
                    fan_in=("h", "d")),
    }
    if qkv_bias:
        s["bq"] = pspec(("h", n_heads), ("d", head_dim), dtype=dtype, init="zeros")
        s["bk"] = pspec(("g", n_kv), ("d", head_dim), dtype=dtype, init="zeros")
        s["bv"] = pspec(("g", n_kv), ("d", head_dim), dtype=dtype, init="zeros")
    return s


def mla_specs(d_model: int, n_heads: int, *, q_rank: int, kv_rank: int, d_nope: int, d_rope: int,
              d_v: int, dtype=torch.float32) -> dict:
    return {
        "wdq": pspec(("m", d_model), ("q", q_rank), dtype=dtype, fan_in=("m",)),
        "wuq": pspec(("q", q_rank), ("h", n_heads), ("c", d_nope + d_rope), dtype=dtype,
                     fan_in=("q",)),
        "wdkv": pspec(("m", d_model), ("k", kv_rank), dtype=dtype, fan_in=("m",)),
        "wkr": pspec(("m", d_model), ("r", d_rope), dtype=dtype, fan_in=("m",)),
        "wuk": pspec(("k", kv_rank), ("h", n_heads), ("n", d_nope), dtype=dtype, fan_in=("k",)),
        "wuv": pspec(("k", kv_rank), ("h", n_heads), ("w", d_v), dtype=dtype, fan_in=("k",)),
        "wo": pspec(("h", n_heads), ("w", d_v), ("m", d_model), dtype=dtype, fan_in=("h", "w")),
        "q_norm": pspec(("q", q_rank), dtype=dtype, init="ones"),
        "kv_norm": pspec(("k", kv_rank), dtype=dtype, init="ones"),
    }


# ------------------------------------------------------------------ cores ----

def _kernel_impl(impl: str | None) -> str | None:
    return "ref" if impl == "jnp" else impl


def attention_seq(q, k, v, *, causal: bool = True, impl: str | None = None, block: int = 512):
    """q (B,H,S,D), k/v (B,G,S,D) — full-sequence blockwise attention."""
    return ops.flash_attention(q, k, v, causal=causal, impl=_kernel_impl(impl), block=block)


# ------------------------------------------------------- ring attention ----


def ring_step_offsets(rank: int, step: int, R: int, chunk: int) -> tuple[int, int]:
    """``(q_offset, k_offset)`` of ring step ``step`` on rank ``rank`` of an
    R-rank ring of ``chunk``-long sequence chunks: after ``step`` hops of +1
    the rank holds the KV block of rank ``(rank - step) % R``."""
    return rank * chunk, ((rank - step) % R) * chunk


def _ring_attention_local(q, k, v, *, mesh, axis_name: str, causal: bool, double_buffer: bool,
                          valid_len: int | None = None, impl: str | None = None):
    """This rank's part of the sequence-parallel attention ring.

    ``q`` (B,H,Sl,D) and ``k``/``v`` (B,G,Sl,D) are the rank's contiguous
    chunks of a sequence of R*Sl positions (R ranks on ``axis_name``, rank
    ``r`` at positions ``[r*Sl, (r+1)*Sl)``).  Each of R steps merges the
    attention of the resident Q chunk over the held KV block into the
    running ``(acc, m, l)`` state with one carry step
    (:func:`repro_torch.kernels.ops.flash_attention_carry`: the kernel on
    the card, its plain version on the CPU), while the next KV block is in
    flight.  The rotation is a declared :func:`repro_torch.core.plan.ring`
    plan that issues :func:`repro_torch.core.p2p.shard_ring_shift_start`
    before the step's attention and waits after it;
    ``double_buffer=False`` is the blocking interpretation of the same plan,
    bitwise equal.  Keys at global positions ``>= valid_len`` are padding
    (ragged shards); the rows past it are garbage for the caller to drop.
    The epilogue normalizes ``acc / l`` (``l == 0 -> 1``) into q's dtype."""
    R, me = mesh.shape[axis_name], mesh.coords()[axis_name]
    B, Hq, Sl, D = q.shape
    scale = D ** -0.5
    dev = q.device

    def compute(acc, kv, s):
        kb, vb = kv
        q_off, k_off = ring_step_offsets(me, s, R, Sl)
        return ops.flash_attention_carry(q, kb, vb, acc, q_offset=q_off, k_offset=k_off,
                                         valid_len=valid_len, causal=causal, scale=scale,
                                         impl=_kernel_impl(impl))

    acc0 = (torch.zeros((B, Hq, Sl, v.shape[-1]), dtype=torch.float32, device=dev),
            torch.full((B, Hq, Sl), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, Hq, Sl), dtype=torch.float32, device=dev))
    plan = ring(
        R,
        transfer=lambda kv, s: shard_ring_shift_start(kv, axis_name, 1, mesh=mesh),
        compute=compute,
        epilogue=lambda acc, kv: (
            acc[0] / torch.where(acc[2] == 0.0, 1.0, acc[2])[..., None]).to(q.dtype),
    )
    return plan.run((k, v), acc0, double_buffer=double_buffer)


def ring_attention_seq(q, k, v, *, mesh, axis_name: str = "model", causal: bool = True,
                       double_buffer: bool = True, impl: str | None = None):
    """Sequence-parallel ring attention over the ``axis_name`` mesh axis,
    the distributed twin of :func:`attention_seq`.

    q (B,H,S,D) and k/v (B,G,S,D) are the whole sequence, on every rank;
    each rank computes the output rows of its own contiguous chunk and
    returns them, (B,H,extent,D): rank ``r``'s chunk is
    ``ragged_seq_extents(S, R)``'s, so the ranks' chunks put together in
    rank order are the whole output.  Per step a rank moves only its
    (B,G,cap,D) KV block, behind the step's attention (see
    :func:`_ring_attention_local`).  Lengths that do not divide the ring
    pad to R equal capacity chunks and mask the padded keys."""
    R = mesh.shape[axis_name]
    S = q.shape[2]
    if k.shape[2] != S or v.shape[2] != S:
        raise ValueError(f"ring attention needs matching q/kv seq lens, got {S} vs {k.shape[2]}")
    cap, extents = ragged_seq_extents(S, R)
    valid_len = None if S == R * cap else S
    r = mesh.coords()[axis_name]
    ql, kl, vl = (torch.nn.functional.pad(x, (0, 0, 0, R * cap - S))[:, :, r * cap:(r + 1) * cap]
                  for x in (q, k, v))
    o = _ring_attention_local(ql, kl, vl, mesh=mesh, axis_name=axis_name, causal=causal,
                              double_buffer=double_buffer, valid_len=valid_len, impl=impl)
    return o[:, :, :extents[r]]


def _ring_applicable(recipe, q, k) -> bool:
    """The sp ring runs when the recipe asks for it and the shapes ring (any
    sequence length: ragged lengths run as padded capacity chunks with
    masked keys).  A model axis of one rank runs the ring's one step, the
    carry kernel, where the reference's GSPMD program has nothing to ring:
    the same attention, and one card drives the ring's kernel and its
    gradient."""
    if recipe is None or not recipe.sp_ring or recipe.attn_mode != "sp":
        return False
    if "model" not in recipe.mesh.shape:
        return False
    R = recipe.mesh.shape["model"]
    S = q.shape[2]
    return R >= 1 and S >= 1 and k.shape[2] == S and q.shape[1] % k.shape[1] == 0


def attention_decode(q, k_cache, v_cache, cache_len, *, q_positions=None,
                     impl: str | None = None, block: int = 512):
    """q (B,H,S,D) new queries; caches (B,G,T,D); positions >= cache_len are
    masked.  ``q_positions`` (B,S) are the queries' absolute positions: cache
    slot ``t`` is visible to query ``j`` iff ``t <= q_positions[b, j]`` (the
    causal mask within a whole-prompt chunk, and each slot's own position
    under continuous batching).

    ``impl``: ``"cuda"`` (the default for CUDA tensors) runs the split-KV
    kernel, ``"ref"`` (the default for CPU tensors) its plain version, and
    ``"jnp"`` the reference's dense path below."""
    B, Hq, S, D = q.shape
    _, G, T, _ = k_cache.shape
    rep = Hq // G
    if impl != "jnp":
        return ops.flash_decode(q, k_cache, v_cache, cache_len, q_positions=q_positions,
                                impl=impl, block=block)
    # scores and the p@v contraction accumulate in float32 over the cache in
    # its storage dtype (bf16 products are exact in float32)
    qg = q.reshape(B, G, rep, S, D).float()
    s = torch.matmul(qg, k_cache.float()[:, :, None].transpose(-1, -2)) * (D ** -0.5)
    t = torch.arange(T, device=q.device)
    mask = t < torch.clamp(cache_len.long(), max=T).reshape(B, 1, 1, 1, 1)
    if q_positions is not None:
        mask = mask & (t <= q_positions.long().reshape(B, 1, 1, S, 1))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    # the normalized probabilities round to the cache dtype before p@v
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.matmul(p.float(), v_cache.float()[:, :, None])
    return o.reshape(B, Hq, S, D).to(q.dtype)


# ---------------------------------------------------------------- GQA op ----

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, G, T, D)
    v: torch.Tensor  # (B, G, T, D)
    length: torch.Tensor  # (B,) int32


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsm,mhd->bhsd", x, w)`` in x's dtype."""
    B, S, m = x.shape
    _, h, d = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(m, h * d)).reshape(B, S, h, d).transpose(1, 2)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bhsd,hdm->bsm", o, wo)`` in o's dtype."""
    B, h, S, d = o.shape
    return torch.matmul(o.transpose(1, 2).reshape(B, S, h * d), wo.to(o.dtype).reshape(h * d, -1))


def gqa_attention(p, x, *, n_heads: int, n_kv: int, head_dim: int, rope_theta: float = 10000.0,
                  positions=None, cache: KVCache | None = None, causal: bool = True,
                  attn_impl: str | None = None, block: int = 512, new_counts=None,
                  prefill: bool = False, idle_read_chunk: bool | None = None,
                  seq_len: int | None = None, sp_ring_double_buffer: bool = True):
    """x (B,S,m) -> (B,S,m).  ``cache`` switches to decode mode.

    Under an active ``sp_ring`` recipe over R ranks of ``model``, the
    full-sequence path runs :func:`_ring_attention_local`: ``x`` is then
    this rank's chunk of a sequence padded to R chunks, ``positions`` its
    absolute positions and ``seq_len`` the sequence's valid length (keys
    past it are padding); ``sp_ring_double_buffer=False`` runs the ring's
    blocking form (bitwise the same).

    Decode takes multi-token chunks (S >= 1) with per-row state:
    ``positions`` may be (B,S) absolute positions and ``new_counts`` (B,)
    says how many of the chunk's tokens are valid per row.  The cache is
    updated **in place** (see :func:`_cache_update`): rows with a count of
    0 keep their K/V, and each row's length advances by its own count.
    Idle rows attend as the reference's do, over their cache with the chunk
    written, through a copy when :func:`idle_rows_read_chunk` says that the
    chunk is visible to one of them; ``idle_read_chunk`` passes that answer
    in (the caller's one host sync per step), or ``None`` asks here.
    ``prefill`` marks a whole-prompt chunk; without a sequence-parallel
    recipe it runs like any chunk.  Returns ``(out, new_cache)``."""
    del prefill, n_heads, n_kv  # the shapes come from the weights
    B, S, _ = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        new_len = cache.length + (S if new_counts is None else new_counts)
        kc, vc = (t.transpose(1, 2) for t in _write_chunk(
            [(cache.k.transpose(1, 2), k.transpose(1, 2)),
             (cache.v.transpose(1, 2), v.transpose(1, 2))],
            cache.length, new_counts, idle_read_chunk))
        q_pos = positions if positions.ndim == 2 else None
        o = attention_decode(q, kc, vc, new_len, q_positions=q_pos, impl=attn_impl, block=block)
        return _out_proj(o, p["wo"]), KVCache(cache.k, cache.v, new_len.to(cache.length.dtype))
    recipe = current_recipe()
    if _ring_applicable(recipe, q, k):
        R = recipe.mesh.shape["model"]
        o = _ring_attention_local(q, k, v, mesh=recipe.mesh, axis_name="model", causal=causal,
                                  double_buffer=sp_ring_double_buffer,
                                  valid_len=seq_len if seq_len not in (None, R * S) else None,
                                  impl=attn_impl)
        return _out_proj(o, p["wo"]), None
    o = attention_seq(q, k, v, causal=causal, impl=attn_impl, block=block)
    return _out_proj(o, p["wo"]), None


def _kv_for_heads(t: torch.Tensor, h0: int, hl: int, rep: int, g0: int) -> torch.Tensor:
    """K or V (B, ng, S, D) of groups ``[g0, g0 + ng)`` as read by heads
    ``[h0, h0 + hl)`` (head ``h`` reads group ``h // rep``): the groups as
    they are when the heads are whole groups, else one group per head (a
    head block that cuts a group, where ``n_kv`` does not divide
    ``model``)."""
    if h0 % rep == 0 and hl % rep == 0:
        return t
    return t[:, [h // rep - g0 for h in range(h0, h0 + hl)]]


def gqa_attention_placed(p, x, *, place, n_heads: int, n_kv: int, head_dim: int,
                         rope_theta: float = 10000.0, positions=None, cache: KVCache | None = None,
                         causal: bool = True, attn_impl: str | None = None, block: int = 512,
                         new_counts=None, prefill: bool = False,
                         idle_read_chunk: bool | None = None):
    """This rank's part of :func:`gqa_attention` under a ``tp`` or plain
    ``sp`` recipe (:class:`repro_torch.models.sharding.Placement`).

    ``x`` (Bl, S, m) is this rank's rows, whole over ``model``; ``p`` the
    layer's weights with their ``m`` dim gathered, their heads (``h``) and
    KV groups (``g``) cut where the recipe binds them.  Returns ``(out
    (Bl, S, m), new_cache)``, ``out`` the same on every ``model`` rank.

    * Under ``tp`` (heads over ``model``) the rank runs its heads and the KV
      groups they read through :func:`attention_seq` /
      :func:`attention_decode`, and its float32 partial of the output
      projection is summed over ``model``.  Where ``n_kv`` does not divide
      ``model`` the groups are whole on every rank and a head block reads
      the groups its heads map to.
    * Under plain ``sp`` the rank's chunk of the queries
      (:func:`ragged_seq_extents`) attends over the whole K/V at its offset
      (the carry form's offsets, one step from an empty carry; the chunk at
      offset 0 takes the single-shot kernel, whose top-left causal mask is
      its own), and the chunks' projected outputs are gathered over
      ``model``.  Where the residual stream is carried cut by sequence
      (``place.S`` set: the cache-less forward of the flat attention
      stacks), ``x`` is this rank's ``(Bl, cap, m)`` chunk and
      ``positions`` its positions: the rank projects its chunk's Q/K/V,
      ropes them there, gathers the chunks' K/V along the sequence (the
      padding dropped; the backward reduce-scatters), and returns its
      chunk of the output, projected and not gathered.
    * Decode (``cache`` this rank's block of the caches, cut by
      :func:`repro_torch.models.sharding.decode_state_shardings`; its
      ``length`` (B,), ``positions`` (B, S) and ``new_counts`` (B,) whole): a
      cache cut by heads runs the heads of its groups and sums the partials;
      a cache cut by sequence is gathered over ``model``, written as one
      cache, and each rank keeps its block.  ``prefill`` under an
      ``sp_ring`` recipe with more than one ``model`` rank (the reference's
      ``_ring_applicable``) writes the cache and runs the ring over the
      chunk's fresh Q/K/V.
    """
    B, S, _ = x.shape
    H, G, rep = n_heads, n_kv, n_heads // n_kv
    M, mr, recipe = place.M, place.mr, place.recipe
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)
    local = place.local_rows
    pos = local(positions) if positions.ndim == 2 else positions
    head_cache = cache is not None and M > 1 and cache.k.shape[1] != G
    seq_cache = (cache is not None and M > 1 and not head_cache
                 and recipe.spec("cache_kv")[2] == "model")
    ring = (cache is not None and prefill and M > 1 and recipe.sp_ring
            and recipe.attn_mode == "sp")
    seq_split = cache is None and M > 1 and recipe.attn_mode == "sp"
    chunk = seq_split and place.S is not None  # x is this rank's chunk of the sequence
    # the heads this rank attends with: all of them (sp), its cache's
    # groups' heads, or its tp head block
    if ring or seq_split:
        h0, hl = 0, H
    elif head_cache:
        hl = cache.k.shape[1] * rep
        h0 = mr * hl
    elif p["wq"].shape[1] != H:
        hl = p["wq"].shape[1]
        h0 = mr * hl
    else:
        h0, hl = 0, H
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1  # the groups those heads read
    # the groups this rank projects: every group where it writes a cache of
    # every group, or rings every head
    kg0, kg1 = (0, G) if cache is not None and (ring or not head_cache) else (g0, g1)
    split = M > 1 and (hl != H or seq_split)

    def take(w, dim, start, n, full):
        return place.block(w, dim, start, n, full, split=split)

    xn = place.enter_model(x) if split and not chunk else x
    wq, wo = take(p["wq"], 1, h0, hl, H), take(p["wo"], 0, h0, hl, H)
    wk, wv = take(p["wk"], 1, kg0, kg1 - kg0, G), take(p["wv"], 1, kg0, kg1 - kg0, G)
    rows, q_pos = xn, pos
    if seq_split and not chunk:
        cap, _ = ragged_seq_extents(S, M)
        rows = torch.nn.functional.pad(xn, (0, 0, 0, M * cap - S))[:, mr * cap:(mr + 1) * cap]
        q_pos = torch.cat([pos, pos[-1] + 1 + torch.arange(M * cap - S, device=x.device)])[
            mr * cap:(mr + 1) * cap]
    q, k, v = _project(rows, wq), _project(xn, wk), _project(xn, wv)
    if "bq" in p:
        q = q + take(p["bq"], 0, h0, hl, H).to(dt)[None, :, None, :]
        k = k + take(p["bk"], 0, kg0, kg1 - kg0, G).to(dt)[None, :, None, :]
        v = v + take(p["bv"], 0, kg0, kg1 - kg0, G).to(dt)[None, :, None, :]
    cos, sin = rope_angles(pos, head_dim, rope_theta)
    k = apply_rope(k, cos, sin)
    q = apply_rope(q, *((cos, sin) if q_pos is pos else rope_angles(q_pos, head_dim,
                                                                     rope_theta)))
    if chunk:  # the chunks' K/V along the sequence, as the reference's program gathers them
        k, v = place.gather_seq(k, 2), place.gather_seq(v, 2)
    new_cache = None
    if cache is not None:
        counts = None if new_counts is None else local(new_counts)
        new_len = cache.length + (S if new_counts is None else new_counts)
        kw, vw = k, v
        if head_cache and ring:  # the cache keeps this rank's groups
            gl = cache.k.shape[1]
            kw, vw = k[:, mr * gl:(mr + 1) * gl], v[:, mr * gl:(mr + 1) * gl]
        kc, vc = cache.k, cache.v
        if seq_cache:  # one whole cache, written as one; this rank keeps its block
            kc, vc = place.gather_model(kc, 2), place.gather_model(vc, 2)
        written = (kc, vc)
        kc, vc = (t.transpose(1, 2) for t in _write_chunk(
            [(kc.transpose(1, 2), kw.transpose(1, 2)), (vc.transpose(1, 2), vw.transpose(1, 2))],
            local(cache.length), counts, idle_read_chunk))
        if seq_cache:
            T = cache.k.shape[2]
            for mine, whole in zip((cache.k, cache.v), written):
                mine.copy_(whole[:, :, mr * T:(mr + 1) * T])
        new_cache = KVCache(cache.k, cache.v, new_len.to(cache.length.dtype))
        if not ring:
            if not head_cache:
                kc, vc = (_kv_for_heads(t[:, g0:g1], h0, hl, rep, g0) for t in (kc, vc))
            o = attention_decode(q, kc, vc, local(new_len),
                                 q_positions=pos if pos.ndim == 2 else None, impl=attn_impl,
                                 block=block)
            return _placed_out(o, wo, place, split, dt), new_cache
    if ring or seq_split:
        if ring:  # the rank's chunks of the fresh Q/K/V, around the ring
            cap, _ = ragged_seq_extents(S, M)
            ql, kl, vl = (torch.nn.functional.pad(t, (0, 0, 0, M * cap - S))[
                :, :, mr * cap:(mr + 1) * cap] for t in (q, k, v))
            o = _ring_attention_local(ql, kl, vl, mesh=recipe.mesh, axis_name="model",
                                      causal=causal, double_buffer=True,
                                      valid_len=None if S == M * cap else S, impl=attn_impl)
        elif mr == 0:  # the first chunk: the top-left causal mask is its own
            o = attention_seq(q, k, v, causal=causal, impl=attn_impl, block=block)
        else:
            acc, _, l = ops.flash_attention_carry(
                q, k, v, None, q_offset=mr * q.shape[2], k_offset=0, causal=causal,
                scale=head_dim ** -0.5, impl=_kernel_impl(attn_impl))
            o = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(dt)
        if chunk:
            return _out_proj(o, wo), None
        return place.gather_model(_out_proj(o, wo), 1)[:, :S], new_cache
    o = attention_seq(q, _kv_for_heads(k, h0, hl, rep, g0), _kv_for_heads(v, h0, hl, rep, g0),
                      causal=causal, impl=attn_impl, block=block)
    return _placed_out(o, wo, place, split, dt), None


def _placed_out(o, wo, place, split: bool, dt):
    """The output projection of this rank's heads: when the heads are
    split over ``model``, a float32 partial summed over the ranks and
    rounded once; else the plain product."""
    if not split:
        return _out_proj(o, wo)
    B, h, S, d = o.shape
    part = partial_product(o.transpose(1, 2).reshape(B, S, h * d), wo.reshape(h * d, -1))
    return place.sum_model(part).to(dt)


def idle_rows_read_chunk(length: torch.Tensor, new_counts: torch.Tensor, T: int, S: int) -> bool:
    """Whether an idle row (count 0) of a decode step would read its own
    chunk in the reference, which writes it: a row that sees no key (then
    every key counts, as the mean of v) or whose clamped write start lies
    below its visible length.  One host sync.

    Fake tensors (the dry run's trace, ``FakeTensorMode``) hold no values
    to read: there the answer is the dry run's state's, in which every row
    is live, so no idle row reads its chunk (``False``)."""
    if is_fake(new_counts):
        return False
    length = length.long()
    seen = torch.clamp(length, max=T)
    start = torch.clamp(length % T, max=T - S)
    return bool(((new_counts == 0) & ((seen == 0) | (start < seen))).any())


def _seq_cache_update(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor,
                      active: torch.Tensor | None) -> None:
    """Write the S new steps ``new`` (B, S, ...) of each row into ``cache``
    (B, T, ...) at the row's own ``length[b] % T``, in place, as the
    reference's vmapped ``dynamic_update_slice`` does: the start is clamped
    so that the S steps fit (``min(length % T, T - S)``).  Rows with
    ``active[b] == False`` are left as they were (the reference writes them
    and restores them, ``lm._mask_rows``).  No host sync."""
    B, T = cache.shape[:2]
    S = new.shape[1]
    start = torch.clamp(length.long() % T, max=T - S)
    t_idx = start[:, None] + torch.arange(S, device=cache.device)  # (B, S)
    b_idx = torch.arange(B, device=cache.device)[:, None]
    vals = new.to(cache.dtype)
    if active is not None:
        vals = torch.where(active.reshape((B,) + (1,) * (new.ndim - 1)), vals, cache[b_idx, t_idx])
    cache[b_idx, t_idx] = vals


def _cache_update(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor,
                  active: torch.Tensor | None) -> None:
    """:func:`_seq_cache_update` of a (B, G, T, D) K/V cache with new
    (B, G, S, D), in place."""
    _seq_cache_update(cache.transpose(1, 2), new.transpose(1, 2), length, active)


def _write_chunk(pairs, length: torch.Tensor, new_counts, idle_read_chunk: bool | None) -> list:
    """A decode step's cache writes: each ``(cache (B, T, ...), new (B, S,
    ...))`` pair's chunk goes into the cache in place, rows with a count of
    0 left as they were.  Returns what the step attends over: the caches,
    or, when an idle row would read its own chunk (:func:`idle_rows_read_chunk`,
    or the caller's answer ``idle_read_chunk``), copies with every row's
    chunk written.  The reference writes every row's chunk, attends, and
    then restores the idle rows (``lm._mask_rows``): its idle rows attend
    over the written chunk."""
    active = None if new_counts is None else new_counts > 0
    for cache, new in pairs:
        _seq_cache_update(cache, new, length, active)
    reads = [cache for cache, _ in pairs]
    if active is None:
        return reads
    T, S = reads[0].shape[1], pairs[0][1].shape[1]
    if idle_read_chunk if idle_read_chunk is not None else \
            idle_rows_read_chunk(length, new_counts, T, S):
        reads = [cache.clone() for cache in reads]
        for read, (_, new) in zip(reads, pairs):
            _seq_cache_update(read, new, length, None)
    return reads


# ---------------------------------------------------------------- MLA op ----

class MLACache(NamedTuple):
    c: torch.Tensor  # (B, T, kv_rank) compressed latent
    kr: torch.Tensor  # (B, T, d_rope) shared rope key
    length: torch.Tensor  # (B,) int32


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """MLA's RMS norm of its latents, the reference's ``_rms``: the mean
    square in float32, x times its rsqrt (a float32 product) rounded to x's
    dtype, then times the weight in x's dtype.  Not the block's
    :func:`repro_torch.models.blocks.rmsnorm` (eps 1e-5)."""
    v = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(v + eps)).to(x.dtype) * w.to(x.dtype)


def mla_attention(p, x, *, n_heads: int, d_nope: int, d_rope: int, d_v: int,
                  rope_theta: float = 10000.0, positions=None, cache: MLACache | None = None,
                  attn_impl: str | None = None, block: int = 512, new_counts=None,
                  prefill: bool = False, idle_read_chunk: bool | None = None):
    """Multi-head latent attention, x (B,S,m) -> (B,S,m), the reference's
    ``mla_attention``.  Returns ``(out, new_cache)``.

    Without a cache (forward): per-head K/V decompressed from the latent,
    ``k = [k_nope, kr]`` and ``q = [q_nope, q_rope]`` of ``d_nope + d_rope``
    and v of ``d_v``, through :func:`attention_seq` (on the card the
    flash-attention kernel's ``(96, 64)`` instance at minicpm3's dims).

    With a cache (decode and whole-prompt chunks): the absorbed form.
    ``wuk`` is absorbed into q, whose scores against the latent cache ``c``
    and the rope-key cache ``kr`` are summed in float32 and scaled by
    ``(d_nope + d_rope) ** -0.5``; cache slot ``t`` is visible iff
    ``t < length + count`` and, with (B,S) ``positions``, ``t <=
    positions[b, j]``; then softmax, ``p @ c``, ``wuv`` and ``wo``.  The
    caches are updated **in place** and idle rows (count 0) keep theirs, as
    in :func:`gqa_attention`."""
    del prefill, n_heads, d_v  # the shapes come from the weights
    B, S, _ = x.shape
    dt = x.dtype
    cq = _rms(torch.matmul(x, p["wdq"].to(dt)), p["q_norm"])
    q = _project(cq, p["wuq"])  # (B, H, S, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    c = _rms(torch.matmul(x, p["wdkv"].to(dt)), p["kv_norm"])  # (B, S, kv_rank)
    kr = torch.matmul(x, p["wkr"].to(dt))  # (B, S, d_rope)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    cos, sin = rope_angles(positions, d_rope, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kr = apply_rope(kr[:, None], cos, sin)[:, 0]

    if cache is None:
        k_nope, v = _project(c, p["wuk"]), _project(c, p["wuv"])
        H = k_nope.shape[1]
        k = torch.cat([k_nope, kr[:, None].expand(B, H, S, d_rope)], dim=-1)
        o = attention_seq(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True,
                          impl=attn_impl, block=block)
        return _out_proj(o, p["wo"]), None

    # ---- absorbed decode ----
    new_len = cache.length + (S if new_counts is None else new_counts)
    cc, krc = _write_chunk([(cache.c, c), (cache.kr, kr)], cache.length, new_counts,
                           idle_read_chunk)
    H, T = q.shape[1], cc.shape[1]
    # wuk absorbed into q: (B,H,S,n) @ (H,n,k) -> (B,H,S,k)
    q_abs = torch.matmul(q_nope, p["wuk"].to(dt).permute(1, 2, 0))
    ccf = cc.float()
    s = torch.bmm(q_abs.float().reshape(B, H * S, -1), ccf.transpose(1, 2))
    s += torch.bmm(q_rope.float().reshape(B, H * S, -1), krc.float().transpose(1, 2))
    s = s.reshape(B, H, S, T).mul_((d_nope + d_rope) ** -0.5)
    t = torch.arange(T, device=x.device)
    mask = t < new_len.reshape(B, 1, 1, 1)
    if positions.ndim == 2:  # per-row chunk causality: slot t visible to query j iff t <= pos
        mask = mask & (t <= positions.reshape(B, 1, S, 1))
    pr = torch.softmax(s.masked_fill_(~mask, NEG_INF), dim=-1)
    del s
    o_lat = torch.bmm(pr.reshape(B, H * S, T), ccf).reshape(B, H, S, -1).to(dt)
    del pr
    o = torch.matmul(o_lat, p["wuv"].to(dt).permute(1, 0, 2))  # (B,H,S,k) @ (H,k,w)
    return _out_proj(o, p["wo"]), MLACache(cache.c, cache.kr, new_len.to(cache.length.dtype))


def _write_block(pairs, length: torch.Tensor, new_counts, idle_read_chunk: bool | None,
                 T: int, base: int) -> list:
    """:func:`_write_chunk` on this rank's block of caches cut along their
    sequence: each ``(cache (B, Tl, ...), new (B, S, ...))`` pair's cache
    holds the whole cache's positions ``[base, base + Tl)`` of ``T``, and
    each row's chunk goes to the whole cache's ``min(length % T, T - S) +
    j``; this rank writes the positions that fall in its block, in place,
    rows with a count of 0 left as they were.  Returns what the step
    attends over, as :func:`_write_chunk` does.  No host sync: every
    position of the block takes its new value or keeps its old one in one
    pass."""
    active = None if new_counts is None else new_counts > 0
    reads = []
    for cache, new in pairs:
        B, Tl = cache.shape[:2]
        S = new.shape[1]
        start = torch.clamp(length.long() % T, max=T - S)
        src = base + torch.arange(Tl, device=cache.device)[None, :] - start[:, None]  # (B, Tl)
        hit = (src >= 0) & (src < S)
        idx = src.clamp(0, S - 1).reshape(B, Tl, *([1] * (new.ndim - 2))).expand(
            B, Tl, *new.shape[2:])
        vals = torch.gather(new.to(cache.dtype), 1, idx)
        tail = (1,) * (new.ndim - 2)
        keep = hit if active is None else hit & active[:, None]
        read = cache
        if active is not None and (idle_read_chunk if idle_read_chunk is not None else
                                   idle_rows_read_chunk(length, new_counts, T, S)):
            read = torch.where(hit.reshape(B, Tl, *tail), vals, cache)
        cache.copy_(torch.where(keep.reshape(B, Tl, *tail), vals, cache))
        reads.append(read)
    return reads


def mla_attention_placed(p, x, *, place=None, shard=None, n_heads: int, d_nope: int,
                         d_rope: int, d_v: int, rope_theta: float = 10000.0, positions=None,
                         cache: MLACache | None = None, attn_impl: str | None = None,
                         block: int = 512, new_counts=None, prefill: bool = False,
                         idle_read_chunk: bool | None = None):
    """This rank's part of :func:`mla_attention` under a sharding recipe:
    ``place`` (:class:`repro_torch.models.sharding.Placement`) under ``tp``
    and plain ``sp``, where ``x`` (Bl, S, m) is this rank's rows, whole over
    ``model``; ``shard`` (:class:`repro_torch.models.sharding.TokenShard`)
    under ``sp_ring``, where ``x`` is this rank's chunk of the sequence at
    absolute ``positions``.  ``p`` has its ``m`` dim gathered and, under
    ``tp``, its heads (``wuq``, ``wuk``, ``wuv``, ``wo``) cut over ``model``;
    the down projections, ``wkr`` and the two norms stay whole.  Returns
    ``(out, new_cache)``, ``out`` the same on every ``model`` rank.

    * ``tp``: the rank projects the latents ``c`` and ``kr`` whole, then its
      heads' q, ``k_nope`` and v, runs them through :func:`attention_seq`
      and sums a float32 partial of ``wo`` over ``model``, rounded once.
    * Plain ``sp``: every rank decompresses K/V for the whole sequence; its
      chunk of the queries (:func:`ragged_seq_extents`) attends over them,
      chunk 0 through the single-shot kernel (whose top-left causal mask is
      its own), chunk r > 0 through one carry step at ``q_offset = r *
      cap``; the chunks' projected outputs are gathered over ``model``.
    * ``sp_ring``: the chunk's ``c`` and roped ``kr`` (``kv_rank + d_rope``
      values a token, against ``2 * H * (d_nope + d_rope)`` for K and V) are
      gathered over ``model``, K/V decompressed for the whole padded
      sequence, and the chunk's queries run through one carry step at
      ``q_offset = r * cap``, ``k_offset = 0``, the padding past the
      sequence's ``S`` keys masked.  The reference computes this
      ``attention_seq`` with no ring and lets GSPMD gather.
    * Decode (``cache``: this rank's rows of the latent caches and its block
      ``[mr * Tl, (mr + 1) * Tl)`` of their positions,
      :func:`repro_torch.models.sharding.decode_state_shardings`): the rank
      writes the new positions that fall in its block, scores every head's
      absorbed query against its block (under ``tp`` the heads' ``q_abs``
      and ``q_rope`` gathered over ``model`` first), and the ranks' partial
      softmaxes merge by their log-sum-exp
      (:func:`repro_torch.models.sharding.lse_merge`); then ``wuv`` and
      ``wo`` of the rank's heads.  No rank gathers the whole cache.
      ``cache.length``, ``positions`` and ``new_counts`` are whole.

    On a ``model`` axis of one rank the program is :func:`mla_attention`'s
    on the rank's rows (under ``sp_ring``, its one carry step in place of
    the single-shot kernel)."""
    del prefill  # a whole-prompt chunk is the absorbed form's, as any chunk
    if shard is not None:
        return _mla_ring(p, x, shard=shard, d_nope=d_nope, d_rope=d_rope, rope_theta=rope_theta,
                         positions=positions, attn_impl=attn_impl)
    B, S, _ = x.shape
    H = n_heads
    M, mr, recipe = place.M, place.mr, place.recipe
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)
    local = place.local_rows
    pos = local(positions) if positions.ndim == 2 else positions
    kw = dict(n_heads=H, d_nope=d_nope, d_rope=d_rope, d_v=d_v, rope_theta=rope_theta,
              attn_impl=attn_impl, block=block, idle_read_chunk=idle_read_chunk)
    if M == 1:  # every rank of the model axis is this one: the no-recipe program
        if cache is None:
            return mla_attention(p, x, positions=pos, **kw)
        out, _ = mla_attention(p, x, positions=pos,
                               cache=MLACache(cache.c, cache.kr, local(cache.length)),
                               new_counts=None if new_counts is None else local(new_counts),
                               **kw)
        new_len = cache.length + (S if new_counts is None else new_counts)
        return out, MLACache(cache.c, cache.kr, new_len.to(cache.length.dtype))
    heads_cut = p["wuq"].shape[1] != H
    seq_split = cache is None and recipe.attn_mode == "sp"
    if cache is None and not heads_cut and not seq_split:  # every rank runs every head
        return mla_attention(p, x, positions=pos, **kw)
    hl = p["wuq"].shape[1]
    h0 = mr * hl if heads_cut else 0
    # the forward's ranks split heads or query chunks; in decode they split
    # the cache's positions (and under tp the heads too)
    split = cache is None or heads_cut
    xn = place.enter_model(x) if split else x

    def whole(w):  # a weight every rank holds whole, feeding split work
        return place.enter_model(w) if split else w

    wdq, wdkv, wkr = whole(p["wdq"]), whole(p["wdkv"]), whole(p["wkr"])
    q_norm, kv_norm = whole(p["q_norm"]), whole(p["kv_norm"])
    wuq, wuk, wuv = (whole(p[k]) if not heads_cut else p[k] for k in ("wuq", "wuk", "wuv"))
    wo = whole(p["wo"]) if not heads_cut else p["wo"]
    c = _rms(torch.matmul(xn, wdkv.to(dt)), kv_norm)  # (Bl, S, kv_rank)
    kr = torch.matmul(xn, wkr.to(dt))
    cos, sin = rope_angles(pos, d_rope, rope_theta)
    kr = apply_rope(kr[:, None], cos, sin)[:, 0]
    rows, q_pos = xn, pos
    if seq_split:
        cap, _ = ragged_seq_extents(S, M)
        rows = torch.nn.functional.pad(xn, (0, 0, 0, M * cap - S))[:, mr * cap:(mr + 1) * cap]
        q_pos = torch.cat([pos, pos[-1] + 1 + torch.arange(M * cap - S, device=x.device)])[
            mr * cap:(mr + 1) * cap]
    cq = _rms(torch.matmul(rows, wdq.to(dt)), q_norm)
    q = _project(cq, wuq)  # (Bl, hl, Sq, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, *((cos, sin) if q_pos is pos else
                                  rope_angles(q_pos, d_rope, rope_theta)))
    if cache is None:
        k_nope, v = _project(c, wuk), _project(c, wuv)
        k = torch.cat([k_nope, kr[:, None].expand(B, hl, S, d_rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        if not seq_split:  # tp: this rank's heads
            o = attention_seq(q, k, v, causal=True, impl=attn_impl, block=block)
            return _placed_out(o, wo, place, True, dt), None
        if mr == 0:  # the first chunk: the top-left causal mask is its own
            o = attention_seq(q, k, v, causal=True, impl=attn_impl, block=block)
        else:
            acc, _, l = ops.flash_attention_carry(
                q, k, v, None, q_offset=mr * q.shape[2], k_offset=0, causal=True,
                scale=(d_nope + d_rope) ** -0.5, impl=_kernel_impl(attn_impl))
            o = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(dt)
        return place.gather_model(_out_proj(o, wo), 1)[:, :S], None

    # ---- absorbed decode over this rank's block of the latent caches ----
    Tl = cache.c.shape[1]
    T = Tl * M
    new_len = cache.length + (S if new_counts is None else new_counts)
    cc, krc = _write_block([(cache.c, c), (cache.kr, kr)], local(cache.length),
                           None if new_counts is None else local(new_counts), idle_read_chunk,
                           T, mr * Tl)
    q_abs = torch.matmul(q_nope, wuk.to(dt).permute(1, 2, 0))  # (Bl, hl, S, kv_rank)
    if heads_cut:  # every head scores against this rank's block
        q_abs, q_rope = place.gather_model(q_abs, 1), place.gather_model(q_rope, 1)
    s = torch.bmm(q_abs.float().reshape(B, H * S, -1), cc.float().transpose(1, 2))
    s += torch.bmm(q_rope.float().reshape(B, H * S, -1), krc.float().transpose(1, 2))
    s = s.reshape(B, H, S, Tl).mul_((d_nope + d_rope) ** -0.5)
    t = mr * Tl + torch.arange(Tl, device=x.device)
    mask = t < local(new_len).reshape(B, 1, 1, 1)
    if pos.ndim == 2:  # per-row chunk causality: slot t visible to query j iff t <= pos
        mask = mask & (t <= pos.reshape(B, 1, S, 1))
    o_lat = lse_merge(s.masked_fill_(~mask, NEG_INF), cc[:, None], place.mesh, "model")
    o_lat = o_lat[:, h0:h0 + hl].to(dt)
    o = torch.matmul(o_lat, wuv.to(dt).permute(1, 0, 2))  # (Bl, hl, S, d_v)
    return (_placed_out(o, wo, place, heads_cut, dt),
            MLACache(cache.c, cache.kr, new_len.to(cache.length.dtype)))


def _mla_ring(p, x, *, shard, d_nope: int, d_rope: int, rope_theta: float, positions,
              attn_impl):
    """:func:`mla_attention_placed` under ``sp_ring``: ``x`` (Bl, cap, m) is
    this rank's chunk of a sequence padded to R chunks, ``positions`` its
    absolute positions; whole weights."""
    B, cap, _ = x.shape
    dt = x.dtype
    mesh = shard.mesh
    R = mesh.shape.get("model", 1)
    cq = _rms(torch.matmul(x, p["wdq"].to(dt)), p["q_norm"])
    q = _project(cq, p["wuq"])
    H = q.shape[1]
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    c = _rms(torch.matmul(x, p["wdkv"].to(dt)), p["kv_norm"])
    kr = torch.matmul(x, p["wkr"].to(dt))
    cos, sin = rope_angles(positions, d_rope, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kr = apply_rope(kr[:, None], cos, sin)[:, 0]  # at the chunk's absolute positions
    # the latents of the whole padded sequence: each rank's chunk is its own
    # queries' only, so the backward reduce-scatters the cotangent
    c, kr = (all_gather(t, mesh, "model", 1, split=True) for t in (c, kr))
    Sp = R * cap
    k = torch.cat([_project(c, p["wuk"]), kr[:, None].expand(B, H, Sp, d_rope)], dim=-1)
    v = _project(c, p["wuv"])
    acc, _, l = ops.flash_attention_carry(
        torch.cat([q_nope, q_rope], dim=-1), k, v, None, q_offset=shard.chunk * cap, k_offset=0,
        valid_len=None if shard.S == Sp else shard.S, causal=True,
        scale=(d_nope + d_rope) ** -0.5, impl=_kernel_impl(attn_impl))
    o = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(dt)
    return _out_proj(o, p["wo"]), None


# ------------------------------------------------------- cross-attention ----

def cross_attn_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int, d_enc: int,
                     dtype=torch.float32) -> dict:
    return {
        "wq": pspec(("m", d_model), ("h", n_heads), ("d", head_dim), dtype=dtype, fan_in=("m",)),
        "wk": pspec(("x", d_enc), ("g", n_kv), ("d", head_dim), dtype=dtype, fan_in=("x",)),
        "wv": pspec(("x", d_enc), ("g", n_kv), ("d", head_dim), dtype=dtype, fan_in=("x",)),
        "wo": pspec(("h", n_heads), ("d", head_dim), ("m", d_model), dtype=dtype,
                    fan_in=("h", "d")),
        "q_norm": pspec(("d", head_dim), dtype=dtype, init="ones"),
        "k_norm": pspec(("d", head_dim), dtype=dtype, init="ones"),
    }


def cross_attention(p, x, enc, *, attn_impl: str | None = None, block: int = 512):
    """x (B, S, m) attends to the encoder states enc (B, T, d_enc), the
    reference's ``cross_attention``: q from x and k/v from enc (cast to x's
    dtype first), each RMS-normed over its head dim (:func:`_rms`), then
    non-causal attention through :func:`attention_seq` (on the card the
    flash-attention kernel, with Sq = S over Skv = T) and the ``wo``
    projection.  No cache: the image's K/V are recomputed at every call,
    a decode step's too, as the reference does."""
    q = _rms(_project(x, p["wq"]), p["q_norm"])
    e = enc.to(x.dtype)
    k = _rms(_project(e, p["wk"]), p["k_norm"])
    v = _project(e, p["wv"])
    o = attention_seq(q, k, v, causal=False, impl=attn_impl, block=block)
    return _out_proj(o, p["wo"])


def cross_attention_placed(p, x, enc, *, place, n_heads: int, n_kv: int,
                           attn_impl: str | None = None, block: int = 512):
    """This rank's part of :func:`cross_attention` under a ``tp`` or plain
    ``sp`` recipe (:class:`repro_torch.models.sharding.Placement`): ``x``
    (Bl, S, m) are this rank's rows and ``enc`` (Bl, T, d_enc) their images
    (the recipe's ``enc`` spec: the whole image on every ``model`` rank),
    ``p`` the layer's weights with their ``m`` dim gathered.  Returns
    ``(Bl, S, m)``, as ``x``.

    * Heads cut over ``model`` (``tp``): the rank runs its query heads and
      the KV groups they read (whole groups on every rank where ``n_kv``
      does not divide ``model``, as :func:`gqa_attention_placed`) through
      the forward kernel, non-causal, and its float32 partial of ``wo`` is
      summed over ``model``; the result is the same on every ``model``
      rank.
    * The residual stream cut by sequence (``place.S`` set: plain ``sp``'s
      cache-less forward): ``x`` is this rank's ``(Bl, cap, m)`` chunk and
      its queries attend over the whole image of its rows, Sq ``cap`` and
      Skv ``T``, as the reference's program runs them (``q`` cut by
      sequence, ``enc`` whole over ``model``); the output projection runs
      on the chunk and is not gathered.  No ring and no carry: nothing of
      the image is cut by sequence.  The chunk's own cotangent stays its
      own; every weight (``wq``, ``wk``, ``wv``, ``wo`` and both norms) is
      used by this rank's queries alone, so its gradient is summed over
      ``model``.
    * Otherwise (one ``model`` rank, or whole heads over the rows' whole
      sequence: a decode step, a forward at per-row positions) every rank
      runs :func:`cross_attention` on its rows.

    The norms (and whole weights) feeding split work sum their gradients
    over ``model`` (:meth:`~repro_torch.models.sharding.Placement.block`,
    :meth:`~repro_torch.models.sharding.Placement.enter_model`)."""
    H, G = n_heads, n_kv
    rep = H // G
    M, mr = place.M, place.mr
    dt = x.dtype
    chunk = place.S is not None
    heads_cut = p["wq"].shape[1] != H and not chunk
    if M == 1 or not (heads_cut or chunk):
        return cross_attention(p, x, enc, attn_impl=attn_impl, block=block)
    hl = p["wq"].shape[1] if heads_cut else H
    h0 = mr * hl if heads_cut else 0
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1  # the groups those heads read

    def take(w, dim, start, n, full):
        return place.block(w, dim, start, n, full, split=True)

    wq, wo = take(p["wq"], 1, h0, hl, H), take(p["wo"], 0, h0, hl, H)
    wk, wv = take(p["wk"], 1, g0, g1 - g0, G), take(p["wv"], 1, g0, g1 - g0, G)
    q = _rms(_project(x if chunk else place.enter_model(x), wq), place.enter_model(p["q_norm"]))
    e = enc.to(dt)
    k = _rms(_project(e, wk), place.enter_model(p["k_norm"]))
    v = _project(e, wv)
    if chunk:
        return _out_proj(attention_seq(q, k, v, causal=False, impl=attn_impl, block=block), wo)
    o = attention_seq(q, _kv_for_heads(k, h0, hl, rep, g0), _kv_for_heads(v, h0, hl, rep, g0),
                      causal=False, impl=attn_impl, block=block)
    return _placed_out(o, wo, place, True, dt)
