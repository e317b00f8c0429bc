"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each function mirrors its kernel's semantics exactly, written with plain
tensor ops so it runs on any device and is obviously correct.  The CPU runs
use these; on the card, ``chip_smoke.py`` holds each kernel against them.
Products are taken in float32 with TF32 off.

The attention versions compute what the reference's *Pallas kernels*
compute (``flash_attention_pallas``, ``flash_attention_carry_pallas``,
``flash_decode_pallas``): padding to
the block, the finite ``-1e30`` mask, and for decode the per-block
rounding of the probabilities to the cache dtype.  The dense oracles
``attention_ref`` and ``decode_attention_ref`` are the reference's jnp
oracles, for tests.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["gemm_ref", "gemm_panel_ref", "flash_attention_ref", "flash_carry_ref",
           "flash_decode_ref", "attention_ref", "decode_attention_ref", "transpose_ref",
           "NEG_INF"]

NEG_INF = -1e30  # the reference kernels' finite mask value


@contextlib.contextmanager
def _full_f32():
    """Float32 matmuls at full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _logical_product(a, b, majors: str) -> torch.Tensor:
    _, a_major, b_major = majors.upper().split("/")
    al = a.T if a_major == "K" else a  # -> logical (i, k)
    bl = b.T if b_major == "J" else b  # -> logical (k, j)
    with _full_f32():
        return torch.matmul(al.float(), bl.float())


def gemm_ref(a, b, acc=None, *, majors: str = "I/I/K", out_dtype=None):
    """Reference for :func:`repro_torch.kernels.gemm.gemm_cuda` (same buffer
    conventions: majors = C/A/B major dims; ``acc`` is a previous C buffer in
    output orientation, added in float32 after the product)."""
    c = _logical_product(a, b, majors)
    if majors.upper().split("/")[0] == "J":
        c = c.T
    if acc is not None:
        c = c + acc.float()
    return c.to(out_dtype or a.dtype).contiguous()


def gemm_panel_ref(a, b, panel, jb, *, majors: str = "I/I/K"):
    """Reference for :func:`repro_torch.kernels.gemm.gemm_panel_cuda`:
    accumulate A @ B into j-block ``jb`` of the partial panel in place,
    leaving the other blocks untouched, and return the panel.  ``jb`` (an
    int or a one-element tensor) is clamped to the panel's blocks, like the
    reference's ``dynamic_slice``."""
    c = _logical_product(a, b, majors)
    N = c.shape[1]
    c_trans = majors.upper().split("/")[0] == "J"
    nb = (panel.shape[0] if c_trans else panel.shape[1]) // N
    jb = min(max(int(jb), 0), nb - 1)
    if c_trans:
        blk = panel[jb * N:(jb + 1) * N, :]
        c = c.T
    else:
        blk = panel[:, jb * N:(jb + 1) * N]
    blk.copy_((c + blk.float()).to(panel.dtype))
    return panel


def _pad_seq(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad the sequence axis (2) of a (B, H, S, D) tensor to ``to``."""
    if x.shape[2] == to:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, to - x.shape[2]))


def flash_attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                        block: int = 512):
    """Plain version of :func:`repro_torch.kernels.flash_attention.flash_attention_cuda`
    (the reference's ``flash_attention_pallas``): q (B, Hq, Sq, D), k/v
    (B, G, Skv, D).  KV is padded to a multiple of ``min(block, Skv)`` and
    walked block by block with the online softmax; q is scaled in float32
    and every step is float32; causal is top-left aligned (``q_pos >=
    k_pos``); padded keys and the causal mask score ``-1e30``; ``l == 0 ->
    1``; the output is in ``q.dtype``.  Query head h reads KV head
    ``h // (Hq // G)``."""
    B, Hq, Sq, D = q.shape
    _, G, Skv, _ = k.shape
    Dv = v.shape[-1]
    rep = Hq // G
    scale = float(scale if scale is not None else D ** -0.5)
    bk = min(block, Skv)
    nkv = -(-Skv // bk)
    k, v = _pad_seq(k, nkv * bk), _pad_seq(v, nkv * bk)
    dev = q.device
    qf = q.float().reshape(B, G, rep, Sq, D) * scale
    acc = torch.zeros((B, G, rep, Sq, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, G, rep, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, G, rep, Sq), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    with _full_f32():
        for j in range(nkv):
            kb = k[:, :, None, j * bk:(j + 1) * bk].float()  # (B, G, 1, bk, D)
            vb = v[:, :, None, j * bk:(j + 1) * bk].float()
            s = torch.matmul(qf, kb.transpose(-1, -2))  # (B, G, rep, Sq, bk)
            k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
            mask = k_pos < Skv
            if causal:
                mask = mask & (q_pos >= k_pos)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            # the running max shifts the softmax, which does not depend on
            # it: detached, its gradient (zero) keeps no block's scores
            m_new = torch.maximum(m, s.detach().amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vb)
            m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(B, Hq, Sq, Dv).to(q.dtype)


def flash_carry_ref(q, k, v, carry=None, *, q_offset: int = 0, k_offset: int = 0,
                    valid_len: int | None = None, causal: bool = True,
                    scale: float | None = None):
    """Plain version of one carry-state flash step,
    :func:`repro_torch.kernels.flash_attention.flash_attention_carry_cuda`
    (the reference's ``flash_attention_carry_pallas`` and its oracle
    ``flash_carry_ref``): the online-softmax merge of the whole held KV
    block k, v (B, G, Skv, D) into the unnormalized float32 state
    ``carry = (acc (B, Hq, Sq, Dv), m (B, Hq, Sq), l (B, Hq, Sq))`` of the
    resident queries q (B, Hq, Sq, D); ``None`` starts from
    ``(0, -1e30, 0)``.  Query row i sits at global position
    ``q_offset + i`` and key j at ``k_offset + j``; the causal mask is
    ``q_pos >= k_pos`` and keys at ``k_pos >= valid_len`` are masked, with
    ``-1e30``.  q is scaled in float32 first, as the kernel loads it.
    Returns the new ``(acc, m, l)``; differentiable."""
    B, Hq, Sq, D = q.shape
    _, G, Skv, _ = k.shape
    Dv = v.shape[-1]
    rep = Hq // G
    scale = float(scale if scale is not None else D ** -0.5)
    dev = q.device
    if carry is None:
        acc = torch.zeros((B, Hq, Sq, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
    else:
        acc, m, l = (t.float() for t in carry)
    acc = acc.reshape(B, G, rep, Sq, Dv)
    m, l = m.reshape(B, G, rep, Sq), l.reshape(B, G, rep, Sq)
    qf = q.float().reshape(B, G, rep, Sq, D) * scale
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = k_offset + torch.arange(Skv, device=dev)[None, :]
    with _full_f32():
        s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))  # (B, G, rep, Sq, Skv)
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if valid_len is not None:
            mask = mask & (k_pos < valid_len)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.matmul(p, v.float()[:, :, None])
    return (acc_new.reshape(B, Hq, Sq, Dv), m_new.reshape(B, Hq, Sq),
            l_new.reshape(B, Hq, Sq))


def flash_decode_ref(q, k_cache, v_cache, cache_len, *, q_positions=None,
                     scale: float | None = None, block: int = 512):
    """Plain version of :func:`repro_torch.kernels.flash_decode.flash_decode_cuda`
    (the reference's ``flash_decode_pallas``): q (B, Hq, S, D), caches
    (B, G, T, D), ``cache_len`` (B,), ``q_positions`` (B, S) or None.

    The rep = Hq // G query heads stack into rep*S rows per KV group.  The
    cache is padded to a multiple of ``bk = min(block, T)``; for each KV
    block: float32 scores of the float32-scaled q, ``-1e30`` where
    ``k_pos >= min(cache_len, T)`` or ``k_pos > q_positions``, the block's
    own max ``m_j``, ``p = exp(s - m_j)``, ``l_j = sum p`` and
    ``o_j = round(p) @ v`` with p rounded to the cache dtype first.  Then
    the log-sum-exp combine with ``l == 0 -> 1``; output in ``q.dtype``."""
    B, Hq, S, D = q.shape
    _, G, T, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    rep = Hq // G
    RS = rep * S
    scale = float(scale if scale is not None else D ** -0.5)
    bk = min(block, T)
    nb = -(-T // bk)
    k_cache, v_cache = _pad_seq(k_cache, nb * bk), _pad_seq(v_cache, nb * bk)
    dev = q.device
    qg = q.float().reshape(B, G, RS, D) * scale
    valid = torch.clamp(cache_len.to(device=dev, dtype=torch.int64), max=T)[:, None, None, None]
    if q_positions is None:
        pos = torch.full((B, 1, RS, 1), T, dtype=torch.int64, device=dev)
    else:  # row r is query r % S
        pos = q_positions.to(device=dev, dtype=torch.int64).repeat(1, rep)[:, None, :, None]
    oa, om, ol = [], [], []
    with _full_f32():
        for j in range(nb):
            kb = k_cache[:, :, j * bk:(j + 1) * bk].float()
            vb = v_cache[:, :, j * bk:(j + 1) * bk]
            s = torch.matmul(qg, kb.transpose(-1, -2))  # (B, G, RS, bk)
            k_pos = j * bk + torch.arange(bk, device=dev)
            mask = (k_pos < valid) & (k_pos <= pos)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_j = s.amax(dim=-1)
            p = torch.exp(s - m_j[..., None])
            ol.append(p.sum(dim=-1))
            oa.append(torch.matmul(p.to(vb.dtype).float(), vb.float()))
            om.append(m_j)
    oa, om, ol = torch.stack(oa, 2), torch.stack(om, 2), torch.stack(ol, 2)
    m_tot = om.amax(dim=2)  # (B, G, RS)
    w = torch.exp(om - m_tot[:, :, None])
    l_tot = (w * ol).sum(dim=2)
    o = (w[..., None] * oa).sum(dim=2)
    l_tot = torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return (o / l_tot[..., None]).reshape(B, Hq, S, Dv).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Dense softmax attention with GQA head sharing (the reference's jnp
    oracle): q (B, Hq, Sq, D), k/v (B, G, Skv, D); causal is aligned to the
    bottom right (``tril(k=Skv-Sq)``)."""
    B, Hq, Sq, D = q.shape
    _, G, Skv, _ = k.shape
    group = Hq // G
    scale = scale if scale is not None else D ** -0.5
    k = torch.repeat_interleave(k, group, dim=1).float()
    v = torch.repeat_interleave(v, group, dim=1).float()
    with _full_f32():
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
        if causal:
            mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device).tril(Skv - Sq)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *, q_positions=None,
                         scale: float | None = None):
    """Dense decode attention over the cache, all float32 (the reference's
    jnp oracle ``decode_attention_ref``), with the length and per-row
    chunk-causality masks."""
    B, Hq, S, D = q.shape
    _, G, T, _ = k_cache.shape
    rep = Hq // G
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, G, rep, S, D)
    t = torch.arange(T, device=q.device)
    mask = t < torch.clamp(cache_len.to(q.device).long(), max=T).reshape(B, 1, 1, 1, 1)
    if q_positions is not None:
        mask = mask & (t <= q_positions.to(q.device).long().reshape(B, 1, 1, S, 1))
    with _full_f32():
        s = torch.einsum("bgrqd,bgsd->bgrqs", qg, k_cache.float()) * scale
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqs,bgsd->bgrqd", p, v_cache.float())
    return o.reshape(B, Hq, S, v_cache.shape[-1]).to(q.dtype)


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.relayout.transpose_cuda`:
    ``(..., M, N) -> (..., N, M)``, contiguous."""
    return x.transpose(-1, -2).contiguous()
