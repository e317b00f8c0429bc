"""Public entry points of the port's kernels.

Each op picks an implementation:
  * ``impl="cuda"`` — the hand-written Hopper kernel (``kernels/gemm.py``,
    ``kernels/flash_attention.py``, ``kernels/flash_decode.py``,
    ``kernels/relayout.py``),
  * ``impl="ref"``  — the plain PyTorch version (``kernels/ref.py``).

The default follows the operands' device: the kernel for CUDA tensors (and
for the fake tensors of a trace of the card's program,
:func:`repro_torch.kernels.fake.on_card`), the plain version for CPU
tensors.  A CUDA tensor never falls back to the plain
version: the kernel launches or raises.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .fake import on_card
from .flash_attention import (check_attention, check_carry, flash_attention_carry_cuda,
                              flash_attention_cuda)
from .flash_decode import check_decode, flash_decode_cuda
from .gemm import (check_dtypes, check_gemm, check_panel, gemm_bf16_cuda, gemm_cuda,
                   gemm_panel_bf16_cuda, gemm_panel_cuda)
from .relayout import check_transpose, transpose_cuda

__all__ = ["default_impl", "gemm", "gemm_panel", "flash_attention", "flash_attention_carry",
           "flash_decode", "transpose_tiled"]


# the profiler range around the attention backward's recompute through the
# plain versions, which a device-time breakdown reads
RECOMPUTE_RANGE = "attn.recompute"


def default_impl(x: torch.Tensor) -> str:
    return "cuda" if on_card(x) else "ref"


def gemm(a, b, acc=None, *, majors: str = "I/I/K", impl: str | None = None, out_dtype=None):
    """``C = A @ B (+ acc)`` with per-operand physical orientation.

    ``a``/``b`` are the *buffers* (already in their physical layout); the
    ``majors`` string says how to read them, e.g. ``"J/K/J"``: C j-major
    (buffer (j, i)), A k-major (buffer (k, i)), B j-major (buffer (j, k)).
    ``acc``, if given, is a previous C buffer (same orientation as the
    output) added after the product.  Any M, N, K works; every buffer must
    be contiguous.  The output is ``out_dtype or a.dtype``.  On the card A
    and B are float32 or bfloat16, of one dtype (:func:`check_dtypes`
    raises ``TypeError`` otherwise), and bf16 operands take the bf16
    kernel.
    """
    check_gemm(a, b, acc, majors)
    impl = impl or default_impl(a)
    if impl == "ref":
        return _ref.gemm_ref(a, b, acc, majors=majors, out_dtype=out_dtype)
    if impl == "cuda":
        bf16 = check_dtypes(a, b, acc, out_dtype) == torch.bfloat16
        return (gemm_bf16_cuda if bf16 else gemm_cuda)(a, b, acc, majors=majors,
                                                       out_dtype=out_dtype)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")


def gemm_panel(a, b, panel, jb, *, majors: str = "I/I/K", impl: str | None = None):
    """Rotating-accumulator SUMMA inner step: ``panel[j-block jb] += A @ B``,
    in place; returns the panel.

    ``panel`` spans ``nb`` j-blocks of width N (the logical j extent of
    ``b``) in the C orientation of ``majors``; ``jb`` is an int or a
    one-element int32 tensor on the operands' device.  The block is added
    to in float32 and rounded once to the panel's dtype; dtypes on the card
    as for :func:`gemm`.
    """
    check_panel(a, b, panel, majors)
    impl = impl or default_impl(a)
    if impl == "ref":
        return _ref.gemm_panel_ref(a, b, panel, jb, majors=majors)
    if impl == "cuda":
        bf16 = check_dtypes(a, b, panel) == torch.bfloat16
        return (gemm_panel_bf16_cuda if bf16 else gemm_panel_cuda)(a, b, panel, jb,
                                                                   majors=majors)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")


class _FlashAttention(torch.autograd.Function):
    """The single-shot attention with a gradient: the forward is the kernel;
    the backward recomputes the attention through its plain version under
    ``torch.autograd`` and pulls the cotangent back, as :class:`_CarryStep`
    does for a ring step (the reference's ``_carry_step_vjp`` design: the
    reference has no backward kernel).  ``kw`` (causal, scale, the plain
    version's block) gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return flash_attention_cuda(q, k, v, causal=kw["causal"], scale=kw["scale"])

    @staticmethod
    def backward(ctx, d_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad(), torch.profiler.record_function(RECOMPUTE_RANGE):
            out = _ref.flash_attention_ref(*inputs, **ctx.kw)
            grads = torch.autograd.grad(out, inputs, d_out)
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    block: int = 512, impl: str | None = None):
    """Blockwise online-softmax attention of q (B, Hq, Sq, D) over k
    (B, G, Skv, D) and v (B, G, Skv, Dv), returning (B, Hq, Sq, Dv): the
    reference's ``flash_attention_pallas``.  Causal is top-left aligned.
    ``block`` is the plain version's KV block (the result does not depend
    on it beyond float32 rounding).

    On the card, when a gradient is wanted (grad mode on and q, k or v
    requiring grad) the kernel runs inside :class:`_FlashAttention`, whose
    backward recomputes through the plain version; the kernel's own result
    carries no autograd history."""
    check_attention(q, k, v)
    impl = impl or default_impl(q)
    if impl == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale, block=block)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, dict(causal=causal, scale=scale, block=block))
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


class _CarryStep(torch.autograd.Function):
    """One carry step with a gradient: the forward is the kernel, writing
    into fresh copies of the carry; the backward recomputes the step
    through its plain version under ``torch.autograd`` (the reference's
    ``_carry_step_vjp``).  The offsets and ``valid_len`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, acc, m, l, kw):
        ctx.save_for_backward(q, k, v, acc, m, l)
        ctx.kw = kw
        carry = tuple(t.detach().clone() for t in (acc, m, l))
        return flash_attention_carry_cuda(q, k, v, carry, **kw)

    @staticmethod
    def backward(ctx, d_acc, d_m, d_l):
        inputs = [t.detach().requires_grad_(t.is_floating_point())
                  for t in ctx.saved_tensors]
        with torch.enable_grad(), torch.profiler.record_function(RECOMPUTE_RANGE):
            q, k, v, acc, m, l = inputs
            out = _ref.flash_carry_ref(q, k, v, (acc, m, l), **ctx.kw)
            pairs = [(o, g) for o, g in zip(out, (d_acc, d_m, d_l)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                        [g for _, g in pairs], allow_unused=True)
        return (*grads, None)


def flash_attention_carry(q, k, v, carry=None, *, q_offset: int = 0, k_offset: int = 0,
                          valid_len: int | None = None, causal: bool = True,
                          scale: float | None = None, impl: str | None = None):
    """One carry-state flash step (a ring step of the sequence-parallel
    attention): the resident queries q (B, Hq, Sq, D), at global positions
    ``q_offset + i``, against the held KV block k (B, G, Skv, D) and v
    (B, G, Skv, Dv), at ``k_offset + j``, threading the unnormalized float32
    state ``carry = (acc (B, Hq, Sq, Dv), m, l)`` (``None`` starts from
    ``(0, -1e30, 0)``).  Keys at or past ``valid_len`` are masked.  Returns
    the new ``(acc, m, l)``; the caller normalizes ``acc / l`` after the
    last step.  The card takes the ``(D, Dv)`` pairs of
    :data:`repro_torch.kernels.flash_attention.CARRY_HEAD_DIMS`; the plain
    version any.

    On the card the kernel updates the carry **in place** (a carry not
    already float32 and contiguous is copied first); when a gradient is
    wanted it writes fresh tensors instead and differentiates through
    :class:`_CarryStep`."""
    B, Hq, _, Sq, _, _ = check_attention(q, k, v)
    Dv = v.shape[-1]
    if carry is not None:
        check_carry(carry, B, Hq, Sq, Dv)
    impl = impl or default_impl(q)
    kw = dict(q_offset=int(q_offset), k_offset=int(k_offset), valid_len=valid_len,
              causal=causal, scale=scale)
    if impl == "ref":
        return _ref.flash_carry_ref(q, k, v, carry, **kw)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")
    if carry is None:
        carry = (torch.zeros((B, Hq, Sq, Dv), dtype=torch.float32, device=q.device),
                 torch.full((B, Hq, Sq), _ref.NEG_INF, dtype=torch.float32, device=q.device),
                 torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device))
    else:
        carry = tuple(t.to(torch.float32).contiguous() for t in carry)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, *carry)):
        return _CarryStep.apply(q, k, v, *carry, kw)
    return flash_attention_carry_cuda(q, k, v, carry, **kw)


def flash_decode(q, k_cache, v_cache, cache_len, *, q_positions=None,
                 scale: float | None = None, block: int = 512, impl: str | None = None):
    """Split-KV decode attention of q (B, Hq, S, D) over the caches k
    (B, G, T, D) and v (B, G, T, Dv), returning (B, Hq, S, Dv): the
    reference's ``flash_decode_pallas`` with its log-sum-exp combine.
    ``block`` is the KV block whose own max each block's probabilities are
    rounded against (part of the function).  The card takes the ``(D, Dv)``
    pairs of :data:`repro_torch.kernels.flash_decode.DECODE_HEAD_DIMS`; the
    plain version any."""
    check_decode(q, k_cache, v_cache, cache_len, q_positions)
    impl = impl or default_impl(q)
    if impl == "ref":
        return _ref.flash_decode_ref(q, k_cache, v_cache, cache_len, q_positions=q_positions,
                                     scale=scale, block=block)
    if impl == "cuda":
        return flash_decode_cuda(q, k_cache, v_cache, cache_len, q_positions=q_positions,
                                 scale=scale, block=block)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")


def transpose_tiled(x, *, bm: int = 256, bn: int = 256, impl: str | None = None):
    """Batched last-two-axes transpose ``(..., M, N) -> (..., N, M)``,
    bitwise: the reference's ``transpose_tiled_pallas``.  Raises
    ``ValueError`` when M or N does not divide the reference's tile
    ``(min(bm, M), min(bn, N))``."""
    check_transpose(x, bm, bn)
    impl = impl or default_impl(x)
    if impl == "ref":
        return _ref.transpose_ref(x)
    if impl == "cuda":
        return transpose_cuda(x)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")
