"""Public entry points of the port's kernels.

Each op picks an implementation:
  * ``impl="cuda"`` — the hand-written Hopper kernel (``kernels/gemm.py``,
    ``kernels/flash_attention.py``, ``kernels/flash_decode.py``),
  * ``impl="ref"``  — the plain PyTorch version (``kernels/ref.py``).

The default follows the operands' device: the kernel for CUDA tensors, the
plain version for CPU tensors.  A CUDA tensor never falls back to the plain
version: the kernel launches or raises.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .flash_attention import check_attention, flash_attention_cuda
from .flash_decode import check_decode, flash_decode_cuda
from .gemm import check_gemm, check_panel, gemm_cuda, gemm_panel_cuda

__all__ = ["default_impl", "gemm", "gemm_panel", "flash_attention", "flash_decode"]


def default_impl(x: torch.Tensor) -> str:
    return "cuda" if x.is_cuda else "ref"


def gemm(a, b, acc=None, *, majors: str = "I/I/K", impl: str | None = None, out_dtype=None):
    """``C = A @ B (+ acc)`` with per-operand physical orientation.

    ``a``/``b`` are the *buffers* (already in their physical layout); the
    ``majors`` string says how to read them, e.g. ``"J/K/J"``: C j-major
    (buffer (j, i)), A k-major (buffer (k, i)), B j-major (buffer (j, k)).
    ``acc``, if given, is a previous C buffer (same orientation as the
    output) added after the product.  Any M, N, K works; every buffer must
    be contiguous.
    """
    check_gemm(a, b, acc, majors)
    impl = impl or default_impl(a)
    if impl == "ref":
        return _ref.gemm_ref(a, b, acc, majors=majors, out_dtype=out_dtype)
    if impl == "cuda":
        return gemm_cuda(a, b, acc, majors=majors, out_dtype=out_dtype)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")


def gemm_panel(a, b, panel, jb, *, majors: str = "I/I/K", impl: str | None = None):
    """Rotating-accumulator SUMMA inner step: ``panel[j-block jb] += A @ B``,
    in place; returns the panel.

    ``panel`` spans ``nb`` j-blocks of width N (the logical j extent of
    ``b``) in the C orientation of ``majors``; ``jb`` is an int or a
    one-element int32 tensor on the operands' device.
    """
    check_panel(a, b, panel, majors)
    impl = impl or default_impl(a)
    if impl == "ref":
        return _ref.gemm_panel_ref(a, b, panel, jb, majors=majors)
    if impl == "cuda":
        return gemm_panel_cuda(a, b, panel, jb, majors=majors)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    block: int = 512, impl: str | None = None):
    """Blockwise online-softmax attention of q (B, Hq, Sq, D) over k, v
    (B, G, Skv, D): the reference's ``flash_attention_pallas``.  Causal is
    top-left aligned.  ``block`` is the plain version's KV block (the
    result does not depend on it beyond float32 rounding)."""
    check_attention(q, k, v)
    impl = impl or default_impl(q)
    if impl == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale, block=block)
    if impl == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")


def flash_decode(q, k_cache, v_cache, cache_len, *, q_positions=None,
                 scale: float | None = None, block: int = 512, impl: str | None = None):
    """Split-KV decode attention over the cache: the reference's
    ``flash_decode_pallas`` with its log-sum-exp combine.  ``block`` is the
    KV block whose own max each block's probabilities are rounded against
    (part of the function)."""
    check_decode(q, k_cache, v_cache, cache_len, q_positions)
    impl = impl or default_impl(q)
    if impl == "ref":
        return _ref.flash_decode_ref(q, k_cache, v_cache, cache_len, q_positions=q_positions,
                                     scale=scale, block=block)
    if impl == "cuda":
        return flash_decode_cuda(q, k_cache, v_cache, cache_len, q_positions=q_positions,
                                 scale=scale, block=block)
    raise ValueError(f"unknown impl {impl!r} (use 'cuda' or 'ref')")
