"""Public entry points of the GEMM kernels.

Each op picks an implementation:
  * ``impl="cuda"`` — the hand-written Hopper kernel (``kernels/gemm.py``),
  * ``impl="ref"``  — the plain PyTorch version (``kernels/ref.py``).

The default follows the operands' device: the kernel for CUDA tensors, the
plain version for CPU tensors.  A CUDA tensor never falls back to the plain
version: the kernel launches or raises.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .gemm import check_gemm, check_panel, gemm_cuda, gemm_panel_cuda

__all__ = ["default_impl", "gemm", "gemm_panel"]


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
