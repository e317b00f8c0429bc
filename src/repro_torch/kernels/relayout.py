"""The tiled-transpose kernel for Hopper and its wrapper.

``csrc/transpose.cu`` replaces the reference's Pallas kernel
``transpose_tiled_pallas`` (``src/repro/kernels/relayout.py``): the batched
last-two-axes transpose ``(..., M, N) -> (..., N, M)``, the canonical shape
of a relayout plan that permutes a tile's two minor axes.  It moves data
only, so the output is bitwise the input's, for every dtype of 1, 2, 4 or 8
bytes.  Its plain version is :func:`repro_torch.kernels.ref.transpose_ref`.

The reference tiles the TPU's VMEM with ``(bm, bn)`` blocks (256 x 256 by
default) and refuses shapes whose last two axes do not divide them;
:func:`check_transpose` raises the same ``ValueError`` for both routes of
:func:`repro_torch.kernels.ops.transpose_tiled`.  The kernel's own tile is
32 x 32 and takes any shape.  ``transpose_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .fake import is_fake, on_card, report
from .flash_attention import refuse_grad
from .work import transpose_work

__all__ = ["transpose_cuda", "check_transpose", "load_library"]

ELEMENT_SIZES = (1, 2, 4, 8)


def check_transpose(x: torch.Tensor, bm: int = 256, bn: int = 256) -> tuple[int, int, int]:
    """``(batch, M, N)`` of a transpose of ``x``; raises ``ValueError`` where
    the reference's ``transpose_tiled_pallas`` does: when the last two axes
    do not divide the tile ``(min(bm, M), min(bn, N))``."""
    if x.ndim < 2:
        raise ValueError(f"transpose needs at least two axes, got shape {tuple(x.shape)}")
    *lead, M, N = x.shape
    bm_, bn_ = min(bm, M), min(bn, N)
    if bm_ <= 0 or bn_ <= 0 or M % bm_ or N % bn_:
        raise ValueError(f"({M},{N}) must divide tile ({bm_},{bn_})")
    return math.prod(lead), M, N


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    lib = build.load("transpose")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.transpose_fwd.argtypes = [p, p, i, ctypes.c_longlong, i, i, p]
    lib.transpose_fwd.restype = i
    lib.transpose_error_string.argtypes = [i]
    lib.transpose_error_string.restype = ctypes.c_char_p
    return lib


def transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    """``(..., M, N) -> (..., N, M)`` on the card, contiguous, bitwise; a
    non-contiguous ``x`` is made contiguous first."""
    refuse_grad("transpose_kernel", x=x)
    if not on_card(x):
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.element_size() not in ELEMENT_SIZES:
        raise TypeError(f"the kernel moves elements of {ELEMENT_SIZES} bytes, got {x.dtype}")
    *lead, M, N = x.shape
    batch = math.prod(lead)
    out = torch.empty((*lead, N, M), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    if is_fake(x):  # stands for the launch (kernels/fake.py)
        report("transpose_kernel", (x,), (out,), transpose_work(x.numel(), x.element_size()))
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.transpose_fwd(x.data_ptr(), out.data_ptr(), x.element_size(), batch, M, N, stream)
    if code != 0:
        msg = lib.transpose_error_string(code).decode()
        raise RuntimeError(f"transpose_kernel launch failed: {msg} (cudaError {code})")
    transpose_cuda.launches += 1  # type: ignore[attr-defined]
    return out


transpose_cuda.launches = 0  # type: ignore[attr-defined]
