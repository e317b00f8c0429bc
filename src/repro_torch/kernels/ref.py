"""Plain PyTorch versions of the GEMM kernels (the correctness ground truth).

Each function mirrors its kernel's semantics exactly, written with plain
tensor ops so it runs on any device and is obviously correct.  The CPU runs
of the comm layer use these; on the card, ``chip_smoke.py`` holds each
kernel against them.  Products are taken in float32 with TF32 off.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["gemm_ref", "gemm_panel_ref"]


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
