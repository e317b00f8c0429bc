"""The work of the port's kernels: ``(flops, bytes, seconds at peak)`` of
one launch, from its shapes.

A kernel wrapper given fake tensors reports this work for the launch it
stands for (:func:`repro_torch.kernels.fake.report`), and the dry run's
roofline (:mod:`repro_torch.launch.roofline`) charges it.  The formulas are
``chip_smoke.py``'s ``bound`` and ``attn_bound``: the bytes of each input
read once and each output written once, the operations the kernel's
tensor-core products do.

The peak rates are NVIDIA's data sheet for **NVIDIA H100 80GB HBM3 (SXM),
power limit 700.00 W**, dense: a card set below 700 W runs slower than
this says, and every time built on them is a prediction for that card.
"""
from __future__ import annotations

import torch

__all__ = ["BF16_FLOPS", "TF32_FLOPS", "FP32_FLOPS", "HBM_BW", "SPLIT_PRODUCTS",
           "peak_seconds", "causal_pairs", "gemm_work", "flash_attention_work",
           "flash_carry_work", "flash_decode_work", "transpose_work"]

# NVIDIA H100 80GB HBM3 (SXM) at 700.00 W, data sheet (dense rates)
BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
HBM_BW = 3.35e12  # bytes/s
SPLIT_PRODUCTS = 3  # the float32 GEMM kernels' split TF32: three TF32 products

# seconds one operation takes at the peak of each operation class
_PER_OP = {
    torch.bfloat16: 1 / BF16_FLOPS,
    torch.float16: 1 / BF16_FLOPS,
    "split_tf32": SPLIT_PRODUCTS / TF32_FLOPS,
}


def peak_seconds(flops: float, kind) -> float:
    """The least time ``flops`` operations of ``kind`` take: a dtype (bf16
    and fp16 on the tensor cores, anything else on the CUDA cores at the
    float32 rate) or ``"split_tf32"`` (the float32 GEMM kernels' three TF32
    products per operation)."""
    return flops * _PER_OP.get(kind, 1 / FP32_FLOPS)


def gemm_work(m: int, n: int, k: int, *, acc: bool, dtype=torch.float32, out_bytes: int = 4,
              acc_bytes: int = 4) -> tuple[float, float]:
    """``(flops, bytes)`` of ``C = A @ B (+ acc)``: 2mnk (+ mn for the acc)
    operations; A and B read once in ``dtype``, acc read and C written
    once."""
    nbytes = (torch.finfo(dtype).bits // 8 * (m * k + k * n) + out_bytes * m * n
              + (acc_bytes * m * n if acc else 0))
    return float(2 * m * n * k + (m * n if acc else 0)), float(nbytes)


def causal_pairs(Sq: int, Skv: int, shift: int = 0) -> int:
    """Visible (query, key) pairs of a causal block: query ``i`` sees keys
    ``j < Skv`` with ``j <= i + shift`` (``shift`` = the query block's
    offset minus the key block's)."""
    if Skv <= 0 or Sq <= 0:
        return 0
    # sum over i < Sq of clamp(i + shift + 1, 0, Skv)
    lo = max(0, -shift)  # the first query that sees a key
    full = max(lo, Skv - shift - 1)  # the first query that sees every key
    a, b = lo, min(Sq, full)
    rising = (b - a) * (a + b - 1) // 2 + (b - a) * (shift + 1) if b > a else 0
    return rising + max(0, Sq - full) * Skv


def _attn_ops(pairs: int, D: int, Dv: int, dtype, pieces: int) -> tuple[float, float]:
    """``(flops, seconds at peak)`` of ``pairs`` (query, key) pairs: q k^T
    and p @ v, 2 operations a multiply-add; the bf16 body runs p @ v once
    per piece of p on the tensor cores, the float32 body both products on
    the CUDA cores."""
    qk, pv = 2.0 * pairs * D, 2.0 * pairs * Dv
    if dtype == torch.bfloat16:
        return qk + pv, (qk + pieces * pv) / BF16_FLOPS
    return qk + pv, (qk + pv) / FP32_FLOPS


def flash_attention_work(B: int, Hq: int, G: int, Sq: int, Skv: int, D: int, Dv: int, *,
                         causal: bool, dtype, pieces: int) -> tuple[float, float, float]:
    """``(flops, bytes, seconds at peak)`` of one forward launch: every
    visible pair of every head (top-left aligned causal mask), q and the
    output once, k and v once."""
    pairs = B * Hq * (causal_pairs(Sq, Skv) if causal else Sq * Skv)
    flops, secs = _attn_ops(pairs, D, Dv, dtype, pieces)
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (B * Hq * Sq * (D + Dv) + B * G * Skv * (D + Dv))
    return flops, float(nbytes), secs


def flash_carry_work(B: int, Hq: int, G: int, Sq: int, Skv: int, D: int, Dv: int, *,
                     q_offset: int, k_offset: int, valid_len: int | None, causal: bool,
                     dtype, pieces: int) -> tuple[float, float, float]:
    """``(flops, bytes, seconds at peak)`` of one ring step: the visible
    pairs of the held block (keys at or past ``valid_len`` masked), q, k
    and v once, the float32 state ``(acc, m, l)`` read and written."""
    keys = Skv if valid_len is None else max(0, min(Skv, valid_len - k_offset))
    pairs = B * Hq * (causal_pairs(Sq, keys, q_offset - k_offset) if causal else Sq * keys)
    flops, secs = _attn_ops(pairs, D, Dv, dtype, pieces)
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (B * Hq * Sq * D + B * G * Skv * (D + Dv)) + 2 * 4 * B * Hq * Sq * (Dv + 2)
    return flops, float(nbytes), secs


def flash_decode_work(B: int, Hq: int, G: int, S: int, visible: int, keys: int, D: int,
                      Dv: int, *, dtype, pieces: int = 1) -> tuple[float, float, float]:
    """``(flops, bytes, seconds at peak)`` of one decode launch:
    ``visible`` (query, key) pairs over all rows and queries of a head
    group, the ``keys`` cached keys and values of all rows read once, q
    read and the output written once."""
    flops, secs = _attn_ops(Hq * visible, D, Dv, dtype, pieces)
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (G * (D + Dv) * keys + B * Hq * S * (D + Dv))
    return flops, float(nbytes), secs


def transpose_work(numel: int, itemsize: int) -> tuple[float, float, float]:
    """``(0, bytes, 0)`` of a transpose: each element read and written."""
    return 0.0, float(2 * numel * itemsize), 0.0
