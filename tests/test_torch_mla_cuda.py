"""The flash-attention kernel's (96, 64) instances (MLA's forward: q/k of
d_nope + d_rope = 96, v of d_v = 64) against their plain PyTorch version,
on the card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run
``pytest tests/test_torch_mla_cuda.py``.  Tolerances: float32
``rtol=atol=2e-4`` (float32 sums in another order); bfloat16
``rtol=atol=1e-2`` (one bf16 ulp of the output on top of that); the MLA
forward's bf16 logits ``5e-2`` (two layers of such outputs).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.set_float32_matmul_precision(prev)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 8, 8, 300, 300, True),    # MHA as MLA runs it, ragged key tile
    (2, 6, 2, 77, 77, True),      # ragged row and key tiles, GQA 3
    (2, 8, 1, 33, 100, False),    # Sq != Skv, non-causal, one KV head
])
def test_flash_attention_96_64_matches_plain_version(cuda, shape, dtype):
    B, Hq, G, Sq, Skv, causal = shape
    q = _randn((B, Hq, Sq, 96), dtype, cuda, 0)
    k = _randn((B, G, Skv, 96), dtype, cuda, 1)
    v = _randn((B, G, Skv, 64), dtype, cuda, 2)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    assert got.shape == (B, Hq, Sq, 64) and got.dtype == dtype
    want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))  # deterministic


def test_flash_attention_96_64_reads_strided_views(cuda):
    """v as MLA's projection gives it: a (B, S, H, 64) buffer seen through a
    transposed view."""
    q = _randn((1, 4, 130, 96), torch.bfloat16, cuda, 3)
    k = _randn((1, 4, 130, 96), torch.bfloat16, cuda, 4)
    v = _randn((1, 130, 4, 64), torch.bfloat16, cuda, 5).transpose(1, 2)
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = ops.flash_attention(q, k, v.contiguous(), impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_other_head_dim_pairs_are_refused(cuda):
    """The forward takes (64, 64), (128, 128) and (96, 64); the carry form
    one head dim for q, k and v."""
    q = _randn((1, 2, 8, 96), torch.bfloat16, cuda, 6)
    v = _randn((1, 2, 8, 64), torch.bfloat16, cuda, 7)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(v, v, q)
    with pytest.raises(ValueError, match="v head dim 64 != q/k head dim 96"):
        ops.flash_attention_carry(q, q, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_forward_runs_the_kernel_and_matches_plain_path(cuda, dtype):
    """minicpm3's attention dims (40 heads cut to 4, d_model to 256, 2
    layers): one kernel launch a layer, logits close to the plain path's."""
    cfg = dataclasses.replace(configs.get("minicpm3-4b"), n_layers=2, d_model=256, n_heads=4,
                              n_kv=4, d_ff=512, vocab=1000, act_dtype=dtype)
    params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 200), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    before = fa.flash_attention_cuda.launches
    got, _ = lm.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + cfg.n_layers
    want, _ = lm.forward(params, {"tokens": tokens}, dataclasses.replace(cfg, attn_impl="ref"))
    tol = 5e-2 if dtype == torch.bfloat16 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
