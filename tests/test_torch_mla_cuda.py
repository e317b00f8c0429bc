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
    """The forward and the carry form take (64, 64), (128, 128), (112, 112)
    and (96, 64), and neither (64, 96)."""
    q = _randn((1, 2, 8, 96), torch.bfloat16, cuda, 6)
    v = _randn((1, 2, 8, 64), torch.bfloat16, cuda, 7)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(v, v, q)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention_carry(v, v, q)


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


def _state(B, Hq, Sq, Dv, device, tail=0):
    """An empty carry state whose acc heads a buffer of ``tail`` sentinels."""
    n = B * Hq * Sq * Dv
    buf = torch.full((n + tail,), 7.5, device=device)
    buf[:n] = 0.0
    return (buf[:n].view(B, Hq, Sq, Dv), torch.full((B, Hq, Sq), -1e30, device=device),
            torch.zeros((B, Hq, Sq), device=device)), buf[n:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, Hq, G, Sq, Skv, q_offset, k_offset, valid_len, causal)
    (1, 8, 8, 128, 128, 128, 128, None, True),    # a diagonal ring step
    (1, 8, 8, 128, 128, 256, 0, None, True),      # an off-diagonal one
    (2, 6, 2, 77, 100, 64, 0, 150, True),         # ragged tiles, GQA 3, padded keys
    (1, 4, 1, 33, 70, 0, 0, None, False),         # non-causal, one KV head
])
def test_carry_96_64_matches_plain_version(cuda, case, dtype):
    """The carry form's (96, 64) instance from a nonzero state, against its
    plain version in acc, m and l; the state is (B, Hq, Sq, 64), and the
    sentinels after its last row stay untouched."""
    B, Hq, G, Sq, Skv, q_off, k_off, valid, causal = case
    q = _randn((B, Hq, Sq, 96), dtype, cuda, 10)
    k = _randn((B, G, Skv, 96), dtype, cuda, 11)
    v = _randn((B, G, Skv, 64), dtype, cuda, 12)
    kw = dict(q_offset=q_off, k_offset=k_off, valid_len=valid, causal=causal)
    start = ops.flash_attention_carry(q, _randn((B, G, 40, 96), dtype, cuda, 13),
                                      _randn((B, G, 40, 64), dtype, cuda, 14), None,
                                      impl="ref", k_offset=0, causal=False)
    want = ops.flash_attention_carry(q, k, v, start, impl="ref", **kw)
    state, tail = _state(B, Hq, Sq, 64, cuda, tail=1024)
    for t, s in zip(state, start):
        t.copy_(s)
    before = fa.flash_attention_carry_cuda.launches
    got = ops.flash_attention_carry(q, k, v, state, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_carry_cuda.launches == before + 1
    assert got[0].shape == (B, Hq, Sq, 64)
    assert bool((tail == 7.5).all()), "the kernel wrote past the state's 64 columns"
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_carry_96_64_chain_is_bitwise_the_forward(cuda, causal, dtype):
    """Carry steps over 4 KV chunks of 128 keys in block order, and one step
    over the whole sequence, normalized as the ring's epilogue does, equal
    the (96, 64) forward instance bitwise."""
    q = _randn((1, 8, 512, 96), dtype, cuda, 20)
    k = _randn((1, 8, 512, 96), dtype, cuda, 21)
    v = _randn((1, 8, 512, 64), dtype, cuda, 22)
    single = ops.flash_attention(q, k, v, causal=causal)
    for chunks in (4, 1):
        n = 512 // chunks
        carry = None
        for c in range(chunks):
            carry = ops.flash_attention_carry(q, k[:, :, c * n:(c + 1) * n],
                                              v[:, :, c * n:(c + 1) * n], carry, k_offset=c * n,
                                              causal=causal)
        acc, _, l = carry
        got = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, single), (chunks, (got.float() - single.float()).abs().max())
