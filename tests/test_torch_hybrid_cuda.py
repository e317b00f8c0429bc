"""The flash-attention and flash-decode kernels at zamba2-7b's head dim of
112 against their plain versions, and a small hybrid model through them,
on the card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run
``pytest tests/test_torch_hybrid_cuda.py``.  Tolerances are
``tests/test_torch_attention_cuda.py``'s: float32 ``rtol=atol=2e-4``
(float32 sums in another order); bfloat16 ``rtol=atol=1e-2`` (one bf16 ulp
of the output on top of that).  The small model's bf16 logits through 13
layers are held to ``0.25`` (``chip_smoke.py``'s ``LOGIT_TOL``), and its
float32 greedy tokens exactly.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
D = 112


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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 4, 300, 300), (2, 8, 2, 130, 200)])
def test_flash_attention_112_matches_plain_version(cuda, shape, causal, dtype):
    """The (112, 112) instance: MHA with ragged 300-row tiles, and GQA 4
    with Sq != Skv; q, k and v as the model's transposed projection views
    (strided, no copy)."""
    B, Hq, G, Sq, Skv = shape
    q = _randn((B, Sq, Hq, D), dtype, cuda, 1).transpose(1, 2)
    k = _randn((B, Skv, G, D), dtype, cuda, 2).transpose(1, 2)
    v = _randn((B, Skv, G, D), dtype, cuda, 3).transpose(1, 2)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
    assert got.shape == (B, Hq, Sq, D) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mha_step", "wrapped_ring", "chunk"])
def test_flash_decode_112_matches_plain_version(cuda, case, dtype):
    """D = 112 decode: an MHA step (rep = 1: one live row in a 16-row tile)
    with an idle slot, over several splits; a ring-buffer cache whose
    lengths pass T (every slot valid, ``q_positions >= T``); and a 24-token
    chunk of GQA 4 (96 stacked rows: the 64-row tile)."""
    B, T = 4, 1000
    Hq, G, S = (8, 8, 1) if case != "chunk" else (8, 2, 24)
    cache = _randn((2, B, G, T, D), dtype, cuda, 4)
    q = _randn((B, Hq, S, D), dtype, cuda, 5)
    pos = None
    if case == "mha_step":
        lens = torch.tensor([1000, 333, 0, 64], dtype=torch.int32, device=cuda)
    elif case == "wrapped_ring":
        lens = torch.tensor([1001, 1999, 4096, 1000], dtype=torch.int32, device=cuda)
        pos = (lens - 1)[:, None]
    else:
        start = torch.tensor([0, 500, 976, 100], dtype=torch.int32, device=cuda)
        lens = start + S
        pos = start[:, None] + torch.arange(S, dtype=torch.int32, device=cuda)[None]
    got = fd.flash_decode_cuda(q, cache[0], cache[1], lens, q_positions=pos, block=256)
    torch.cuda.synchronize()
    want = ops.flash_decode(q, cache[0], cache[1], lens, q_positions=pos, block=256, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_smem_bytes_at_112(cuda):
    """The library's plan at 112 is the wrapper's formula (two 64-column
    boxes a row, V's float32 tile padded to 128), and its largest plans
    launch and agree with the plain version; a head dim with no instance
    gets -1, not another instance's size."""
    lib = fd.load_library()
    for tr in (1, 4):
        for bk in (32, 128, 300, 512, 1024):
            assert lib.flash_decode_smem_bytes(D, tr, bk, D) == fd.smem_bytes(D, tr, bk)
            assert (lib.flash_decode_smem_bytes(D, tr, bk, D)
                    >= lib.flash_decode_smem_bytes(64, tr, bk, 64))
    assert lib.flash_decode_smem_bytes(96, 1, 512, 96) == -1
    for dtype in (torch.float32, torch.bfloat16):
        cache = _randn((2, 2, 4, 1024, D), dtype, cuda, 6)
        q = _randn((2, 16, 8, D), dtype, cuda, 7)  # GQA 4 x 8 queries: 32 rows
        lens = torch.tensor([1024, 700], dtype=torch.int32, device=cuda)
        got = fd.flash_decode_cuda(q, cache[0], cache[1], lens, block=1024)
        want = ops.flash_decode(q, cache[0], cache[1], lens, block=1024, impl="ref")
        torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_carry_form_refuses_112(cuda, dtype):
    """The carry form's (112, 112) instance, once refused, against its plain
    version: zamba2's ring step shapes cut to 2 heads and chunks of 320
    keys (ragged 64-key tiles), a diagonal and an off-diagonal step from a
    nonzero state with a ragged ``valid_len``; the state's columns past
    112 of the next row are never written (the bytes past the state stay
    as they were)."""
    B, H, Sl = 1, 2, 320
    q = _randn((B, H, 2 * Sl, D), dtype, cuda, 8)
    k, v = _randn((B, H, 2 * Sl, D), dtype, cuda, 9), _randn((B, H, 2 * Sl, D), dtype, cuda, 10)
    qr = q[:, :, Sl:]
    state = ops.flash_attention_carry(qr, k[:, :, :Sl], v[:, :, :Sl], None, q_offset=Sl,
                                      k_offset=0, impl="ref")
    for k_off in (0, Sl):  # off-diagonal, then diagonal
        kw = dict(q_offset=Sl, k_offset=k_off, valid_len=2 * Sl - 37, causal=True)
        blk = slice(k_off, k_off + Sl)
        want = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], state, impl="ref", **kw)
        acc = torch.full((B * H * Sl * D + 64,), 7.0, device=cuda)  # a guard past the state
        acc[:-64].copy_(state[0].reshape(-1))
        carry = (acc[:-64].view(B, H, Sl, D), state[1].clone(), state[2].clone())
        before = fa.flash_attention_carry_cuda.launches
        got = fa.flash_attention_carry_cuda(qr, k[:, :, blk], v[:, :, blk], carry, **kw)
        torch.cuda.synchronize()
        assert fa.flash_attention_carry_cuda.launches == before + 1
        assert bool((acc[-64:] == 7.0).all())
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])
        state = want


def _small_zamba(cuda, act=torch.bfloat16):
    """zamba2's SMOKE config at head dim 112 (the card's attention kernels
    take no 16), seeded weights on the card."""
    cfg = dataclasses.replace(configs.get("zamba2-7b", smoke=True), head_dim=D, act_dtype=act)
    params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    return cfg, params


def test_small_hybrid_forward_runs_the_112_kernel(cuda):
    """A 2 x 64 forward: 2 launches of the (112, 112) instance (one a shared
    application), logits against the same forward through the plain
    version."""
    cfg, params = _small_zamba(cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        before = fa.flash_attention_cuda.launches
        got, _ = lm.forward(params, {"tokens": toks}, cfg)
        assert fa.flash_attention_cuda.launches - before == 2
        want, _ = lm.forward(params, {"tokens": toks},
                             dataclasses.replace(cfg, attn_impl="ref"))
    assert float((got.float() - want.float()).abs().max()) <= 0.25


def test_small_hybrid_serves_through_the_112_decode_kernel(cuda):
    """5 requests on 2 slots of 96 positions against the window of 64 (a
    slot reused, a request wrapping the ring buffer): greedy tokens equal
    the same engine's through the plain versions, 2 decode launches a
    step.  float32 activations (the kernels' float32 bodies), so that no
    near tie of two logits can part the runs."""
    cfg, params = _small_zamba(cuda, torch.float32)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(2, 500, (int(n),), generator=g).tolist()
               for n in torch.randint(40, 71, (5,), generator=g)]
    runs = {}
    for impl in (None, "ref"):
        eng = Engine(dataclasses.replace(cfg, attn_impl=impl), params,
                     ServeConfig(max_len=96, batch_slots=2, eos_token=-1))
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, 8)
        before = fd.flash_decode_cuda.launches
        runs[impl] = eng.run()
        if impl is None:
            steps = eng.steps["prefill"] + eng.steps["decode"]
            assert fd.flash_decode_cuda.launches - before == 2 * steps
    assert runs[None] == runs["ref"]
