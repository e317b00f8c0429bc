"""The attention kernels at the VLM's and the audio family's shapes against
their plain PyTorch versions, on the card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run
``pytest tests/test_torch_vlm_audio_cuda.py``.  The cases:

* the forward kernel's (128, 128) instance non-causal with Sq != Skv, the
  VLM's cross attention: 32 query heads over 8 KV groups attend to the
  image's 1024 positions from Sq = 1 (a decode step: one row of a query
  tile, the rest padding), 7 and 4096 text positions;
* its (64, 64) instance causal with MHA (musicgen's 32 heads over 32
  groups), at the forward's 4096 positions and a ragged 1000;
* the decode kernel's D = 64 instance with one query row a group (MHA), an
  idle slot among the lengths.

Each output is the head of a buffer of sentinels, which must stay as they
were: no padded query row, and nothing past the output, is stored.
Tolerances: float32 ``rtol=atol=2e-4`` (float32 sums in another order);
bfloat16 ``rtol=atol=1e-2`` (one bf16 ulp of the output on top of that).
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
SENTINEL, TAIL = 12345.0, 4096


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


def _with_sentinels(monkeypatch, fn, shape, dtype):
    """``fn()`` with the wrapper's output allocated as the head of a buffer
    whose TAIL further elements hold SENTINEL; returns the output and the
    tail."""
    real, bufs = torch.empty, []
    n = math.prod(shape)

    def empty(size, *args, dtype=None, device=None, **kw):
        if tuple(size) == tuple(shape) and dtype == out_dtype and not bufs:
            bufs.append(torch.full((n + TAIL,), SENTINEL, dtype=dtype, device=device))
            return bufs[0][:n].view(shape)
        return real(size, *args, dtype=dtype, device=device, **kw)

    out_dtype = dtype
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", empty)
        got = fn()
    torch.cuda.synchronize()
    assert bufs and got.data_ptr() == bufs[0].data_ptr()
    return got, bufs[0][n:]


def _untouched(tail):
    assert torch.equal(tail, torch.full_like(tail, SENTINEL)), "a store past the output"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 7, 4096])
def test_cross_attention_instance_matches_plain_version(cuda, monkeypatch, Sq, dtype):
    """The VLM's cross attention: q (B, 32, Sq, 128) over the image's k/v
    (B, 8, 1024, 128), non-causal; B = 4 rows for the short queries (a
    decode step's), 1 for the forward's 4096."""
    B = 1 if Sq == 4096 else 4
    q = _randn((B, 32, Sq, 128), dtype, cuda, Sq)
    k = _randn((B, 8, 1024, 128), dtype, cuda, Sq + 1)
    v = _randn((B, 8, 1024, 128), dtype, cuda, Sq + 2)
    before = fa.flash_attention_cuda.launches
    got, tail = _with_sentinels(monkeypatch, lambda: ops.flash_attention(q, k, v, causal=False),
                                (B, 32, Sq, 128), dtype)
    assert fa.flash_attention_cuda.launches == before + 1
    want = ops.flash_attention(q, k, v, causal=False, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    _untouched(tail)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [4096, 1000])
def test_audio_forward_instance_matches_plain_version(cuda, monkeypatch, S, dtype):
    """musicgen's attention: q/k/v (1, 32, S, 64), MHA, causal."""
    q, k, v = (_randn((1, 32, S, 64), dtype, cuda, 40 + i) for i in range(3))
    got, tail = _with_sentinels(monkeypatch, lambda: ops.flash_attention(q, k, v),
                                (1, 32, S, 64), dtype)
    want = ops.flash_attention(q, k, v, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    _untouched(tail)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_audio_decode_instance_matches_plain_version(cuda, monkeypatch, dtype):
    """musicgen's decode step: 5 slots of a 4096-position cache, 32 heads
    over 32 groups (one query row a group), lengths 1, 700, 2049, 4096 and
    an idle slot (no visible key: the mean of v over the cache padded to
    whole blocks, as the plain version gives it)."""
    B, H, T, D = 5, 32, 4096, 64
    q = _randn((B, H, 1, D), dtype, cuda, 50)
    kc, vc = _randn((B, H, T, D), dtype, cuda, 51), _randn((B, H, T, D), dtype, cuda, 52)
    lens = torch.tensor([1, 700, 2049, 4096, 0], dtype=torch.int32, device=cuda)
    before = fd.flash_decode_cuda.launches
    got, tail = _with_sentinels(monkeypatch, lambda: ops.flash_decode(q, kc, vc, lens),
                                (B, H, 1, D), dtype)
    assert fd.flash_decode_cuda.launches == before + 1
    want = ops.flash_decode(q, kc, vc, lens, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    _untouched(tail)
