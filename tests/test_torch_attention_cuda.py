"""The port's CUDA attention kernels against their plain PyTorch versions,
on the card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run
``pytest tests/test_torch_attention_cuda.py``.  Odd shapes exercise ragged
row tiles, ragged KV tiles and blocks, strided operands and both row-tile
sizes of the decode kernel.  Tolerances: float32 ``rtol=atol=2e-4``
(float32 sums in another order); bfloat16 ``rtol=atol=1e-2`` (one bf16 ulp
of the output on top of that).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

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
    (2, 6, 2, 77, 77, 64, True),     # ragged row and key tiles, GQA 3
    (1, 4, 4, 130, 130, 128, True),  # MHA, head dim 128
    (2, 8, 1, 33, 100, 128, False),  # Sq != Skv, non-causal, one KV head
])
def test_flash_attention_cuda_matches_plain_version(cuda, shape, dtype):
    B, Hq, G, Sq, Skv, D, causal = shape
    q = _randn((B, Hq, Sq, D), dtype, cuda, 0)
    k = _randn((B, G, Skv, D), dtype, cuda, 1)
    v = _randn((B, G, Skv, D), dtype, cuda, 2)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_attention_cuda_reads_strided_views(cuda):
    """q, k, v as (B, S, H, D) buffers seen through transposed views."""
    x = _randn((2, 50, 12, 128), torch.bfloat16, cuda, 3)
    q, k, v = x[:, :, :6].transpose(1, 2), x[:, :, 6:8].transpose(1, 2), x[:, :, 8:10].transpose(1, 2)
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode", "chunk", "many_rows"])
def test_flash_decode_cuda_matches_plain_version(cuda, case, dtype):
    """``decode``: one query per row, T = 300 that blocks of 128 do not
    divide, lengths 300, 1, 129 and an idle row; ``chunk``: 70 queries per
    row with ``q_positions``; ``many_rows``: rep*S = 120 rows (the 64-row
    tile).  Rows with no visible key (the idle row) are excluded: the
    kernel skips blocks past every visible key and gives 0 there."""
    B, Hq, G, T, D = 4, 6, 2, 300, 128
    S = {"decode": 1, "chunk": 70, "many_rows": 40}[case]
    q = _randn((B, Hq, S, D), dtype, cuda, 4)
    kc = _randn((B, G, T, D), dtype, cuda, 5)
    vc = _randn((B, G, T, D), dtype, cuda, 6)
    start = torch.tensor([0, 1, 0, 129], dtype=torch.int32, device=cuda)
    counts = torch.tensor([S, S, 0, S], dtype=torch.int32, device=cuda)
    if case == "decode":
        lens, pos = torch.tensor([300, 1, 0, 129], dtype=torch.int32, device=cuda), None
    else:
        lens = start + counts
        pos = start[:, None] + torch.arange(S, dtype=torch.int32, device=cuda)[None, :]
    before = fd.flash_decode_cuda.launches
    got = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=128)
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches == before + 1
    want = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=128, impl="ref")
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.all(got[~live] == 0)


@pytest.mark.parametrize("case", ["block_per_split", "blocks_per_split"])
def test_flash_decode_cuda_rounds_each_block_against_its_own_max(cuda, case):
    """bf16: each KV block's probabilities are rounded to bf16 against that
    block's own max.  Rounding moves the outputs by less than the tolerance,
    so the mean |difference| from the plain version must be under a quarter
    of the difference from a version that does not round (float32 caches)
    and from one that rounds against the whole cache's max (one block).
    ``block_per_split`` gives every split one KV block; ``blocks_per_split``
    has enough row tiles that one split walks all of them."""
    B, Hq, G, T, D, bk = 4, 24, 8, 1024, 128, 128
    S = {"block_per_split": 1, "blocks_per_split": 256}[case]
    lib = fd.load_library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, _, per = fd.plan_launch(Hq // G * S, B * G, T // bk, D, bk, sms,
                               lib.flash_decode_smem_bytes)
    assert (per > 1) == (case == "blocks_per_split")
    q = _randn((B, Hq, S, D), torch.bfloat16, cuda, 10)
    kc = _randn((B, G, T, D), torch.bfloat16, cuda, 11)
    vc = _randn((B, G, T, D), torch.bfloat16, cuda, 12)
    start = torch.tensor([0, 500, 768, 200], dtype=torch.int32, device=cuda)
    lens = torch.full_like(start, T) if S == 1 else start + S
    pos = None if S == 1 else start[:, None] + torch.arange(S, dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=bk).float()
    torch.cuda.synchronize()

    def mean_diff(k, v, block):
        want = ops.flash_decode(q, k, v, lens, q_positions=pos, block=block, impl="ref")
        return (got - want.float()).abs().mean().item()

    plain = mean_diff(kc, vc, bk)
    unrounded = mean_diff(kc.float(), vc.float(), bk)
    one_block = mean_diff(kc, vc, T)
    assert 4 * plain < min(unrounded, one_block), (plain, unrounded, one_block)


def test_flash_decode_cuda_reads_a_layer_of_a_stacked_cache(cuda):
    """The path's caches are layer slices of (L, B, G, T, D) tensors."""
    cache = _randn((3, 2, 2, 96, 64), torch.bfloat16, cuda, 7)
    q = _randn((2, 4, 1, 64), torch.bfloat16, cuda, 8)
    lens = torch.tensor([96, 50], dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, cache[1], cache[2], lens, block=32)
    torch.cuda.synchronize()
    want = ops.flash_decode(q, cache[1], cache[2], lens, block=32, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _randn((1, 2, 8, 64), torch.float32, cuda, 9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(q[..., :32], q[..., :32], q[..., :32])
