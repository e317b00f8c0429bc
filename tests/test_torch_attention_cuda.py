"""The port's CUDA attention and transpose kernels against their plain
PyTorch versions, on the card.

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
from repro_torch.kernels import relayout
from repro_torch.models.attention import ring_step_offsets

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
    tile).  The idle row has no visible key and gets the mean of v over the
    cache padded to whole blocks, as the plain version and the reference
    give it."""
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
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    idle = vc[2].float()
    mean_v = torch.nn.functional.pad(idle, (0, 0, 0, 384 - T)).mean(dim=1)  # 3 blocks of 128
    torch.testing.assert_close(got[2].float(), mean_v.repeat_interleave(Hq // G, 0)[:, None]
                               .expand(Hq, S, D), rtol=TOL[dtype], atol=TOL[dtype])


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
                               lambda D, tr, bk: lib.flash_decode_smem_bytes(D, tr, bk, D))
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


def _plain_carry(B, Hq, S, D, device):
    return (torch.zeros((B, Hq, S, D), device=device), torch.full((B, Hq, S), -1e30, device=device),
            torch.zeros((B, Hq, S), device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("valid", [300, 280])
@pytest.mark.parametrize("D", [128, 112])
def test_flash_carry_cuda_matches_plain_version(cuda, dtype, causal, valid, D):
    """Every (rank, step) call of a 3-rank ring over 300 positions in
    chunks of 100 (ragged row and key tiles), GQA 3, head dim 128 or 112
    (zamba2's; the state's 112 columns beside the kernel's 128-column
    accumulators); with ``valid = 280`` the last 20 keys are padding.  Each
    call starts from the plain version's state and is compared in acc, m
    and l; the carry is updated in place."""
    B, Hq, G, R, Sl = 1, 6, 2, 3, 100
    q = _randn((B, Hq, R * Sl, D), dtype, cuda, 20)
    k = _randn((B, G, R * Sl, D), dtype, cuda, 21)
    v = _randn((B, G, R * Sl, D), dtype, cuda, 22)
    for rank in range(R):
        qr = q[:, :, rank * Sl:(rank + 1) * Sl]
        state = _plain_carry(B, Hq, Sl, D, cuda)
        for step in range(R):
            q_off, k_off = ring_step_offsets(rank, step, R, Sl)
            blk = slice(k_off, k_off + Sl)
            kw = dict(q_offset=q_off, k_offset=k_off, valid_len=valid, causal=causal)
            want = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], state, impl="ref",
                                             **kw)
            carry = tuple(t.clone() for t in state)
            before = fa.flash_attention_carry_cuda.launches
            got = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], carry, **kw)
            torch.cuda.synchronize()
            assert fa.flash_attention_carry_cuda.launches == before + 1
            assert all(g is c for g, c in zip(got, carry))  # in place
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])
            state = want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 112, 128])
def test_flash_carry_chain_equals_single_shot_bitwise(cuda, dtype, causal, D):
    """Four carry steps over KV chunks of 128 keys in block order,
    normalized as the ring's epilogue does, give the single-shot kernel's
    bits."""
    q = _randn((1, 8, 512, D), dtype, cuda, 23)
    k = _randn((1, 2, 512, D), dtype, cuda, 24)
    v = _randn((1, 2, 512, D), dtype, cuda, 25)
    carry = None
    for c in range(4):
        blk = slice(c * 128, (c + 1) * 128)
        carry = ops.flash_attention_carry(q, k[:, :, blk], v[:, :, blk], carry, q_offset=0,
                                          k_offset=c * 128, causal=causal)
    acc, _, l = carry
    chained = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(dtype)
    single = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(chained, single)


@pytest.mark.parametrize("D", [64, 112])
def test_flash_carry_cuda_gradient_matches_plain_version(cuda, D):
    """The kernel route's autograd Function (forward: the kernel on fresh
    copies of the carry; backward: recompute through the plain version)
    against autograd through the plain version, over two chained steps."""
    q0 = _randn((1, 4, 128, D), torch.float32, cuda, 26)
    k0 = _randn((1, 2, 128, D), torch.float32, cuda, 27)
    v0 = _randn((1, 2, 128, D), torch.float32, cuda, 28)
    grads = {}
    for impl in ("cuda", "ref"):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        carry = None
        for c in range(2):
            blk = slice(c * 64, (c + 1) * 64)
            carry = ops.flash_attention_carry(q, k[:, :, blk], v[:, :, blk], carry, q_offset=0,
                                              k_offset=c * 64, impl=impl)
        acc, _, l = carry
        (acc / l[..., None]).square().sum().backward()
        grads[impl] = (q.grad, k.grad, v.grad)
    for got, want in zip(grads["cuda"], grads["ref"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,dtype", [
    ((2048, 2048), torch.float32), ((3, 64, 32), torch.bfloat16), ((2, 2, 32, 64), torch.int32),
    ((5, 77, 33), torch.int8), ((2, 40, 300), torch.float64), ((70000, 2, 3), torch.float32)])
def test_transpose_cuda_matches_plain_version_bitwise(cuda, shape, dtype):
    """Any M and N (edge tiles), every element size, batches past the
    grid's 65535 z-blocks."""
    x = (_randn(shape, torch.float32, cuda, 29) * 100).to(dtype)
    before = relayout.transpose_cuda.launches
    got = ops.transpose_tiled(x, bm=shape[-2], bn=shape[-1])  # a tile the shape divides
    torch.cuda.synchronize()
    assert relayout.transpose_cuda.launches == before + 1
    assert torch.equal(got, ops.transpose_tiled(x, bm=shape[-2], bn=shape[-1], impl="ref"))
    with pytest.raises(ValueError, match="must divide tile"):
        ops.transpose_tiled(torch.zeros((300, 256), device=cuda))


def _normalized(carry):
    acc, _, l = carry
    return acc / torch.where(l == 0, 1.0, l)[..., None]


def test_attention_kernels_are_deterministic(cuda):
    """Two launches of each bf16 kernel on the same inputs are bitwise
    equal (no atomics, fixed orders)."""
    q = _randn((1, 8, 1000, 128), torch.bfloat16, cuda, 30)
    k = _randn((1, 2, 1000, 128), torch.bfloat16, cuda, 31)
    v = _randn((1, 2, 1000, 128), torch.bfloat16, cuda, 32)
    assert torch.equal(ops.flash_attention(q, k, v), ops.flash_attention(q, k, v))
    state = _plain_carry(1, 8, 1000, 128, cuda)
    kw = dict(q_offset=1000, k_offset=0, causal=True)
    first = ops.flash_attention_carry(q, k, v, tuple(t.clone() for t in state), **kw)
    second = ops.flash_attention_carry(q, k, v, tuple(t.clone() for t in state), **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    kc = _randn((4, 2, 700, 128), torch.bfloat16, cuda, 33)
    vc = _randn((4, 2, 700, 128), torch.bfloat16, cuda, 34)
    lens = torch.tensor([700, 1, 0, 350], dtype=torch.int32, device=cuda)
    qd = _randn((4, 8, 1, 128), torch.bfloat16, cuda, 35)
    assert torch.equal(ops.flash_decode(qd, kc, vc, lens), ops.flash_decode(qd, kc, vc, lens))
    torch.cuda.synchronize()


def test_attention_kernel_error_against_float64(cuda):
    """bf16 inputs, 1024 tokens, causal: the float32 acc / l of one carry
    step over every key (the forward kernel's arithmetic before its bf16
    output) is within 10x the plain version's error against float64 (p @ v
    in two bf16 pieces; one piece would be far over)."""
    Hq, G, S, D = 4, 2, 1024, 128
    q = _randn((1, Hq, S, D), torch.bfloat16, cuda, 36)
    k = _randn((1, G, S, D), torch.bfloat16, cuda, 37)
    v = _randn((1, G, S, D), torch.bfloat16, cuda, 38)
    mask = torch.ones((S, S), dtype=torch.bool, device=cuda).tril()
    rep = Hq // G
    s = (q.double() @ k.double().repeat_interleave(rep, 1).transpose(-1, -2)) * D ** -0.5
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
    exact = p @ v.double().repeat_interleave(rep, 1)
    kernel = _normalized(ops.flash_attention_carry(q, k, v, None, causal=True))
    plain = _normalized(ops.flash_attention_carry(q, k, v, None, causal=True, impl="ref"))
    torch.cuda.synchronize()
    err = (kernel.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    assert err <= 10 * plain_err, (err, plain_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 112])
def test_flash_carry_chain_over_1024_key_chunks_is_bitwise(cuda, dtype, D):
    """The ring's chunks start at multiples of 1024, a multiple of the
    64-key tile: three carry steps give the single-shot kernel's bits."""
    q = _randn((1, 6, 3072, D), dtype, cuda, 39)
    k = _randn((1, 2, 3072, D), dtype, cuda, 40)
    v = _randn((1, 2, 3072, D), dtype, cuda, 41)
    carry = None
    for c in range(3):
        blk = slice(c * 1024, (c + 1) * 1024)
        carry = ops.flash_attention_carry(q, k[:, :, blk], v[:, :, blk], carry, k_offset=c * 1024,
                                          causal=True)
    chained = _normalized(carry).to(dtype)
    single = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(chained, single)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_carry_chain_off_the_key_tile_is_close(cuda, dtype):
    """Chunks starting at 0, 1000 and 2000 (not multiples of 64): the tiles
    fall elsewhere, so the chain is only within tolerance of the single-shot
    kernel, not bitwise."""
    q = _randn((1, 6, 3000, 128), dtype, cuda, 42)
    k = _randn((1, 2, 3000, 128), dtype, cuda, 43)
    v = _randn((1, 2, 3000, 128), dtype, cuda, 44)
    carry = None
    for c in range(3):
        blk = slice(c * 1000, (c + 1) * 1000)
        carry = ops.flash_attention_carry(q, k[:, :, blk], v[:, :, blk], carry, k_offset=c * 1000,
                                          causal=True)
    chained = _normalized(carry).to(dtype)
    single = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(chained, single, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cuda_on_a_stacked_cache_that_blocks_do_not_divide(cuda, dtype):
    """A layer slice of an (L, B, G, T, D) cache with T = 4000 (512-key
    blocks, the last 416 keys), lengths 4000, 3999, 512 and an idle slot."""
    L, B, Hq, G, T, D = 2, 4, 24, 8, 4000, 128
    cache = _randn((2 * L, B, G, T, D), dtype, cuda, 45)
    q = _randn((B, Hq, 1, D), dtype, cuda, 46)
    lens = torch.tensor([4000, 3999, 512, 0], dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, cache[1], cache[L + 1], lens, block=512)
    torch.cuda.synchronize()
    want = ops.flash_decode(q, cache[1], cache[L + 1], lens, block=512, impl="ref")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_smem_bytes_matches_the_library(cuda):
    """The wrapper's planning formula is the library's own."""
    lib = fd.load_library()
    for D in (64, 128):
        for tr in (1, 4):
            for bk in (32, 128, 300, 512, 1024, 4096):
                assert fd.smem_bytes(D, tr, bk) == lib.flash_decode_smem_bytes(D, tr, bk, D)
