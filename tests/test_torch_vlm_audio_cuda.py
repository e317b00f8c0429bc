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
  idle slot among the lengths;
* the carry form's (64, 64) and (128, 128) instances at the one-card ring
  step of musicgen's and the VLM's self attention (the ``sp_ring`` forward
  on one rank), from the ring's explicit empty state, 4096 and a ragged
  1000 positions (the keys past 999 of a padded 1024 masked);
* both families (full width, 2 and 5 layers, seeded bf16 weights, the
  VLM's gates opened) under ``tp``, ``sp`` and ``sp_ring`` on a one-rank
  NCCL ``(data, model)`` mesh: logits bitwise the no-recipe forward's, the
  self blocks' launches on the carry kernel under ``sp_ring`` and the
  cross blocks' on the forward kernel.

Each output is the head of a buffer of sentinels, which must stay as they
were: no padded query row, and nothing past the output, is stored.
Tolerances: float32 ``rtol=atol=2e-4`` (float32 sums in another order);
bfloat16 ``rtol=atol=1e-2`` (one bf16 ulp of the output on top of that).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import configs
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [4096, 1000])
@pytest.mark.parametrize("G, D", [(32, 64), (8, 128)], ids=["musicgen_64_64", "vlm_128_128"])
def test_one_card_ring_step_instance_matches_plain_version(cuda, S, G, D, dtype):
    """The carry step of q (1, 32, S', D) over k/v (1, G, S', D), causal,
    S' = S rounded up to 1024 with the keys past S masked, from the
    explicit empty state (acc 0, m -1e30, l 0): acc, m and l against the
    plain version."""
    Sp = -(-S // 1024) * 1024
    q = _randn((1, 32, Sp, D), dtype, cuda, 60 + D)
    k, v = (_randn((1, G, Sp, D), dtype, cuda, 61 + D + i) for i in range(2))
    state = (torch.zeros((1, 32, Sp, D), device=cuda),
             torch.full((1, 32, Sp), -1e30, device=cuda), torch.zeros((1, 32, Sp), device=cuda))
    kw = dict(valid_len=None if S == Sp else S, causal=True)
    before = fa.flash_attention_carry_cuda.launches
    got = ops.flash_attention_carry(q, k, v, tuple(t.clone() for t in state), **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_carry_cuda.launches == before + 1
    want = ops.flash_attention_carry(q, k, v, state, impl="ref", **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    import torch.distributed as dist

    from repro_torch.core import init_world, make_mesh

    device = init_world("cuda")
    yield make_mesh((1, 1), ("data", "model"), device=device)
    dist.destroy_process_group()


@pytest.mark.parametrize("arch, layers", [("llama-3.2-vision-11b", 5), ("musicgen-large", 2)])
def test_recipe_forward_on_one_rank_is_the_no_recipe_program(world, arch, layers):
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import cast_params, shard_params_by_recipe

    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    params = cast_params(lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(1),
                                       device="cuda"), cfg.act_dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_ffn"):  # opened: at 0 the cross path would not show
            params["cross_blocks"][name].fill_(0.75)
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, 1000), device="cuda", generator=g),
                 "image_embeds": torch.randn((1, cfg.enc_len, cfg.enc_dim), device="cuda",
                                             generator=g)}
    else:
        batch = {"embeds": torch.randn((1, 1000, cfg.d_model), device="cuda", generator=g)}
    want = lm.forward(params, batch, cfg)[0]
    n_cross = lm.vlm_dims(cfg)[0] if cfg.family == "vlm" else 0
    for mode in ("tp", "sp", "sp_ring"):
        recipe = make_recipe(cfg, world, attn_mode=mode)
        shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
        fwd, carry = fa.flash_attention_cuda.launches, fa.flash_attention_carry_cuda.launches
        with use_recipe(recipe), torch.no_grad():
            got = lm.forward(shards, local_batch(recipe, batch), cfg)[0]
        torch.cuda.synchronize()
        ring = mode == "sp_ring"
        assert fa.flash_attention_cuda.launches - fwd == (n_cross if ring else layers), mode
        assert fa.flash_attention_carry_cuda.launches - carry == \
            (layers - n_cross if ring else 0), mode
        assert torch.equal(got, want), mode
