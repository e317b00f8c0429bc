"""The dense family under a sharding recipe on the card, on a one-rank NCCL
``(data, model)`` mesh: phi4-mini at full width, 2 of its 32 layers, bf16.

On one rank every axis of the recipe has one rank, so the per-rank
program runs no collective and cuts nothing: the forward of 1 x 512 tokens
under ``tp`` and ``sp`` launches ``flash_attention`` once a layer and its
logits equal the no-recipe forward's bitwise (the same kernels on the same
operands); a prefill chunk and one decode step of ``lm.decode_step`` under
the recipe launch ``flash_decode`` once a layer each and equal the
no-recipe steps bitwise, caches included.  The hybrid family likewise:
zamba2-7b at full width (one super-block and a tail block) under ``tp``,
``sp`` and ``sp_ring`` (the carry instance at (112, 112)), and two decode
steps under ``tp``.  These tests import neither ``jax`` nor the reference
package and skip without a CUDA device.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import lm
from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
from repro_torch.models.weights import cast_params, shard_params_by_recipe

pytestmark = pytest.mark.cuda

LAYERS, SEQ = 2, 512


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    import torch.distributed as dist

    from repro_torch.core import init_world, make_mesh

    device = init_world("cuda")
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b"), n_layers=LAYERS)
    params = cast_params(lm.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                                       device=device), cfg.act_dtype)
    yield cfg, params, make_mesh((1, 1), ("data", "model"), device=device)
    dist.destroy_process_group()


def _rows(recipe, batch):
    """A decode step's batch: whole without a recipe, else this rank's rows."""
    return batch if recipe is None else local_batch(recipe, batch, decode=True)


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_recipe_forward_on_one_rank_is_the_plain_forward(setup, mode):
    cfg, params, mesh = setup
    recipe = make_recipe(cfg, mesh, attn_mode=mode)
    assert recipe.attn_mode == mode
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    want, _ = lm.forward(params, {"tokens": tokens}, cfg)
    before = fa.flash_attention_cuda.launches
    with use_recipe(recipe):
        got, _ = lm.forward(shards, local_batch(recipe, {"tokens": tokens}), cfg)
    assert fa.flash_attention_cuda.launches == before + LAYERS
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_recipe_decode_step_on_one_rank_is_the_plain_step(setup, mode):
    cfg, params, mesh = setup
    recipe = make_recipe(cfg, mesh, attn_mode=mode)
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    g = torch.Generator(device="cuda").manual_seed(2)
    chunk = torch.randint(0, cfg.vocab, (2, 64), device="cuda", generator=g)
    counts = torch.tensor([64, 40], dtype=torch.int32, device="cuda")
    nxt = torch.randint(0, cfg.vocab, (2, 1), device="cuda", generator=g)
    runs = []
    for r in (None, recipe):
        with use_recipe(r):
            state = lm.DecodeState(caches=lm.init_cache(cfg, 2, 256, device="cuda"),
                                   positions=torch.zeros((2,), dtype=torch.int32, device="cuda"))
            before = fd.flash_decode_cuda.launches
            p = params if r is None else shards
            first, state = lm.decode_step(p, state, _rows(r, {"tokens": chunk}), cfg,
                                          new_counts=counts, prefill=True)
            second, state = lm.decode_step(p, state, _rows(r, {"tokens": nxt}), cfg,
                                           new_counts=torch.ones_like(counts))
            assert fd.flash_decode_cuda.launches == before + 2 * LAYERS
        runs.append((first, second, state))
    (w1, w2, ws), (g1, g2, gs) = runs
    assert torch.isfinite(g2).all()
    assert torch.equal(g1, w1) and torch.equal(g2, w2)
    for a, b in zip(gs.caches, ws.caches):
        assert torch.equal(a, b)
    assert torch.equal(gs.positions, ws.positions)


@pytest.fixture(scope="module")
def hybrid(setup):
    """zamba2-7b at full width, one super-block (5 Mamba2 blocks and the
    shared attention block) and one tail block, bf16."""
    _, _, mesh = setup
    cfg = dataclasses.replace(configs.get("zamba2-7b"), n_layers=7)
    params = cast_params(lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(3),
                                       device="cuda"), cfg.act_dtype)
    return cfg, params, mesh


@pytest.mark.parametrize("mode", ["tp", "sp", "sp_ring"])
def test_hybrid_recipe_forward_on_one_rank(hybrid, mode):
    """zamba2 under each mode on one rank: ``tp`` and ``sp`` launch the
    (112, 112) forward instance once a shared application and equal the
    no-recipe forward bitwise; ``sp_ring`` runs the ring's one step, the
    carry instance at (112, 112) in place of the forward instance, whose
    chain of one step is the single-shot kernel's bits: bitwise too."""
    cfg, params, mesh = hybrid
    recipe = make_recipe(cfg, mesh, attn_mode=mode)
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    want, _ = lm.forward(params, {"tokens": tokens}, cfg)
    before = (fa.flash_attention_cuda.launches, fa.flash_attention_carry_cuda.launches)
    with use_recipe(recipe):
        got, _ = lm.forward(shards, local_batch(recipe, {"tokens": tokens}), cfg)
    torch.cuda.synchronize()
    ring = mode == "sp_ring"
    assert fa.flash_attention_cuda.launches == before[0] + (0 if ring else 1)
    assert fa.flash_attention_carry_cuda.launches == before[1] + (1 if ring else 0)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_hybrid_recipe_decode_steps_on_one_rank(hybrid):
    """Two decode steps of zamba2 under ``tp`` on one rank (the D = 112
    decode instance once a shared application a step, a row idle in the
    second) equal the no-recipe steps bitwise, states and caches
    included."""
    cfg, params, mesh = hybrid
    recipe = make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = [torch.randint(0, cfg.vocab, (2, 1), device="cuda", generator=g) for _ in range(2)]
    counts = [torch.tensor(c, dtype=torch.int32, device="cuda") for c in ([1, 1], [1, 0])]
    runs = []
    for r in (None, recipe):
        with use_recipe(r):
            state = lm.DecodeState(caches=lm.init_cache(cfg, 2, 256, device="cuda"),
                                   positions=torch.zeros((2,), dtype=torch.int32, device="cuda"))
            before = fd.flash_decode_cuda.launches
            logits = []
            for t, c in zip(toks, counts):
                out, state = lm.decode_step(params if r is None else shards, state,
                                            _rows(r, {"tokens": t}), cfg, new_counts=c)
                logits.append(out)
            assert fd.flash_decode_cuda.launches == before + 2
        runs.append((logits, state))
    (wl, ws), (gl, gs) = runs
    assert all(torch.equal(a, b) for a, b in zip(gl, wl))

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        return [x for f in t for x in (leaves(f) if isinstance(f, tuple) else [f])]

    assert all(torch.equal(a, b) for a, b in zip(leaves(gs.caches), leaves(ws.caches)))
