"""The audio family (musicgen SMOKE: MHA with 4 KV heads, the GELU MLP,
``embeds`` input) served with a sharding recipe and the explicit
tensor-parallel decode together on gloo CPU ranks: ``Engine(recipe=...,
mesh=..., microbatches=2)`` under ``tp``, plain ``sp`` and ``sp_ring`` on
the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)`` meshes of 4
ranks.  Prefill runs under the recipe (the featurized prompt frames as a
whole-prompt chunk, the ring's under ``sp_ring``), decode through the TP
step (each rank's rows as ``frames + sinusoidal(positions)``), both on the
recipe's cache blocks: one allocation, the rows over ``data`` and the KV
heads over ``model`` (one a rank on ``(1, 4)``).

The weights are the reference's seeded ones with every constant leaf
perturbed (``tests/_torch_families.py``), so that the GELU's biases are not
zero.  The oracle is the reference's single-host engine, its attention
kernels in interpret mode, on the 10 requests of :data:`TP_REQUESTS` on 8
slots (slots reused), float32: greedy tokens equal, request for request;
each rank's K/V its block of the allocation, within ``1e-5`` of the same
block of the reference engine's caches below each row's length, lengths
exact; the TP step's weights, cut from the recipe's shards gathered back,
bitwise ``shard_params`` of the whole cast tree.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import TP_MAX_LEN, TP_MICROBATCHES, TP_REQUESTS, TP_SLOTS, run_gloo
from _torch_families import perturb
from _torch_recipe import RECIPE_MESHES
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core.dist import Mesh
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import make_recipe
from repro_torch.models.weights import shard_params_by_recipe
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_recipe_tp_serve import MODES, check_blocks, reference_run

ARCH = "musicgen-large"


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(jconfigs.get(ARCH, smoke=True), act_dtype=jnp.float32,
                              attn_impl="interpret")
    return cfg, perturb(jlm.init_model(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference(model):
    return reference_run(*model, TP_REQUESTS[ARCH])


@pytest.fixture(scope="module")
def port(model, tmp_path_factory):
    tree = {ARCH: jax.tree.map(np.asarray, model[1])}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_recipe_tp", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_tp_audio"), timeout=400,
                                    shape=shape, models=tree, requests=TP_REQUESTS,
                                    slots=TP_SLOTS, max_len=TP_MAX_LEN,
                                    microbatches=TP_MICROBATCHES)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_audio_recipe_with_tp_decode_matches_single_host_reference(reference, port, shape,
                                                                   mode):
    want = reference[0]
    assert sorted(want) == list(range(len(TP_REQUESTS[ARCH])))
    for rank, got in enumerate(port(shape)):
        assert got[(ARCH, mode, "tokens")] == want, (shape, mode, rank)
        steps = got[(ARCH, mode, "steps")]
        assert steps["prefill"] >= 2 and steps["decode"] > 0, steps  # slots reused


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_audio_ranks_hold_their_blocks_of_the_reference_caches(reference, port, shape, mode):
    n_kv = tconfigs.get(ARCH, smoke=True).n_kv
    for rank, got in enumerate(port(shape)):
        check_blocks((got[(ARCH, mode, "caches")], got["coords"]), reference[1], shape, n_kv,
                     f"{shape} {mode} rank {rank}")


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_audio_tp_weights_from_recipe_shards_equal_the_whole_trees_cut(port, shape, mode):
    for rank, got in enumerate(port(shape)):
        assert got[(ARCH, mode, "tp_params_differ")] == [], (shape, mode, rank)


def test_audio_pair_on_one_rank_is_the_tp_engine_with_views_of_the_shards():
    cfg = dataclasses.replace(tconfigs.get(ARCH, smoke=True), act_dtype=torch.float32)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = Mesh({"data": 1, "model": 1}, 0, torch.device("cpu"))
    scfg = ServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS, eos_token=-1)
    recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
    pair = Engine(cfg, shard_params_by_recipe(params, lm.build_specs(cfg), recipe), scfg,
                  recipe=recipe, mesh=mesh, microbatches=TP_MICROBATCHES)
    tp = Engine(cfg, params, scfg, mesh=mesh, microbatches=TP_MICROBATCHES)
    for engine in (pair, tp):
        for rid, prompt, n in TP_REQUESTS[ARCH]:
            engine.submit(rid, prompt, n)
    assert pair.run() == tp.run()
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(tree_leaves(pair.tp_params), tree_leaves(pair.params),
                               strict=True))
