"""Serving with a sharding recipe and the explicit tensor-parallel decode
together on gloo CPU ranks: ``Engine(recipe=..., mesh=..., microbatches=2)``
under ``tp``, plain ``sp`` and ``sp_ring`` on the ``(2, 2)`` and ``(4, 1)``
``(data, model)`` meshes of 4 ranks.  Prefill runs under the recipe (a
whole-prompt chunk, the ring's under ``sp_ring``), decode through the TP
step, both on the recipe's cache blocks: one allocation, the rows over
``data`` and the KV groups over ``model``.

The reference's engine takes the same pair, and its sharded TP program
cannot run on this jax, so the oracle is its single-host engine, run with
its attention kernels in interpret mode, on the request lists of
``tests/test_engine.py`` (10 requests on 8 slots for phi4-mini, so slots
are reused; 6 for qwen2.5 with random QKV biases, so two rows stay idle),
float32:

* greedy tokens equal, request for request;
* after the run each rank's K/V is its block of the allocation (``B /
  data`` rows, ``n_kv / model`` groups), within ``1e-5`` of the same block
  of the reference engine's caches below each row's length, its lengths
  whole and exact;
* the TP step's weights, cut from the recipe's shards gathered back, are
  bitwise ``shard_params`` of the whole cast tree.

On ``(1, 4)`` the smoke configs' 2 KV groups do not divide 4 ranks, and the
TP step's own check refuses the pair.  On a mesh of one rank the pair is
the TP engine's program, its TP weights views of the recipe's shards.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from _torch_dist import TP_MAX_LEN, TP_MICROBATCHES, TP_REQUESTS, TP_SLOTS, run_gloo
from _torch_recipe import RECIPE_MODES
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.core.dist import Mesh
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import make_recipe
from repro_torch.models.weights import shard_params_by_recipe
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_tp_decode import _jax_params

ARCHS = ["phi4-mini-3.8b", "qwen2.5-32b"]
MESHES = [(2, 2), (4, 1)]
MODES = RECIPE_MODES + ("sp_ring",)
ATOL = 1e-5


def reference_run(cfg, params, requests):
    """The reference's single-host engine: its greedy outputs and its
    caches after the run (k, v, lengths as numpy)."""
    engine = JEngine(cfg, params, JServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS,
                                               eos_token=-1))
    for rid, prompt, n in requests:
        engine.submit(rid, prompt, max_new_tokens=n)
    tokens = engine.run()
    c = engine.state.caches
    return tokens, (np.asarray(c.k), np.asarray(c.v), np.asarray(c.length))


def check_blocks(got, want, shape, n_kv, where) -> None:
    """This rank's K/V (got: k, v, lengths, coords) is its (rows, groups)
    block of the reference's whole caches below each row's length."""
    (k, v, length), coords = got
    wk, wv, wlen = want
    D, M = shape
    bl, gl = TP_SLOTS // D, n_kv // M
    assert k.shape == v.shape == (wk.shape[0], bl, gl, *wk.shape[3:]), where
    np.testing.assert_array_equal(length, wlen, where)
    rows = slice(coords["data"] * bl, (coords["data"] + 1) * bl)
    groups = slice(coords["model"] * gl, (coords["model"] + 1) * gl)
    for name, g, w in (("k", k, wk), ("v", v, wv)):
        w = w[:, rows, groups]
        for r, n in enumerate(length[0, rows]):
            np.testing.assert_allclose(g[:, r, :, :n], w[:, r, :, :n], rtol=0, atol=ATOL,
                                       err_msg=f"{where} {name} row {rows.start + r}")


@pytest.fixture(scope="module")
def models():
    return {arch: _jax_params(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(models):
    return {arch: reference_run(cfg, params, TP_REQUESTS[arch])
            for arch, (cfg, params) in models.items()}


@pytest.fixture(scope="module")
def port(models, tmp_path_factory):
    trees = {arch: jax.tree.map(np.asarray, params) for arch, (_, params) in models.items()}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_recipe_tp", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_tp_serve"), timeout=400,
                                    shape=shape, models=trees, requests=TP_REQUESTS,
                                    slots=TP_SLOTS, max_len=TP_MAX_LEN,
                                    microbatches=TP_MICROBATCHES)
        return cache[shape]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_recipe_with_tp_decode_matches_single_host_reference(reference, port, arch, shape,
                                                             mode):
    want = reference[arch][0]
    assert sorted(want) == list(range(len(TP_REQUESTS[arch])))
    for rank, got in enumerate(port(shape)):
        assert got[(arch, mode, "tokens")] == want, (arch, shape, mode, rank)
        steps = got[(arch, mode, "steps")]
        assert steps["prefill"] >= 1 and steps["decode"] > 0, steps


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_each_rank_holds_its_block_of_the_reference_caches(reference, port, arch, shape, mode):
    n_kv = tconfigs.get(arch, smoke=True).n_kv
    for rank, got in enumerate(port(shape)):
        check_blocks((got[(arch, mode, "caches")], got["coords"]), reference[arch][1], shape,
                     n_kv, f"{arch} {shape} {mode} rank {rank}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_tp_weights_from_recipe_shards_equal_the_whole_trees_cut(port, arch, shape, mode):
    for rank, got in enumerate(port(shape)):
        assert got[(arch, mode, "tp_params_differ")] == [], (arch, shape, mode, rank)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_pair_refused_where_kv_groups_do_not_divide_the_model_axis(arch, mode):
    cfg = tconfigs.get(arch, smoke=True)  # 2 KV groups
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    for rank in range(4):
        mesh = Mesh({"data": 1, "model": 4}, rank, torch.device("cpu"))
        recipe = make_recipe(cfg, mesh, attn_mode=mode)
        shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
        with pytest.raises(ValueError, match="n_kv=2 must divide model axis 4"):
            Engine(cfg, shards, ServeConfig(batch_slots=TP_SLOTS), recipe=recipe, mesh=mesh,
                   microbatches=TP_MICROBATCHES)


@pytest.mark.parametrize("mode", MODES)
def test_pair_on_one_rank_is_the_tp_engine_with_views_of_the_shards(mode):
    """On a ``(1, 1)`` mesh the recipe's prefill is the program without a
    recipe, so the pair's tokens are the TP engine's exactly, and the TP
    step's weights share the recipe shards' storage (no second copy)."""
    cfg = dataclasses.replace(tconfigs.get("qwen2.5-32b", smoke=True), act_dtype=torch.float32)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = Mesh({"data": 1, "model": 1}, 0, torch.device("cpu"))
    scfg = ServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS, eos_token=-1)
    recipe = make_recipe(cfg, mesh, attn_mode=mode)
    pair = Engine(cfg, shard_params_by_recipe(params, lm.build_specs(cfg), recipe), scfg,
                  recipe=recipe, mesh=mesh, microbatches=TP_MICROBATCHES)
    tp = Engine(cfg, params, scfg, mesh=mesh, microbatches=TP_MICROBATCHES)
    for engine in (pair, tp):
        for rid, prompt, n in TP_REQUESTS["qwen2.5-32b"]:
            engine.submit(rid, prompt, n)
    assert pair.run() == tp.run()
    assert all(a.data_ptr() == b.data_ptr() and a.shape == b.shape
               for a, b in zip(tree_leaves(pair.tp_params), tree_leaves(pair.params),
                               strict=True))
    for a, b in zip(pair.state.caches, tp.state.caches, strict=True):
        assert torch.equal(a, b)
