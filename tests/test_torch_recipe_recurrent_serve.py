"""Serving the SSM (rwkv6) and hybrid (zamba2) families under a sharding
recipe on gloo CPU ranks: ``Engine(recipe=...)`` under ``tp``, plain ``sp``
and ``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data,
model)`` meshes of 4 ranks, every rank holding its shards of the weights
and its blocks of the decode state.

The oracle is the reference's single-host engine (its attention kernels in
interpret mode) on the same weights (the SMOKE configs' seeded weights with
their constant leaves perturbed, ``tests/_torch_families.py``; float32):
greedy tokens must be equal, request for request.  6 requests on 4 slots,
prefilled token by token, so two slots serve a second request after a
release and their recurrent state is zeroed first, on the rank that holds
their rows: the batch axes cut the 4 slots on ``(2, 2)`` and ``(4, 1)``.
The recurrent states are cut by heads over ``model`` (rwkv6's 4 heads,
zamba2's 8 Mamba2 heads), zamba2's shared K/V ring buffer by its 4 KV
groups; every leaf of the engine's state has the local shape
``decode_state_shardings`` gives it.
"""
import numpy as np
import pytest

import jax

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_recipe import RECIPE_MESHES, RECURRENT_ARCHS, RECURRENT_MODES
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

SLOTS, MAX_LEN = 4, 64


def _requests():
    rng = np.random.default_rng(5)
    return [(rid, rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist(),
             int(rng.integers(3, 8))) for rid in range(6)]


@pytest.fixture(scope="module")
def models():
    return {arch: family_models(arch)[:2] for arch in RECURRENT_ARCHS}


@pytest.fixture(scope="module")
def reference(models):
    out = {}
    for arch, (jcfg, jp) in models.items():
        engine = JEngine(jcfg, jp, JServeConfig(max_len=MAX_LEN, batch_slots=SLOTS,
                                                eos_token=-1))
        for rid, prompt, n in _requests():
            engine.submit(rid, prompt, max_new_tokens=n)
        out[arch] = engine.run()
    return out


@pytest.fixture(scope="module")
def port(models, tmp_path_factory):
    trees = {arch: jax.tree.map(np.asarray, jp) for arch, (_, jp) in models.items()}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_recurrent", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_recurrent_serve"),
                                    timeout=400, shape=shape, models=trees,
                                    requests={arch: _requests() for arch in trees},
                                    slots=SLOTS, max_len=MAX_LEN)
        return cache[shape]

    return get


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", RECURRENT_MODES)
def test_engine_under_recipe_matches_single_host_reference(reference, port, arch, shape, mode):
    want = reference[arch]
    assert sorted(want) == list(range(len(_requests())))
    for rank, got in enumerate(port(shape)):
        assert got[(arch, mode, "tokens")] == want, (arch, shape, mode, rank)
        assert got[(arch, mode, "local")], (arch, shape, mode, rank)
