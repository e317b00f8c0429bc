"""Serving the MoE family (phi3.5-moe) under a sharding recipe on gloo CPU
ranks: ``Engine(recipe=...)`` and ``lm.decode_step`` under ``tp``, plain
``sp`` and ``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``
``(data, model)`` meshes of 4 ranks, every rank on its shards (the experts
cut over ``model``) and its blocks of the K/V caches.

The SMOKE config as the published one is set: ``moe_dispatch="ep"`` with
grouped dispatch (2 groups) as its fallback.  Decode (S == 1) is dense and
dropless under every recipe, so a rank routes its own rows; expert
parallelism never runs in decode (the reference's ``_ep_ineligible``), nor
for the 7-token chunk, which does not divide ``model``.  As ``tests/test_torch_recipe_mla_serve.py``: 6 requests
on 4 slots through ``Engine(recipe=)`` (the MoE family prefills token by
token, each step attending over its row's cache, never the ``sp_ring``
prefill ring) against the reference's single-host engine, tokens equal; a
chunk of 7 (the capacity dispatch over all 28 tokens, grouped in
``grouped_ep``; a plain chunk, not a ring prefill, whose idle row's output
would take capacity from the others) and 3 one-token steps against the
reference's ``decode_step``, logits and caches within ``ATOL = 5e-5``.
"""
import warnings

import numpy as np
import pytest

import jax

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_recipe import LATENT_MOE_MODES, RECIPE_MESHES
from test_torch_recipe_mla_serve import (MAX_LEN, SLOTS, check_serving, decode_steps,
                                         reference_serving, requests)

ARCH = "phi3.5-moe-42b-a6.6b"
MODELS = {"grouped_ep": dict(moe_dispatch="ep", moe_groups=2)}


@pytest.fixture(scope="module")
def models():
    return {name: family_models(ARCH, **over)[:2] for name, over in MODELS.items()}


@pytest.fixture(scope="module")
def steps(models):
    return {name: decode_steps(jcfg, 90 + i) for i, (name, (jcfg, _)) in enumerate(models.items())}


@pytest.fixture(scope="module")
def reference(models, steps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ep config's fallback without a mesh
        return {name: reference_serving(name, jcfg, jp, steps[name])
                for name, (jcfg, jp) in models.items()}


@pytest.fixture(scope="module")
def port(models, steps, tmp_path_factory):
    named = {name: (ARCH, MODELS[name], jax.tree.map(np.asarray, jp))
             for name, (_, jp) in models.items()}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_moe_serve"),
                                    timeout=400, shape=shape, models=named,
                                    requests={name: requests() for name in named},
                                    slots=SLOTS, max_len=MAX_LEN, steps=steps)
        return cache[shape]

    return get


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_serving_under_recipe_matches_reference(reference, port, name, shape, mode):
    check_serving(reference[name], port(shape), name, shape, mode)
