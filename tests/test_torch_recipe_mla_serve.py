"""Serving the MLA family (minicpm3) under a sharding recipe on gloo CPU
ranks: ``Engine(recipe=...)`` and ``lm.decode_step`` under ``tp``, plain
``sp`` and ``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``
``(data, model)`` meshes of 4 ranks, every rank on its shards of the
weights and its blocks of the latent caches (rows over ``data``, positions
over ``model``).

The absorbed decode scores every head against the rank's block of the
cache and the ranks' partial softmaxes merge by their log-sum-exp, so
float32 sums run in another order than the reference's one softmax:

* 6 requests on 4 slots through ``Engine(recipe=)`` (prompts prefilled as
  whole chunks, slots released and reused): greedy tokens equal to the
  reference's single-host engine's, request for request; every leaf of the
  engine's state has the local shape ``decode_state_shardings`` gives it.
* ``lm.decode_step`` from empty caches: a whole-prompt chunk of 7 (ragged
  rows, one idle), then 3 one-token steps with another row idle, against
  the reference's ``decode_step``: logits within ``ATOL = 5e-5``, the
  caches gathered back within it too (their lengths and positions equal).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import LATENT_MOE_MODES, PREFILL_COUNTS, RECIPE_BATCH, RECIPE_MESHES
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

ATOL = 5e-5
SLOTS, MAX_LEN = 4, 64
STEP_COUNTS = (1, 1, 1, 0)


def requests(seed: int = 5):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist(),
             int(rng.integers(3, 8))) for rid in range(6)]


def decode_steps(jcfg, seed: int):
    """A whole-prompt chunk of 7 (counts :data:`PREFILL_COUNTS`) and 3
    one-token steps (counts :data:`STEP_COUNTS`)."""
    steps = [(family_tokens(jcfg, (RECIPE_BATCH, 7), seed), np.array(PREFILL_COUNTS, np.int32))]
    for t in range(3):
        steps.append((family_tokens(jcfg, (RECIPE_BATCH, 1), seed + 1 + t),
                      np.array(STEP_COUNTS, np.int32)))
    return steps


def reference_serving(name, jcfg, jp, steps):
    """The reference's single-host engine's outputs and its ``decode_step``
    over ``steps`` from empty caches (logits, cache leaves, positions)."""
    engine = JEngine(jcfg, jp, JServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1))
    for rid, prompt, n in requests():
        engine.submit(rid, prompt, max_new_tokens=n)
    B = steps[0][0].shape[0]
    state = jlm.DecodeState(jlm.init_cache(jcfg, B, 16), jnp.zeros((B,), jnp.int32))
    logits = []
    for i, (toks, counts) in enumerate(steps):
        step, state = jlm.decode_step(jp, state, {"tokens": jnp.asarray(toks)}, jcfg,
                                      new_counts=jnp.asarray(counts), prefill=i == 0)
        logits.append(np.asarray(step))
    return {"tokens": engine.run(), "steps": logits,
            "caches": [np.asarray(t) for t in jax.tree.leaves(state.caches)],
            "positions": np.asarray(state.positions)}


def check_serving(want, ranks, name, shape, mode):
    assert sorted(want["tokens"]) == list(range(len(requests())))
    for rank, got in enumerate(ranks):
        where = f"{name} {shape} {mode} rank {rank}"
        assert got[(name, mode, "tokens")] == want["tokens"], where
        assert got[(name, mode, "local")], where
        for t, (g, w) in enumerate(zip(got[(name, mode, "steps")], want["steps"], strict=True)):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{where} step {t}")
        for i, (g, w) in enumerate(zip(got[(name, mode, "caches")], want["caches"],
                                       strict=True)):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{where} cache {i}")
        np.testing.assert_array_equal(got[(name, mode, "positions")], want["positions"])


@pytest.fixture(scope="module")
def models():
    jcfg, jp, _, _ = family_models("minicpm3-4b")
    return {"mla": (jcfg, jp)}


@pytest.fixture(scope="module")
def steps(models):
    return {name: decode_steps(jcfg, 80) for name, (jcfg, _) in models.items()}


@pytest.fixture(scope="module")
def reference(models, steps):
    return {name: reference_serving(name, jcfg, jp, steps[name])
            for name, (jcfg, jp) in models.items()}


@pytest.fixture(scope="module")
def port(models, steps, tmp_path_factory):
    named = {name: ("minicpm3-4b", {}, jax.tree.map(np.asarray, jp))
             for name, (_, jp) in models.items()}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_mla_serve"),
                                    timeout=400, shape=shape, models=named,
                                    requests={name: requests() for name in named},
                                    slots=SLOTS, max_len=MAX_LEN, steps=steps)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_serving_under_recipe_matches_reference(reference, port, shape, mode):
    check_serving(reference["mla"], port(shape), "mla", shape, mode)
