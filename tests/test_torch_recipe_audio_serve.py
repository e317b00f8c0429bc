"""Serving the audio family (musicgen) under a sharding recipe on gloo CPU
ranks: ``Engine(recipe=...)`` and ``lm.decode_step`` under ``tp``, plain
``sp`` and ``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``
``(data, model)`` meshes of 4 ranks, every rank on its shards of the
weights and its blocks of the K/V (rows over ``data``, the 4 heads over
``model``: one a rank on the ``(1, 4)`` mesh).  The engine featurizes each
request's ids into frames; every step's frames enter whole and every rank
takes its rows of them.

* 6 requests on 4 slots through ``Engine(recipe=)`` (prompts prefilled as
  whole chunks, the ring's under ``sp_ring``; slots released and reused):
  greedy tokens equal to the reference's single-host engine's, request for
  request; every leaf of the engine's state has the local shape
  ``decode_state_shardings`` gives it.
* ``lm.decode_step`` from empty caches: a whole-prompt chunk of 7 frames
  (ragged rows, one idle), then 3 one-frame steps with another row idle,
  against the reference's ``decode_step``: each active row's logits at its
  valid positions within ``ATOL = 5e-5`` (under ``sp_ring`` the chunk's
  padding past a row's count rings with the chunk, where the reference
  attends over its cache), the K/V gathered back within it below each
  row's length (past it a row keeps its chunk padding's K/V, never read),
  the lengths and positions equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_recipe import LATENT_MOE_MODES, PREFILL_COUNTS, RECIPE_BATCH, RECIPE_MESHES
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

ATOL = 5e-5
ARCH = "musicgen-large"
SLOTS, MAX_LEN = 4, 64
STEP_COUNTS = (1, 1, 1, 0)
COUNTS = [PREFILL_COUNTS] + [STEP_COUNTS] * 3


def requests(seed: int = 6):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist(),
             int(rng.integers(3, 8))) for rid in range(6)]


def decode_steps(jcfg, seed: int):
    """A whole-prompt chunk of 7 frames (counts :data:`PREFILL_COUNTS`) and
    3 one-frame steps (counts :data:`STEP_COUNTS`), seeded."""
    rng = np.random.default_rng(seed)

    def frames(S):
        return {"embeds": rng.standard_normal((RECIPE_BATCH, S, jcfg.d_model)).astype(np.float32)}

    steps = [(frames(7), np.array(PREFILL_COUNTS, np.int32))]
    steps += [(frames(1), np.array(STEP_COUNTS, np.int32)) for _ in range(3)]
    return steps


@pytest.fixture(scope="module")
def model():
    jcfg, jp, _, _ = family_models(ARCH)
    return jcfg, jp


@pytest.fixture(scope="module")
def steps(model):
    return decode_steps(model[0], 90)


@pytest.fixture(scope="module")
def reference(model, steps):
    """The reference's single-host engine's outputs and its ``decode_step``
    over ``steps`` from empty caches (logits, cache leaves, positions)."""
    jcfg, jp = model
    engine = JEngine(jcfg, jp, JServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1))
    for rid, prompt, n in requests():
        engine.submit(rid, prompt, max_new_tokens=n)
    state = jlm.DecodeState(jlm.init_cache(jcfg, RECIPE_BATCH, 16),
                            jnp.zeros((RECIPE_BATCH,), jnp.int32))
    logits = []
    for i, (frames, counts) in enumerate(steps):
        step, state = jlm.decode_step(jp, state, {"embeds": jnp.asarray(frames["embeds"])}, jcfg,
                                      new_counts=jnp.asarray(counts), prefill=i == 0)
        logits.append(np.asarray(step))
    return {"tokens": engine.run(), "steps": logits,
            "caches": [np.asarray(t) for t in jax.tree.leaves(state.caches)],
            "positions": np.asarray(state.positions)}


@pytest.fixture(scope="module")
def port(model, steps, tmp_path_factory):
    named = {"audio": (ARCH, {}, jax.tree.map(np.asarray, model[1]))}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_audio_serve"),
                                    timeout=400, shape=shape, models=named,
                                    requests={"audio": requests()}, slots=SLOTS,
                                    max_len=MAX_LEN, steps={"audio": steps})
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_serving_under_recipe_matches_reference(reference, port, shape, mode):
    want = reference
    assert sorted(want["tokens"]) == list(range(len(requests())))
    for rank, got in enumerate(port(shape)):
        where = f"{shape} {mode} rank {rank}"
        assert got[("audio", mode, "tokens")] == want["tokens"], where
        assert got[("audio", mode, "local")], where
        for t, (g, w) in enumerate(zip(got[("audio", mode, "steps")], want["steps"],
                                       strict=True)):
            for r, n in enumerate(COUNTS[t]):  # each active row's valid positions
                np.testing.assert_allclose(g[r, :n], w[r, :n], rtol=0, atol=ATOL,
                                           err_msg=f"{where} step {t} row {r}")
        k, v, length = got[("audio", mode, "caches")]
        np.testing.assert_array_equal(length, want["caches"][2], where)
        for name, g, w in (("k", k, want["caches"][0]), ("v", v, want["caches"][1])):
            for r, n in enumerate(length[0]):  # (L, B, G, T, D) below each row's length
                np.testing.assert_allclose(g[:, r, :, :n], w[:, r, :, :n], rtol=0, atol=ATOL,
                                           err_msg=f"{where} {name} row {r}")
        np.testing.assert_array_equal(got[("audio", mode, "positions")], want["positions"])
