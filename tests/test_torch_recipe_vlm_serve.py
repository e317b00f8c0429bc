"""Serving the VLM family (llama-3.2-vision) under a sharding recipe on
gloo CPU ranks: ``lm.init_cache`` and ``lm.decode_step`` under ``tp``,
plain ``sp`` and ``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``
``(data, model)`` meshes of 4 ranks, every rank on its shards of the
weights and its blocks of the self blocks' K/V (rows over ``data``; the 2
KV groups over ``model`` where they divide it, else the 16 positions); the
cross blocks keep no cache and attend over each row's image at every step.
The engine serves no VLM (the reference's cannot: ROADMAP.md §3), so the
greedy loop is the test's own, the same on both sides.

From empty caches: a whole-prompt chunk of 7 tokens (ragged rows, one
idle; under ``sp_ring`` the ring over the chunk), then 5 one-token steps,
each row fed its own greedy token, with rows idle in some of them (the
SMOKE config, float32, perturbed weights with the gates opened,
``tests/_torch_families.py``), against the reference's single-device
``decode_step`` on the same loop: every active row's logits at its valid
positions within ``ATOL = 5e-5`` (under ``sp_ring`` the chunk's padding
past a row's count rings with the chunk, where the reference attends over
its cache), the greedy tokens equal, the caches gathered back within
``ATOL`` and the positions equal; another image moves the chunk's logits
by far more than ``ATOL``.
"""
import numpy as np
import pytest

import jax

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_families import reference_greedy
from _torch_families import tokens as family_tokens
from _torch_recipe import LATENT_MOE_MODES, PREFILL_COUNTS, RECIPE_BATCH, RECIPE_MESHES

ATOL = 5e-5
ARCH = "llama-3.2-vision-11b"
COUNTS = [PREFILL_COUNTS, (1, 1, 1, 0), (1, 0, 1, 1), (1, 1, 1, 1), (0, 1, 1, 1), (1, 1, 0, 1)]


def images(jcfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (RECIPE_BATCH, jcfg.enc_len, jcfg.enc_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    jcfg, jp, _, _ = family_models(ARCH)
    return (jcfg, jp, family_tokens(jcfg, (RECIPE_BATCH, 7), 93), images(jcfg, 94),
            images(jcfg, 95), [np.array(c, np.int32) for c in COUNTS])


@pytest.fixture(scope="module")
def reference(inputs):
    jcfg, jp, prompt, image, _, counts = inputs
    return reference_greedy(jcfg, jp, prompt, image, counts)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    _, jp, prompt, image, other, counts = inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:decode_greedy", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_vlm_serve"),
                                    timeout=400, shape=shape,
                                    models={"vlm": (ARCH, {}, jax.tree.map(np.asarray, jp))},
                                    prompts={"vlm": prompt}, counts=counts, image=image,
                                    other_image=other)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_decode_step_under_recipe_matches_reference(reference, port, shape, mode):
    want = reference
    for rank, got in enumerate(port(shape)):
        where = f"{shape} {mode} rank {rank}"
        for t, (g, w) in enumerate(zip(got[("vlm", mode, "steps")], want["steps"],
                                       strict=True)):
            for r, n in enumerate(COUNTS[t]):  # each active row's valid positions
                np.testing.assert_allclose(g[r, :n], w[r, :n], rtol=0, atol=ATOL,
                                           err_msg=f"{where} step {t} row {r}")
        np.testing.assert_array_equal(got[("vlm", mode, "tokens")], want["tokens"], where)
        for i, (g, w) in enumerate(zip(got[("vlm", mode, "caches")], want["caches"],
                                       strict=True)):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{where} cache {i}")
        np.testing.assert_array_equal(got[("vlm", mode, "positions")], want["positions"])
        moved = np.abs(got[("vlm", mode, "other")] - got[("vlm", mode, "steps")][0]).max()
        assert moved > 100 * ATOL, (where, moved)
