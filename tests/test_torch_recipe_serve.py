"""Serving under a sharding recipe on gloo CPU ranks: ``Engine(recipe=...)``
and the whole-prompt prefill chunk of ``lm.decode_step`` under ``tp``,
plain ``sp`` and ``sp_ring``, on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``
``(data, model)`` meshes of 4 ranks, every rank holding its shards of the
weights and of the caches.

The reference's serving program under a recipe is its single-host engine
on sharded arrays; the oracle here is that single-host engine itself, run
with its attention kernels in interpret mode, on the request lists of
``tests/test_engine.py`` (10 requests on 8 slots for phi4-mini, so slots
are reused; 6 for qwen2.5 with random QKV biases, so two rows stay idle),
float32: greedy tokens must be equal, request for request.  The caches
are cut by heads on ``(2, 2)`` and by sequence on ``(1, 4)`` (2 KV
groups do not divide 4 ranks), and whole on ``(4, 1)``.

The prefill chunk (7 tokens, rows of 7, 5, 0 and 3 valid tokens) is held
against the reference's single-device ``decode_step(prefill=True)``:
logits at every valid token and the K/V written within ``1e-5``, lengths
and positions exactly.  Under ``sp_ring`` with more than one ``model``
rank the chunk's attention is the ring over the fresh Q/K/V, and 7 tokens
do not divide 2 or 4 ranks (ragged chunks).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import TP_MAX_LEN, TP_REQUESTS, TP_SLOTS, run_gloo
from _torch_recipe import PREFILL_COUNTS, RECIPE_MESHES, RECIPE_MODES
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from test_torch_tp_decode import _jax_params

ARCHS = ["phi4-mini-3.8b", "qwen2.5-32b"]
MODES = RECIPE_MODES + ("sp_ring",)
PREFILL_LEN = 16  # the prefill check's cache length


def _prefill_tokens():
    return np.random.default_rng(3).integers(0, 500, (len(PREFILL_COUNTS), 7)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    return {arch: _jax_params(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(models):
    out = {}
    for arch, (cfg, params) in models.items():
        engine = JEngine(cfg, params, JServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS,
                                                   eos_token=-1))
        for rid, prompt, n in TP_REQUESTS[arch]:
            engine.submit(rid, prompt, max_new_tokens=n)
        out[(arch, "tokens")] = engine.run()
        B = len(PREFILL_COUNTS)
        state = jlm.DecodeState(caches=jlm.init_cache(cfg, B, PREFILL_LEN),
                                positions=jnp.zeros((B,), jnp.int32))
        logits, new = jlm.decode_step(params, state, {"tokens": jnp.asarray(_prefill_tokens())},
                                      cfg, new_counts=jnp.asarray(PREFILL_COUNTS, jnp.int32),
                                      prefill=True)
        out[(arch, "prefill")] = (np.asarray(logits), np.asarray(new.caches.k),
                                  np.asarray(new.caches.v), np.asarray(new.caches.length),
                                  np.asarray(new.positions))
    return out


@pytest.fixture(scope="module")
def port(models, tmp_path_factory):
    trees = {arch: jax.tree.map(np.asarray, params) for arch, (_, params) in models.items()}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:serve_family", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_serve"), timeout=400,
                                    shape=shape, models=trees, requests=TP_REQUESTS,
                                    slots=TP_SLOTS, max_len=TP_MAX_LEN,
                                    prefill_tokens=_prefill_tokens())
        return cache[shape]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_engine_under_recipe_matches_single_host_reference(reference, port, arch, shape, mode):
    want = reference[(arch, "tokens")]
    assert len(want) == len(TP_REQUESTS[arch])
    for rank, got in enumerate(port(shape)):
        assert got[(arch, mode, "tokens")] == want, (arch, shape, mode, rank)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_prefill_chunk_under_recipe_matches_reference(reference, port, arch, shape, mode):
    w_logits, w_k, w_v, w_len, w_pos = reference[(arch, "prefill")]
    for rank, got in enumerate(port(shape)):
        logits, k, v, length, pos = got[(arch, mode, "prefill")]
        for b, n in enumerate(PREFILL_COUNTS):
            np.testing.assert_allclose(logits[b, :n], w_logits[b, :n], rtol=0, atol=1e-5)
            np.testing.assert_allclose(k[:, b, :, :n], w_k[:, b, :, :n], rtol=0, atol=1e-5)
            np.testing.assert_allclose(v[:, b, :, :n], w_v[:, b, :, :n], rtol=0, atol=1e-5)
            if n == 0:  # an idle row keeps its (empty) cache
                assert not k[:, b].any() and not v[:, b].any()
        np.testing.assert_array_equal(length, w_len)
        np.testing.assert_array_equal(pos, w_pos)
