"""Training the audio family (musicgen) under a sharding recipe on gloo CPU
ranks: ``make_train_step`` under ``tp``, plain ``sp`` and ``sp_ring`` on
the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)`` meshes, every
rank updating its shards, against the reference's single-device step.

The SMOKE config (float32, perturbed seeded weights,
``tests/_torch_families.py``), a batch of 4 x 30 frame embeddings (30 % 4
!= 0: ragged chunks, the padded frames zero) and seeded labels, AdamW at
``lr=1e-3`` with no warmup; the reference's attention is its
differentiable ``blockwise_attention_ref``.  The batch binds ``embeds`` to
the recipe's ``hidden`` spec: every rank takes its rows (under ``sp_ring``
its chunk) of the frames.  The GELU MLP's output bias, added once after
the partials' sum, takes its gradient once.  Held as the other families'
recipe steps are: loss ``1e-4``, gradient norm ``rtol=1e-5``, the
gradients gathered back ``rtol=1e-4`` with an ``atol`` of 1e-4 of the
leaf's largest magnitude, and every stepped parameter ``rtol=atol=2e-4``,
the same on every rank.
"""
import pytest

from _torch_dist import run_gloo
from _torch_families import RECIPE_OCFG, check_recipe_step, recipe_reference_step
from _torch_recipe import LATENT_MOE_MODES, RECIPE_MESHES

ARCH, SEQ = "musicgen-large", 30


@pytest.fixture(scope="module")
def reference():
    return recipe_reference_step(ARCH, SEQ, 120)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_audio_train"),
                                    timeout=400, shape=shape, models={"audio": reference["tree"]},
                                    batch={"audio": reference["batch"]}, ocfg=RECIPE_OCFG)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_train_step_under_recipe_matches_single_device_reference(reference, port, shape, mode):
    check_recipe_step(reference, port(shape), "audio", shape, mode)
