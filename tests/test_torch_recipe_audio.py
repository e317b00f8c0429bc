"""The audio family (musicgen) under ``tp``, plain ``sp`` and ``sp_ring``
recipes on gloo CPU ranks, against the reference.

``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode=...)`` runs on 4
gloo ranks of the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)``
meshes, every rank on its shards (``shard_params_by_recipe``; no ``embed``
table, the untied ``lm_head`` cut by vocab), over 4 x 30 frame embeddings
(30 % 4 != 0: ragged query chunks and ring chunks), the SMOKE config (2
layers, MHA with 4 heads: one a rank on the ``(1, 4)`` mesh, the GELU MLP;
float32; the reference's seeded weights with their constant leaves, the
GELU's zero biases among them, perturbed, ``tests/_torch_families.py``).
Every rank takes its rows of the frames (under ``sp_ring`` its chunk,
padded with zero frames) and adds the sinusoid at their absolute
positions; the MLP's output bias is added once, after the partials' sum.

* ``tp`` and ``sp`` against the reference's own GSPMD program (``jax.jit``
  under ``use_recipe``) on 4 fake devices, within ``ATOL = 1e-5``.
* ``sp_ring`` against the reference's single-device ``lm.forward`` within
  the same ``ATOL``.
* Every rank returns the same logits; the shards really are cut, and
  gathered back they are the whole tree bitwise.
"""
import numpy as np
import pytest

import jax

from _torch_dist import run_gloo
from _torch_families import inputs as family_inputs
from _torch_families import models as family_models
from _torch_recipe import LATENT_MOE_MODES, RECIPE_BATCH, RECIPE_MESHES, family_reference
from repro.models import lm as jlm

ATOL = 1e-5
ARCH, SEQ = "musicgen-large", 30


@pytest.fixture(scope="module")
def inputs():
    jcfg, jp, _, _ = family_models(ARCH)
    models = {"audio": (ARCH, {}, jax.tree.map(np.asarray, jp))}
    jb, _ = family_inputs(jcfg, RECIPE_BATCH, SEQ, seed=71)
    single = np.asarray(jlm.forward(jp, jb, jcfg)[0])
    return models, {"audio": {k: np.asarray(v) for k, v in jb.items()}}, single


@pytest.fixture(scope="module")
def reference(distributed, inputs, tmp_path_factory):
    return family_reference(distributed, *inputs[:2],
                            tmp_path_factory.mktemp("jax_recipe_audio"))


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    models, batches, _ = inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:forward_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_audio"), shape=shape,
                                    models=models, tokens=batches)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_forward_matches_reference(reference, inputs, port, shape, mode):
    want = inputs[2] if mode == "sp_ring" else reference[("audio", shape, mode)][0]
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        where = f"{shape} {mode} rank {rank}"
        np.testing.assert_allclose(got[("audio", mode)], want, rtol=0, atol=ATOL, err_msg=where)
        np.testing.assert_array_equal(got[("audio", mode)], ranks[0][("audio", mode)])
        assert got[("audio", mode, "gathered")] and got[("audio", mode, "cut")], where


def test_reference_sharded_program_is_near_its_single_device_forward(reference, inputs):
    """The yardstick of ``ATOL``: the reference's GSPMD program against its
    own single-device forward, within it, on logits of a few units."""
    scale = np.abs(inputs[2]).max()
    assert 0.5 < scale < 20, scale
    for shape in RECIPE_MESHES:
        for mode in ("tp", "sp"):
            np.testing.assert_allclose(reference[("audio", shape, mode)][0], inputs[2], rtol=0,
                                       atol=ATOL, err_msg=f"{shape} {mode}")
