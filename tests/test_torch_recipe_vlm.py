"""The VLM family (llama-3.2-vision) under ``tp``, plain ``sp`` and
``sp_ring`` recipes on gloo CPU ranks, against the reference.

``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode=...)`` runs on 4
gloo ranks of the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)``
meshes, every rank on its shards (``shard_params_by_recipe``: the nested
``self_blocks`` and the ``cross_blocks`` cut tuple for tuple), over 4 x 30
tokens (30 % 4 != 0: ragged query chunks and ring chunks) and each row's
own 16-position image, the SMOKE config (5 layers: one group of 4 self
blocks and a cross block; float32; the reference's seeded weights with
their constant leaves perturbed and the cross blocks' gates drawn from
U[0.5, 1], ``tests/_torch_families.py``).  Under ``tp`` the cross block
runs the rank's heads (its KV group, or on the ``(1, 4)`` mesh, where the
2 groups do not divide ``model``, the whole groups its head reads); under
``sp`` the rank's query chunk attends over the whole image; under
``sp_ring`` the chunk's queries attend over the whole image of its rows.

* ``tp`` and ``sp`` against the reference's own GSPMD program (``jax.jit``
  under ``use_recipe``) on 4 fake devices, within ``ATOL = 1e-5``.
* ``sp_ring`` against the reference's single-device ``lm.forward`` within
  the same ``ATOL``.
* Every rank returns the same logits; the shards really are cut, and
  gathered back they are the whole tree bitwise; another image moves the
  logits by far more than ``ATOL``.
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
ARCH, SEQ = "llama-3.2-vision-11b", 30


@pytest.fixture(scope="module")
def inputs():
    jcfg, jp, _, _ = family_models(ARCH)
    models = {"vlm": (ARCH, {}, jax.tree.map(np.asarray, jp))}
    jb, _ = family_inputs(jcfg, RECIPE_BATCH, SEQ, seed=61)
    batch = {k: np.asarray(v) for k, v in jb.items()}
    image = family_inputs(jcfg, RECIPE_BATCH, SEQ, seed=62)[0]["image_embeds"]
    other = {**batch, "image_embeds": np.asarray(image)}
    single = np.asarray(jlm.forward(jp, jb, jcfg)[0])
    return models, {"vlm": batch}, {"vlm": other}, single


@pytest.fixture(scope="module")
def reference(distributed, inputs, tmp_path_factory):
    return family_reference(distributed, *inputs[:2], tmp_path_factory.mktemp("jax_recipe_vlm"))


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    models, batches, others, _ = inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:forward_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_vlm"), shape=shape,
                                    models=models, tokens=batches, others=others)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_forward_matches_reference(reference, inputs, port, shape, mode):
    want = inputs[3] if mode == "sp_ring" else reference[("vlm", shape, mode)][0]
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        where = f"{shape} {mode} rank {rank}"
        np.testing.assert_allclose(got[("vlm", mode)], want, rtol=0, atol=ATOL, err_msg=where)
        np.testing.assert_array_equal(got[("vlm", mode)], ranks[0][("vlm", mode)])
        assert got[("vlm", mode, "gathered")] and got[("vlm", mode, "cut")], where
        moved = np.abs(got[("vlm", mode, "other")] - got[("vlm", mode)]).max()
        assert moved > 100 * ATOL, (where, moved)


def test_reference_sharded_program_is_near_its_single_device_forward(reference, inputs):
    """The yardstick of ``ATOL``: the reference's GSPMD program against its
    own single-device forward, within it, on logits of a few units."""
    scale = np.abs(inputs[3]).max()
    assert 0.5 < scale < 20, scale
    for shape in RECIPE_MESHES:
        for mode in ("tp", "sp"):
            np.testing.assert_allclose(reference[("vlm", shape, mode)][0], inputs[3], rtol=0,
                                       atol=ATOL, err_msg=f"{shape} {mode}")
