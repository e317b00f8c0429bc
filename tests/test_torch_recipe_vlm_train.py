"""Training the VLM family (llama-3.2-vision) under a sharding recipe on
gloo CPU ranks: ``make_train_step`` under ``tp``, plain ``sp`` and
``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)``
meshes, every rank updating its shards, against the reference's
single-device step.

The SMOKE config (float32, perturbed seeded weights, the cross blocks'
gates drawn from U[0.5, 1], ``tests/_torch_families.py``), a batch of 4 x
30 tokens (30 % 4 != 0: ragged chunks), their labels and each row's image,
AdamW at ``lr=1e-3`` with no warmup; the reference's attention is its
differentiable ``blockwise_attention_ref``.  The group and each self block
in it run under remat (``cfg.remat == "block"``), so every self block's
gathers are issued again in the backward's recomputes; the gradients reach
the cross weights through the ``model`` reductions (the heads' partial
sums, or under ``sp`` the query chunks' gathered outputs) and the gates
through the batch axes' sums.  Held as the other families' recipe steps
are: loss ``1e-4``, gradient norm ``rtol=1e-5``, the gradients gathered
back ``rtol=1e-4`` with an ``atol`` of 1e-4 of the leaf's largest
magnitude, and every stepped parameter ``rtol=atol=2e-4``, the same on
every rank; the cross attention's and the gates' gradients are not zero.
"""
import numpy as np
import pytest

import jax

from _torch_dist import run_gloo
from _torch_families import RECIPE_OCFG, check_recipe_step, recipe_reference_step
from _torch_recipe import LATENT_MOE_MODES, RECIPE_MESHES

ARCH, SEQ = "llama-3.2-vision-11b", 30
# the leaves of the cross attention's wk and wq and of the two gates, in the
# tree's sorted order (cross_blocks: attn {k_norm, q_norm, wk, wo, wq, wv},
# ffn {w_down, w_gate, w_up}, gate_attn, gate_ffn, ln1, ln2)
CROSS = {"attn.wk": 2, "attn.wq": 4, "gate_attn": 9, "gate_ffn": 10}


@pytest.fixture(scope="module")
def reference():
    return recipe_reference_step(ARCH, SEQ, 110)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_vlm_train"),
                                    timeout=400, shape=shape, models={"vlm": reference["tree"]},
                                    batch={"vlm": reference["batch"]}, ocfg=RECIPE_OCFG)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_train_step_under_recipe_matches_single_device_reference(reference, port, shape, mode):
    ranks = port(shape)
    check_recipe_step(reference, ranks, "vlm", shape, mode)
    cross = [i for i, (path, _) in enumerate(jax.tree_util.tree_flatten_with_path(
        reference["grads"])[0]) if "cross_blocks" in jax.tree_util.keystr(path)]
    for key, j in CROSS.items():
        assert np.abs(ranks[0][("vlm", mode, "grads")][cross[j]]).sum() > 0, key
