"""Training the MLA family (minicpm3) under a sharding recipe on gloo CPU
ranks: ``make_train_step`` under ``tp``, plain ``sp`` and ``sp_ring`` on
the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)`` meshes, every
rank updating its shards, against the reference's single-device step.

The SMOKE config (float32, perturbed seeded weights,
``tests/_torch_families.py``), 4 x 32 tokens, AdamW at ``lr=1e-3`` with no
warmup; the reference's attention is its differentiable
``blockwise_attention_ref``.  The gradients flow back through every
collective of the per-rank program: under ``tp`` the heads' partial sums
and the whole down projections' gradients summed over ``model``, under
``sp`` the query chunks' gathered outputs (chunk r > 0 through the carry
step's plain recompute), under ``sp_ring`` the latents gathered over
``model`` (their backward reduce-scatters).  Held as
``tests/test_torch_recipe_recurrent_train.py`` holds its families: loss
``1e-4``, gradient norm ``rtol=1e-5``, the gradients gathered back
``rtol=1e-4`` with an ``atol`` of 1e-4 of the leaf's largest magnitude,
and every stepped parameter ``rtol=atol=2e-4``, the same on every rank.
"""
import dataclasses
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import LATENT_MOE_MODES, RECIPE_BATCH, RECIPE_MESHES
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr

OCFG = dict(lr=1e-3, warmup_steps=0)
SEQ = 32


def reference_steps(arch, models, seed):
    """The reference's single-device gradients and step of every
    ``models[name] = (overrides, reference overrides)``."""
    out = {"trees": {}, "batch": {}}
    for i, (name, (over, ref_over)) in enumerate(models.items()):
        jcfg, jp, _, _ = family_models(arch, attn_impl=None, **over)
        jcfg = dataclasses.replace(jcfg, **ref_over)
        toks = family_tokens(jcfg, (RECIPE_BATCH, SEQ + 1), seed + i)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ocfg = jopt.OptConfig(**OCFG)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # an ep config's fallback without a mesh
            _, grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
            new_p, _, m = jax.jit(jtr.make_train_step(jcfg, None, ocfg))(
                jp, jopt.init_opt_state(jp, ocfg), jb)
        out["trees"][name] = (arch, over, jax.tree.map(np.asarray, jp))
        out["batch"][name] = batch
        out[name] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), grads=grads,
                         params=[np.asarray(p) for p in jax.tree.leaves(new_p)])
    return out


def check_step(want, ranks, name, shape, mode):
    for rank, got in enumerate(ranks):
        where = f"{name} {shape} {mode} rank {rank}"
        assert abs(got[(name, mode, "metrics")]["loss"] - want["loss"]) < 1e-4, where
        np.testing.assert_allclose(got[(name, mode, "metrics")]["grad_norm"], want["grad_norm"],
                                   rtol=1e-5, err_msg=where)
        for i, (g, w) in enumerate(zip(got[(name, mode, "grads")], jax.tree.leaves(want["grads"]),
                                       strict=True)):
            w = np.asarray(w)  # assert_grads_close's tolerance, on numpy leaves
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{where} grad {i}")
        assert len(got[(name, mode, "params")]) == len(want["params"])
        for i, (p, w) in enumerate(zip(got[(name, mode, "params")], want["params"])):
            np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4, err_msg=f"{where} leaf {i}")
            np.testing.assert_array_equal(p, ranks[0][(name, mode, "params")][i])


@pytest.fixture(scope="module")
def reference():
    return reference_steps("minicpm3-4b", {"mla": ({}, {})}, 100)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_mla_train"),
                                    timeout=400, shape=shape, models=reference["trees"],
                                    batch=reference["batch"], ocfg=OCFG)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_train_step_under_recipe_matches_single_device_reference(reference, port, shape, mode):
    check_step(reference["mla"], port(shape), "mla", shape, mode)
