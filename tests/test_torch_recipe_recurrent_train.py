"""Training the SSM (rwkv6) and hybrid (zamba2) families under a sharding
recipe on gloo CPU ranks: ``make_train_step`` under ``tp``, plain ``sp``
and ``sp_ring`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data,
model)`` meshes, every rank updating its shards, against the reference's
single-device step.

The SMOKE configs (float32; the reference's seeded weights with their
constant leaves perturbed, ``tests/_torch_families.py``), 4 x 32 tokens,
AdamW at ``lr=1e-3`` with no warmup; the reference's attention is its
differentiable ``blockwise_attention_ref``.  The gradients flow back
through every collective of the per-rank program: the heads' partial sums,
Mamba2's norm statistic summed over ``model`` (its backward sums the
cotangents too), the weights gathered over ``model`` where the recipe's
cut straddles the fused segments (their backward reduce-scatters), and
under ``sp_ring`` the sequence gathered for each recurrent block.  To the
reference's own tolerances for its sharded step (``tests/test_sharding.py``):
loss ``1e-4`` and every parameter ``rtol=atol=2e-4``; the stepped
parameters are the same on every rank.  Adam's first update is nearly
``sign(g) * lr``, so the parameters barely see a gradient's size: the
gradients themselves (gathered back) are held to ``jax.value_and_grad`` of
the reference's loss as ``tests/_torch_families.py:assert_grads_close``
holds them (``rtol=1e-4``, ``atol`` 1e-4 of the leaf's largest magnitude),
and the step's gradient norm to ``rtol=1e-5``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import RECIPE_BATCH, RECIPE_MESHES, RECURRENT_ARCHS, RECURRENT_MODES, \
    RECURRENT_SEQ
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr

OCFG = dict(lr=1e-3, warmup_steps=0)


@pytest.fixture(scope="module")
def reference():
    out = {"trees": {}, "batch": {}}
    for i, arch in enumerate(RECURRENT_ARCHS):
        jcfg, jp, _, _ = family_models(arch, attn_impl=None)
        toks = family_tokens(jcfg, (RECIPE_BATCH, RECURRENT_SEQ + 1), 40 + i)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ocfg = jopt.OptConfig(**OCFG)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
        new_p, _, m = jax.jit(jtr.make_train_step(jcfg, None, ocfg))(
            jp, jopt.init_opt_state(jp, ocfg), jb)
        out["trees"][arch] = jax.tree.map(np.asarray, jp)
        out["batch"][arch] = batch
        out[arch] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), grads=grads,
                         params=[np.asarray(p) for p in jax.tree.leaves(new_p)])
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_recurrent", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_recurrent_train"),
                                    timeout=400, shape=shape, models=reference["trees"],
                                    batch=reference["batch"], ocfg=OCFG)
        return cache[shape]

    return get


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", RECURRENT_MODES)
def test_train_step_under_recipe_matches_single_device_reference(reference, port, arch, shape,
                                                                 mode):
    want = reference[arch]
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        assert abs(got[(arch, mode, "metrics")]["loss"] - want["loss"]) < 1e-4
        np.testing.assert_allclose(got[(arch, mode, "metrics")]["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        for i, (g, w) in enumerate(zip(got[(arch, mode, "grads")], jax.tree.leaves(want["grads"]),
                                       strict=True)):
            w = np.asarray(w)  # assert_grads_close's tolerance, on numpy leaves
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{arch} {shape} {mode} rank {rank} grad {i}")
        assert len(got[(arch, mode, "params")]) == len(want["params"])
        for i, (p, w) in enumerate(zip(got[(arch, mode, "params")], want["params"])):
            np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{arch} {shape} {mode} rank {rank} leaf {i}")
            np.testing.assert_array_equal(p, ranks[0][(arch, mode, "params")][i])
