"""The MoE family (phi3.5-moe) under ``tp``, plain ``sp`` and ``sp_ring``
recipes on gloo CPU ranks, against the reference.

``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode=...)`` on 4 gloo
ranks of the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)``
meshes, every rank on its shards, over 4 x 32 tokens of the SMOKE config
(float32, perturbed seeded weights, ``tests/_torch_families.py``), in four
variants (:data:`MODELS`):

* ``moe``: the capacity dispatch over all ``B * S`` tokens (one capacity,
  one running counter), so a rank gathers the rows the batch axes cut; the
  4 experts cut over ``model``, the rank running its experts' buffer rows.
* ``grouped``: 2 groups of 2 rows, used as they are on ``(2, 2)`` (a rank's
  2 rows are a whole group), gathered on ``(4, 1)``.
* ``ffn_cut``: 6 experts with a dense residual branch: on ``(1, 4)`` the
  experts do not divide ``model`` and every expert runs on its ``f``
  columns instead (``(2, 2)`` cuts the experts).
* ``ep``: ``moe_dispatch="ep"``: expert parallelism on ``(2, 2)`` and
  ``(1, 4)``, the fallback (with the reference's warning) on ``(4, 1)``.

Held to ``ATOL = 5e-5``: ``tp`` and ``sp`` against the reference's own
GSPMD program on 4 fake devices (its expert-parallel ``shard_map`` patched
for this jax), ``sp_ring`` against its single-device forward (``ep``:
against its ``tp`` program, which routes the same token shards); the aux
loss to ``1e-6``.  ``ep_dropless`` (capacity factor E / k) is held against
the reference's single-device dense oracle too.  Every rank returns the
same logits; the shards gathered back are the whole tree bitwise.
"""
import numpy as np
import pytest

import jax

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import LATENT_MOE_MODES, RECIPE_BATCH, RECIPE_MESHES
from repro.models import lm as jlm
from test_torch_recipe_mla import ATOL, reference_program

ARCH, SEQ = "phi3.5-moe-42b-a6.6b", 32
MODELS = {
    "moe": {},
    "grouped": dict(moe_groups=2),
    "ffn_cut": dict(n_experts=6, moe_dense_residual=True),
    "ep": dict(moe_dispatch="ep"),
    "ep_dropless": dict(moe_dispatch="ep", moe_capacity_factor=2.0),
}


@pytest.fixture(scope="module")
def inputs():
    models, toks, single = {}, {}, {}
    for i, (name, over) in enumerate(MODELS.items()):
        jcfg, jp, _, _ = family_models(ARCH, **over)
        models[name] = (ARCH, over, jax.tree.map(np.asarray, jp))
        toks[name] = family_tokens(jcfg, (RECIPE_BATCH, SEQ), 70 + i)
        if "ep" not in name:
            single[name] = jlm.forward(jp, {"tokens": toks[name]}, jcfg)
        elif name == "ep_dropless":  # the dense oracle: nothing drops at this capacity
            import dataclasses

            dense = dataclasses.replace(jcfg, moe_dispatch="auto")
            single[name] = jlm.forward(jp, {"tokens": toks[name]}, dense)
    single = {k: (np.asarray(v[0]), float(v[1])) for k, v in single.items()}
    return models, toks, single


@pytest.fixture(scope="module")
def reference(distributed, inputs, tmp_path_factory):
    return reference_program(distributed, *inputs[:2], tmp_path_factory.mktemp("jax_recipe_moe"))


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    models, toks, _ = inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:forward_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_moe"), timeout=400,
                                    shape=shape, models=models, tokens=toks)
        return cache[shape]

    return get


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_forward_matches_reference(reference, inputs, port, name, shape, mode):
    if mode != "sp_ring":
        want = reference[(name, shape, mode)]
    elif name.startswith("ep"):
        want = reference[(name, shape, "tp")]
    else:
        want = inputs[2][name]
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[(name, mode)], want[0], rtol=0, atol=ATOL,
                                   err_msg=f"{name} {shape} {mode} rank {rank}")
        assert abs(got[(name, mode, "aux")] - want[1]) < 1e-6, (name, shape, mode, rank)
        np.testing.assert_array_equal(got[(name, mode)], ranks[0][(name, mode)])
        assert got[(name, mode, "gathered")]
        assert got[(name, mode, "cut")]
        # expert parallelism runs where the grid hosts it; elsewhere the
        # reference's fallback warning, once a layer
        fell_back = name.startswith("ep") and shape[1] == 1
        assert got[(name, mode, "warnings")] == (2 if fell_back else 0), (name, shape, mode)


@pytest.mark.parametrize("shape", RECIPE_MESHES[:2], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_expert_parallel_matches_dense_oracle_when_nothing_drops(inputs, port, shape, mode):
    want, want_aux = inputs[2]["ep_dropless"]
    for rank, got in enumerate(port(shape)):
        np.testing.assert_allclose(got[("ep_dropless", mode)], want, rtol=0, atol=ATOL,
                                   err_msg=f"{shape} {mode} rank {rank}")
        assert abs(got[("ep_dropless", mode, "aux")] - want_aux) < 1e-6
