"""The MLA family (minicpm3) under ``tp``, plain ``sp`` and ``sp_ring``
recipes on gloo CPU ranks, against the reference.

``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode=...)`` runs on 4
gloo ranks of the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)``
meshes, every rank on its shards (``shard_params_by_recipe``), over 4 x 32
tokens of the SMOKE config (float32; the reference's seeded weights with
their constant leaves, the two latent norms among them, perturbed,
``tests/_torch_families.py``).  Under ``tp`` the 4 heads are cut over
``model`` (``wuq``, ``wuk``, ``wuv``, ``wo``) while the down projections,
``wkr`` and the norms stay whole; under ``sp`` every rank decompresses K/V
for the whole sequence and runs its chunk of the queries (chunk r > 0
through one carry step, q/k of 24 and v of 16); under ``sp_ring`` the
chunk's latents are gathered and its queries run one carry step over the
whole sequence.

* ``tp`` and ``sp`` against the reference's own GSPMD program (``jax.jit``
  under ``use_recipe``) on 4 fake devices, within ``ATOL = 5e-5`` on
  logits of the scale the yardstick test states.
* ``sp_ring`` against the reference's single-device ``lm.forward`` (its
  MLA calls ``attention_seq`` with no ring), within the same ``ATOL``.
* Every rank returns the same logits; the shards really are cut, and
  gathered back they are the whole tree bitwise.
"""
import pickle

import numpy as np
import pytest

import jax

from _torch_dist import TESTS, run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import LATENT_MOE_MODES, RECIPE_BATCH, RECIPE_MESHES
from repro.models import lm as jlm

ATOL = 5e-5
ARCH, SEQ = "minicpm3-4b", 32

_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
import repro.core.compat as compat
_shard_map = jax.shard_map
def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True, **kw):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=check_rep,
                      **kw)
compat.shard_map = shard_map  # this jax names check_rep check_vma
sys.path.insert(0, {tests!r})
from repro import configs
from repro.models import lm
from repro.models.sharding import make_recipe, use_recipe, batch_shardings
from _torch_recipe import RECIPE_MESHES

with open({inputs!r}, "rb") as f:
    models, tokens = pickle.load(f)
out = {{}}
for name, (arch, overrides, tree) in models.items():
    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=jnp.float32,
                              attn_impl="interpret", **overrides)
    params = jax.tree.map(jnp.asarray, tree)
    specs = lm.build_specs(cfg)
    b = {{"tokens": jnp.asarray(tokens[name])}}
    for shape in RECIPE_MESHES:
        mesh = compat.make_mesh(shape, ("data", "model"))
        for mode in ("tp", "sp"):
            r = make_recipe(cfg, mesh, attn_mode=mode)
            pd = jax.tree.map(lambda x, s: jax.device_put(x, s), params, r.param_shardings(specs))
            bd = {{"tokens": jax.device_put(b["tokens"], batch_shardings(r, b)["tokens"])}}

            def f(p, b, r=r):
                with use_recipe(r):
                    return lm.forward(p, b, cfg)

            with mesh:
                logits, aux = jax.jit(f)(pd, bd)
            out[(name, shape, mode)] = (np.asarray(logits), float(aux))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def reference_program(distributed, models, tokens, directory) -> dict:
    """The reference's GSPMD forward of every named model under ``tp`` and
    ``sp`` on every mesh of ``RECIPE_MESHES``, in a 4-fake-device
    subprocess (``shard_map`` patched there for the expert-parallel
    dispatch): ``{(name, shape, mode): (logits, aux)}``."""
    with open(directory / "inputs.pkl", "wb") as f:
        pickle.dump((models, tokens), f)
    path = str(directory / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, inputs=str(directory / "inputs.pkl"),
                                                 path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def inputs():
    jcfg, jp, _, _ = family_models(ARCH)
    models = {"mla": (ARCH, {}, jax.tree.map(np.asarray, jp))}
    toks = {"mla": family_tokens(jcfg, (RECIPE_BATCH, SEQ), 60)}
    single = {"mla": np.asarray(jlm.forward(jp, {"tokens": toks["mla"]}, jcfg)[0])}
    return models, toks, single


@pytest.fixture(scope="module")
def reference(distributed, inputs, tmp_path_factory):
    return reference_program(distributed, *inputs[:2], tmp_path_factory.mktemp("jax_recipe_mla"))


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    models, toks, _ = inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:forward_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_mla"),
                                    shape=shape, models=models, tokens=toks)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_forward_matches_reference(reference, inputs, port, shape, mode):
    want = inputs[2]["mla"] if mode == "sp_ring" else reference[("mla", shape, mode)][0]
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[("mla", mode)], want, rtol=0, atol=ATOL,
                                   err_msg=f"{shape} {mode} rank {rank}")
        np.testing.assert_array_equal(got[("mla", mode)], ranks[0][("mla", mode)])
        assert got[("mla", mode, "gathered")]
        assert got[("mla", mode, "cut")]


def test_reference_sharded_program_is_near_its_single_device_forward(reference, inputs):
    """The yardstick of ``ATOL``: the reference's GSPMD program against its
    own single-device forward, within half of it, on logits of a few units."""
    scale = np.abs(inputs[2]["mla"]).max()
    assert 0.5 < scale < 20, scale
    for shape in RECIPE_MESHES:
        for mode in ("tp", "sp"):
            np.testing.assert_allclose(reference[("mla", shape, mode)][0], inputs[2]["mla"],
                                       rtol=0, atol=ATOL / 2, err_msg=f"{shape} {mode}")
