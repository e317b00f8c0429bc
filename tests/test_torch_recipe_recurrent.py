"""The SSM (rwkv6) and hybrid (zamba2) families' forward under ``tp``,
plain ``sp`` and ``sp_ring`` recipes on gloo CPU ranks, against the
reference.

``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode=...)`` runs on 4
gloo ranks of the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)``
meshes, every rank on its shards (``shard_params_by_recipe``), over 4 x 32
tokens of the SMOKE configs (float32; the reference's seeded weights with
their constant leaves perturbed, ``tests/_torch_families.py``).  zamba2's
fused ``i`` dim (296) divides 2 but not 4, so ``w_in`` and ``norm_w`` are
cut on ``(2, 2)`` and whole on ``(1, 4)``, while the conv's ``c`` (160) is
cut on both.

* ``tp`` and ``sp`` against the reference's own GSPMD program (``jax.jit``
  under ``use_recipe``, parameters and batch placed by its shardings) on 4
  fake devices, within ``ATOL = 5e-5`` on logits up to 4 in magnitude.
  Measured on these inputs: the port's per-rank program is at most 1.9e-5
  from the reference's sharded one; the reference's sharded program is up
  to 1.3e-5 from its own single-device forward, and the two packages'
  single-device forwards are 1.6e-5 apart (float32 sums in other orders).
* ``sp_ring`` against the reference's single-device ``lm.forward`` (its
  sharded ring is a ``check_rep`` failure on this jax), within the same
  ``ATOL`` (measured: at most 1.6e-5).
* Every rank returns the same logits; the shards really are cut, and
  gathered back they are the whole tree bitwise.
* On a one-rank ``(1, 1)`` mesh every mode is the no-recipe forward,
  bitwise (``tests/test_torch_recipe.py``).
* Mixers whose heads do not divide ``model``: rwkv6 with 2 heads and
  zamba2 with 2 Mamba2 heads (and 2 attention heads) on ``(1, 4)`` under
  ``tp``, where every rank runs the whole mixer on weights gathered over
  ``model`` and keeps its block of a state cut along RWKV's value columns
  or Mamba2's head dim: the forward against the reference's single-device
  forward of the same config within ``ATOL``, and 4 decode steps against
  the reference's, every state leaf of its local shape.
"""
import pickle

import numpy as np
import pytest

import jax

from _torch_dist import TESTS, run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import RECIPE_BATCH, RECIPE_MESHES, RECURRENT_ARCHS, RECURRENT_MODES, \
    RECURRENT_SEQ
from repro.models import lm as jlm

ATOL = 5e-5

_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
from repro import configs
from repro.models import lm
from repro.models.sharding import make_recipe, use_recipe, batch_shardings
from repro.core.compat import make_mesh
from _torch_recipe import RECIPE_MESHES

with open({inputs!r}, "rb") as f:
    trees, tokens = pickle.load(f)
out = {{}}
for arch, tree in trees.items():
    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=jnp.float32,
                              attn_impl="interpret")
    params = jax.tree.map(jnp.asarray, tree)
    specs = lm.build_specs(cfg)
    b = {{"tokens": jnp.asarray(tokens[arch])}}
    for shape in RECIPE_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        for mode in ("tp", "sp"):
            r = make_recipe(cfg, mesh, attn_mode=mode)
            pd = jax.tree.map(lambda x, s: jax.device_put(x, s), params, r.param_shardings(specs))
            bd = {{"tokens": jax.device_put(b["tokens"], batch_shardings(r, b)["tokens"])}}

            def f(p, b, r=r):
                with use_recipe(r):
                    return lm.forward(p, b, cfg)[0]

            with mesh:
                out[(arch, shape, mode)] = np.asarray(jax.jit(f)(pd, bd))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def inputs():
    trees, toks, single = {}, {}, {}
    for i, arch in enumerate(RECURRENT_ARCHS):
        jcfg, jp, _, _ = family_models(arch)
        trees[arch] = jax.tree.map(np.asarray, jp)
        toks[arch] = family_tokens(jcfg, (RECIPE_BATCH, RECURRENT_SEQ), 30 + i)
        single[arch] = np.asarray(jlm.forward(jp, {"tokens": toks[arch]}, jcfg)[0])
    return trees, toks, single


@pytest.fixture(scope="module")
def reference(distributed, inputs, tmp_path_factory):
    trees, toks, _ = inputs
    d = tmp_path_factory.mktemp("jax_recipe_recurrent")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump((trees, toks), f)
    path = str(d / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, inputs=str(d / "inputs.pkl"),
                                                 path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    trees, toks, _ = inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:forward_recurrent", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_recurrent"),
                                    shape=shape, models=trees, tokens=toks)
        return cache[shape]

    return get


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", RECURRENT_MODES)
def test_forward_matches_reference(reference, inputs, port, arch, shape, mode):
    want = inputs[2][arch] if mode == "sp_ring" else reference[(arch, shape, mode)]
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[(arch, mode)], want, rtol=0, atol=ATOL,
                                   err_msg=f"{arch} {shape} {mode} rank {rank}")
        np.testing.assert_array_equal(got[(arch, mode)], ranks[0][(arch, mode)])
        assert got[(arch, mode, "gathered")]
        assert got[(arch, mode, "cut")]


def test_reference_sharded_program_is_near_its_single_device_forward(reference, inputs):
    """The yardstick of ``ATOL``: the reference's GSPMD program against its
    own single-device forward on the same inputs, within half of it, on
    logits of the scale the docstring states."""
    for arch in RECURRENT_ARCHS:
        scale = np.abs(inputs[2][arch]).max()
        assert 0.5 < scale < 20, (arch, scale)
        for shape in RECIPE_MESHES:
            for mode in ("tp", "sp"):
                np.testing.assert_allclose(reference[(arch, shape, mode)], inputs[2][arch],
                                           rtol=0, atol=ATOL / 2, err_msg=f"{arch} {shape} {mode}")


WHOLE_MIXERS = {"rwkv6-3b": dict(n_heads=2, n_kv=2),
                "zamba2-7b": dict(n_heads=2, n_kv=2, ssm_head_dim=64)}


def test_mixers_whose_heads_do_not_divide_the_model_axis(tmp_path):
    import jax.numpy as jnp

    trees, toks, want = {}, {}, {}
    for i, (arch, over) in enumerate(WHOLE_MIXERS.items()):
        jcfg, jp, _, _ = family_models(arch, **over)
        trees[arch] = jax.tree.map(np.asarray, jp)
        toks[arch] = family_tokens(jcfg, (2, RECURRENT_SEQ), 50 + i)
        state = jlm.DecodeState(jlm.init_cache(jcfg, 2, 16), jnp.zeros((2,), jnp.int32))
        steps = []
        for t in range(4):
            logits, state = jlm.decode_step(jp, state, {"tokens": toks[arch][:, t:t + 1]}, jcfg)
            steps.append(np.asarray(logits))
        want[arch] = (np.asarray(jlm.forward(jp, {"tokens": toks[arch]}, jcfg)[0]), steps)
    ranks = run_gloo("_torch_recipe:recurrent_whole_mixers", 4, tmp_path, shape=(1, 4),
                     models=trees, overrides=WHOLE_MIXERS, tokens=toks, steps=4)
    for rank, got in enumerate(ranks):
        for arch in WHOLE_MIXERS:
            np.testing.assert_allclose(got[(arch, "forward")], want[arch][0], rtol=0, atol=ATOL,
                                       err_msg=f"{arch} rank {rank}")
            for t, (g, w) in enumerate(zip(got[(arch, "decode")], want[arch][1], strict=True)):
                np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                           err_msg=f"{arch} rank {rank} step {t}")
            assert got[(arch, "local")], (arch, rank)
    # the wkv state (L, B, H, K, V) cut along V; the ssm state (.., B, H, P, N) along P
    wkv = ranks[0][("rwkv6-3b", "state_cut")][0]
    assert wkv[2:] == (None, None, "model"), wkv
    ssm = [s for s in ranks[0][("zamba2-7b", "state_cut")] if len(s) == 6]
    assert ssm and all(s[3:] == (None, "model", None) for s in ssm), ssm
