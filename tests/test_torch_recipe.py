"""The sharding recipe's weight bindings and the dense family's forward
under ``tp`` and plain ``sp`` recipes, on gloo CPU ranks, against the
reference's sharded program.

* ``Recipe.param_pspecs`` equals the reference's, tuple for tuple, for
  every ported architecture (published and SMOKE configs) under every mode
  on the meshes ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``: the bindings and
  the priority rule for two dims of one weight bound to the same axis;
  and so do ``batch_shardings`` and ``decode_state_shardings`` (the
  reference's ``NamedSharding`` specs, trailing ``None`` entries dropped).
* ``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode=...)`` on 4 gloo
  ranks of each mesh, every rank holding its shards, against the
  reference's own GSPMD program (``jax.jit`` under ``use_recipe``, its
  parameters and batch placed by ``param_shardings``/``batch_shardings``)
  on 4 fake devices: phi4-mini (tied embeddings, 2 KV groups, so ``g`` is
  unbound on ``(1, 4)``) at 4 x 32 tokens and qwen2.5 (QKV biases, a
  separate head) at 4 x 30 (a ragged ``sp`` chunking), float32, within
  ``1e-5``: about 4x the reference's own sharded-vs-single-device
  difference on these inputs (2.3e-6 to 4e-6).  Every rank returns the
  same logits; the shards really are cut, and gathered back they are the
  whole tree bitwise.
* The families still to port under a recipe (MoE, MLA) refuse, the SSM
  and hybrid families under ``tp`` on one rank are the no-recipe forward
  bitwise (their multi-rank program: ``tests/test_torch_recipe_recurrent*.py``),
  and whole parameters where shards are expected are refused with a hint.
"""
import dataclasses
import pickle
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import TESTS, run_gloo
from _torch_recipe import RECIPE_ARCHS, RECIPE_BATCH, RECIPE_MESHES, RECIPE_MODES
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.sharding import make_recipe as jmake_recipe
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import RankBatch, local_batch, make_recipe, use_recipe

ALL_MODES = ("auto", "tp", "sp", "sp_ring")

_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
from repro import configs
from repro.models import lm
from repro.models.sharding import (make_recipe, use_recipe, batch_shardings,
                                   decode_state_shardings)
from repro.core.compat import make_mesh
from _torch_recipe import RECIPE_MESHES, RECIPE_MODES

with open({inputs!r}, "rb") as f:
    tokens = pickle.load(f)
out = {{}}
for arch in tokens:
    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=jnp.float32)
    params = lm.init_model(cfg, jax.random.PRNGKey(0))
    specs = lm.build_specs(cfg)
    for shape in RECIPE_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        for mode in RECIPE_MODES + ("sp_ring",):
            r = make_recipe(cfg, mesh, attn_mode=mode)
            b = {{"tokens": jnp.asarray(tokens[arch]), "labels": jnp.asarray(tokens[arch])}}
            out[(arch, shape, mode, "batch")] = {{
                k: tuple(s.spec) for k, s in batch_shardings(r, b).items()}}
            state = jax.eval_shape(lambda: lm.init_cache(cfg, 8, 64))
            out[(arch, shape, mode, "state")] = [
                tuple(s.spec) for s in jax.tree.leaves(decode_state_shardings(r, state))]
            if mode == "sp_ring":
                continue
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


def _tokens():
    out = {}
    for i, (arch, S) in enumerate(RECIPE_ARCHS.items()):
        vocab = tconfigs.get(arch, smoke=True).vocab
        out[arch] = np.random.default_rng(30 + i).integers(
            0, vocab, (RECIPE_BATCH, S)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in RECIPE_ARCHS:
        cfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.float32)
        params = jlm.init_model(cfg, jax.random.PRNGKey(0))
        out[arch] = jax.tree.map(np.asarray, params)
    return out


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_recipe")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(_tokens(), f)
    path = str(d / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, inputs=str(d / "inputs.pkl"),
                                                 path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(models, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:forward_family", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_fwd"), shape=shape,
                                    models=models, tokens=_tokens())
        return cache[shape]

    return get


def _fake_mesh(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shape[0], "model": shape[1]})


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
def test_param_pspecs_match_reference(arch, smoke):
    tcfg, jcfg = tconfigs.get(arch, smoke=smoke), jconfigs.get(arch, smoke=smoke)
    tspecs, jspecs = tlm.build_specs(tcfg), jlm.build_specs(jcfg)
    for shape in RECIPE_MESHES:
        for mode in ALL_MODES:
            with warnings.catch_warnings():  # n_experts not dividing model: both warn
                warnings.simplefilter("ignore")
                jr = jmake_recipe(jcfg, _fake_mesh(shape), attn_mode=mode)
                tr = make_recipe(tcfg, _fake_mesh(shape), attn_mode=mode)
            want = [tuple(p) for p in jax.tree.leaves(
                jr.param_pspecs(jspecs), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
            got = tree_leaves(tr.param_pspecs(tspecs))
            assert got == want, (arch, shape, mode)


@pytest.mark.parametrize("arch", list(RECIPE_ARCHS))
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", RECIPE_MODES + ("sp_ring",))
def test_batch_and_decode_state_shardings_match_reference(reference, arch, shape, mode):
    from repro_torch.models.sharding import batch_shardings, decode_state_shardings

    def strip(spec):
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    cfg = tconfigs.get(arch, smoke=True)
    r = make_recipe(cfg, _fake_mesh(shape), attn_mode=mode)
    toks = torch.zeros((RECIPE_BATCH, RECIPE_ARCHS[arch]), dtype=torch.long)
    got = {k: strip(v) for k, v in batch_shardings(r, {"tokens": toks, "labels": toks}).items()}
    assert got == reference[(arch, shape, mode, "batch")]
    state = tlm.init_cache(cfg, 8, 64, device="cpu")
    leaves = [strip(s) for s in decode_state_shardings(r, state)]
    assert leaves == reference[(arch, shape, mode, "state")]


@pytest.mark.parametrize("arch", list(RECIPE_ARCHS))
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", RECIPE_MODES)
def test_forward_matches_reference_sharded_program(reference, port, arch, shape, mode):
    ranks = port(shape)
    want = reference[(arch, shape, mode)]
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[(arch, mode)], want, rtol=0, atol=1e-5,
                                   err_msg=f"{arch} {shape} {mode} rank {rank}")
        np.testing.assert_array_equal(got[(arch, mode)], ranks[0][(arch, mode)])
        assert got[(arch, mode, "gathered")]
        assert got[(arch, mode, "cut")]


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "minicpm3-4b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_families_still_to_port_refuse_tp(arch):
    """Every family runs under ``tp`` (the MoE and MLA families since
    item 8c's third PR, the SSM and hybrid families before them): on a
    one-rank ``(1, 1)`` mesh the logits and the aux loss are the no-recipe
    forward's, bitwise.  ``tests/test_torch_recipe_mla.py`` and
    ``tests/test_torch_recipe_moe.py`` hold the MLA and MoE families across
    ranks."""
    cfg = tconfigs.get(arch, smoke=True)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = _fake_mesh((1, 1))
    mesh.coords = lambda: {"data": 0, "model": 0}
    mesh.create_groups = lambda axes: None
    recipe = make_recipe(cfg, mesh, attn_mode="tp")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, want_aux = tlm.forward(params, {"tokens": toks}, cfg)
        with use_recipe(recipe):
            got, aux = tlm.forward(params, local_batch(recipe, {"tokens": toks}), cfg)
    assert torch.equal(got, want)
    assert torch.equal(aux, want_aux)


def test_whole_params_where_shards_are_expected_are_refused():
    cfg = dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), act_dtype=torch.float32)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    recipe = make_recipe(cfg, _fake_mesh((1, 2)), attn_mode="tp")
    batch = RankBatch({"tokens": torch.zeros((2, 8), dtype=torch.long)}, {"tokens": (2, 8)})
    with use_recipe(recipe), pytest.raises(ValueError, match="shard_params_by_recipe"):
        tlm.forward(params, batch, cfg)
