"""The port's serving engine against the reference's, on the CPU.

Both engines run the same weights (``params_from_jax``) at float32
activations: the reference with its Pallas kernels in interpret mode, the
port with its kernels' plain versions (CPU tensors).  Greedy decoding must
give the same tokens, request for request, with more requests than slots
(admission staggers: requests wait for a slot, and a slot's prefill runs
while other slots are resident) and on the biased config.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import Engine, ServeConfig


def _engines(arch, *, slots, max_len, attn):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.float32,
                               attn_impl=attn[0])
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), act_dtype=torch.float32,
                               attn_impl=attn[1])
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            shape = jp["blocks"]["attn"][name].shape
            jp["blocks"]["attn"][name] = jnp.asarray(
                0.5 * rng.standard_normal(shape).astype(np.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = JEngine(jcfg, jp, JServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1))
    teng = Engine(tcfg, tp, ServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1))
    return jeng, teng


@pytest.mark.parametrize("arch,attn", [
    ("phi4-mini-3.8b", ("interpret", None)),   # the kernels: Pallas vs plain versions
    ("qwen2.5-32b", ("interpret", None)),      # qkv bias
    ("phi4-mini-3.8b", ("jnp", "jnp")),        # the dense decode route on both sides
])
def test_greedy_tokens_match_reference_engine(arch, attn):
    jeng, teng = _engines(arch, slots=2, max_len=64, attn=attn)
    rng = np.random.default_rng(0)
    for rid in range(4):
        prompt = rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist()
        max_new = int(rng.integers(3, 8))
        jeng.submit(rid, prompt, max_new)
        teng.submit(rid, prompt, max_new)
    want = jeng.run()
    got = teng.run()
    assert sorted(got) == list(range(4))
    assert got == want
    # 2 slots for 4 requests: a later request was prefilled while a slot was resident
    assert teng.steps["prefill"] >= 2
    assert teng.ledger.lengths == [0, 0]


def test_engine_rejects_what_is_not_ported():
    cfg = tconfigs.get("phi4-mini-3.8b", smoke=True)
    from repro_torch.models import lm

    from repro_torch.models.sharding import make_recipe

    class _Mesh:  # what make_recipe reads of a mesh
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    # a recipe serves every family; it cuts MLA's latent caches along their
    # sequence, so a cache length that does not divide the model axis is refused
    mla = tconfigs.get("minicpm3-4b", smoke=True)
    mla_params = lm.init_model(mla, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="must divide the model axis"):
        Engine(mla, mla_params, ServeConfig(max_len=15), recipe=make_recipe(mla, _Mesh()))
    # a recipe with the explicit TP decode: the recipe must be cut on the TP
    # step's mesh, and the TP step takes no MoE blocks
    with pytest.raises(ValueError, match="recipe.mesh is not mesh"):
        Engine(cfg, params, ServeConfig(), recipe=make_recipe(cfg, _Mesh()), mesh=_Mesh(),
               microbatches=1)
    moe = tconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    mesh = _Mesh()
    with pytest.raises(ValueError, match="MoE blocks not supported"):
        Engine(moe, lm.init_model(moe, torch.Generator().manual_seed(0), device="cpu"),
               ServeConfig(), recipe=make_recipe(moe, mesh), mesh=mesh, microbatches=1)
    with pytest.raises(ValueError, match="microbatches"):
        Engine(cfg, params, ServeConfig(), mesh=object())
    with pytest.raises(ValueError, match="max_len"):
        Engine(cfg, params, ServeConfig(max_len=16)).submit(0, [3] * 10, 10)
