"""The logits under a sharding recipe stay cut as the reference's ``logits``
spec ``P(B, None, mp)`` cuts them, and the loss is taken vocab-parallel on
that block.

* On 4 gloo ranks of each mesh ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` (one
  job a mesh), phi4-mini SMOKE in float32 at 8 x 32 tokens, under ``tp``
  and ``sp`` (and ``sp_ring`` on ``(1, 4)``): each rank's ``lm.forward``
  logits are its ``(B / D, S, vocab_padded / M)`` block, equal to the
  reference's single-device ``lm.forward`` logits cut by ``P(B, None,
  mp)`` within ``1e-5`` (the recipe forward tests' tolerance); the loss,
  its metrics and the gradients (gathered back whole) equal the
  reference's ``loss_fn`` and ``jax.grad`` within the recipe training
  tests' tolerances (loss ``1e-4``, gradients ``rtol=1e-4, atol=1e-6``),
  every rank holding the same loss.  The ``loss_mask`` zeroes every token
  of rows 0-3 (all the rows of a ``data`` rank on ``(2, 2)`` and of two on
  ``(4, 1)``) and a fifth of the others, and the labels fall in every
  ``model`` rank's vocab block.  The tied head (``tie_embeddings``, the
  head ``embed.T``) rides under ``tp`` on ``(2, 2)`` and ``sp_ring`` on
  ``(1, 4)``.
* The dry run's walk of one rank (a fake world of 16 ranks, a ``(4, 4)``
  mesh): a training step and a prefill forward hold no storage larger than
  the rank's block of the logits and peak below the whole logits' bytes.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_recipe import RECIPE_MESHES
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.core.dist import init_fake_world, make_mesh
from repro_torch.launch import op_walk
from repro_torch.models import lm
from repro_torch.models.sharding import RankBatch, local_batch, make_recipe, use_recipe
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

B, S = 8, 32
MODELS = {"untied": {}, "tied": {"tie_embeddings": True}}
CASES = ([(shape, "untied", mode) for shape in RECIPE_MESHES for mode in ("tp", "sp")]
         + [((1, 4), "untied", "sp_ring"), ((2, 2), "tied", "tp"), ((1, 4), "tied", "sp_ring")])


def _ids(case):
    (d, m), name, mode = case
    return f"{d}x{m}-{name}-{mode}"


@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(30)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    mask[:4] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}
    out = {"batch": batch, "models": {}}
    for name, overrides in MODELS.items():
        cfg = dataclasses.replace(jconfigs.get("phi4-mini-3.8b", smoke=True),
                                  act_dtype=jnp.float32, **overrides)
        params = jlm.init_model(cfg, jax.random.PRNGKey(0))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, _ = jlm.forward(params, {"tokens": jb["tokens"]}, cfg)
        (loss, metrics), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(params, jb, cfg)
        out["models"][name] = dict(
            tree=jax.tree.map(np.asarray, params), logits=np.asarray(logits), loss=float(loss),
            metrics={k: float(v) for k, v in metrics.items()},
            grads=[np.asarray(g) for g in jax.tree.leaves(grads)], vocab_padded=cfg.vocab_padded)
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            modes = {name: [mode for s, n, mode in CASES if s == shape and n == name]
                     for name in MODELS}
            models = {name: (MODELS[name], reference["models"][name]["tree"]) for name in MODELS
                      if modes[name]}
            cache[shape] = run_gloo("_torch_recipe:logits_cut", 4,
                                    tmp_path_factory.mktemp("gloo_logits_cut"), shape=shape,
                                    models=models, batch=reference["batch"], modes=modes)
        return cache[shape]

    return get


def test_labels_fall_in_every_model_ranks_vocab_block(reference):
    labels = reference["batch"]["labels"]
    vl = reference["models"]["untied"]["vocab_padded"] // 4
    assert set(np.unique(labels // vl)) == {0, 1, 2, 3}
    assert not reference["batch"]["loss_mask"][:4].any()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_holds_its_block_of_the_reference_logits(reference, port, case):
    shape, name, mode = case
    want = reference["models"][name]["logits"]
    D, M = shape
    for rank, got in enumerate(port(shape)):
        d, r = got["coords"]["data"], got["coords"]["model"]
        rows, vl = B // D, want.shape[-1] // M
        block = want[d * rows:(d + 1) * rows, :, r * vl:(r + 1) * vl]
        logits = got[(name, mode, "logits")]
        assert logits.shape == block.shape, (rank, logits.shape)
        np.testing.assert_allclose(logits, block, rtol=0, atol=1e-5,
                                   err_msg=f"{shape} {name} {mode} rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_vocab_parallel_loss_and_grads_match_the_reference(reference, port, case):
    shape, name, mode = case
    ref = reference["models"][name]
    ranks = port(shape)
    assert len({got[(name, mode, "loss")] for got in ranks}) == 1
    for rank, got in enumerate(ranks):
        assert abs(got[(name, mode, "loss")] - ref["loss"]) < 1e-4
        for k in ("nll", "aux", "ppl_proxy"):
            np.testing.assert_allclose(got[(name, mode, "metrics")][k], ref["metrics"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert len(got[(name, mode, "grads")]) == len(ref["grads"])
        for i, (g, w) in enumerate(zip(got[(name, mode, "grads")], ref["grads"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{shape} {name} {mode} rank {rank} grad leaf {i}")


# ------------------------------------------------------------- dry run ----

@pytest.fixture
def world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dry_run_holds_no_whole_logits(world, kind):
    """Rank 0 of a (4, 4) mesh on a fake world of 16, phi4-mini SMOKE in
    float32 with its vocab widened to 16,384 so that the logits dominate:
    the whole logits of 8 x 64 tokens are 32 MiB, the rank's block (2 rows,
    4,096 columns) 2 MiB, while the largest weight the rank gathers (the
    head's 64 x 4,096 block) is 1 MiB and an activation of its rows 32 KiB.
    The walk holds no storage larger than the block, and its peak, the
    loss's float32 passes and the cotangents included, stays below the
    whole logits' bytes (a program that gathers them holds at least
    that)."""
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), vocab=16384,
                              act_dtype=torch.float32)
    batch_rows, seq, (D, M) = 8, 64, (4, 4)
    whole = batch_rows * seq * cfg.vocab_padded * 4
    block = whole // (D * M)
    init_fake_world(D * M, 0, "cpu")
    mesh = make_mesh((D, M), ("data", "model"), device="cpu")
    recipe = make_recipe(cfg, mesh, attn_mode="tp")
    with torch._subclasses.fake_tensor.FakeTensorMode():
        params = lm.abstract_model(cfg, recipe=recipe, device="cpu")
        batch = local_batch(recipe, {k: torch.empty((batch_rows, seq), dtype=torch.int32)
                                     for k in ("tokens", "labels")})
        if kind == "train":
            ocfg = OptConfig()
            opt = init_opt_state(params, ocfg)
            with op_walk.OpWalk() as walk:
                make_train_step(cfg, recipe, ocfg)(params, opt, batch)
        else:
            with op_walk.OpWalk() as walk:
                with use_recipe(recipe), torch.no_grad():
                    logits, _ = lm.forward(
                        params, RankBatch({"tokens": batch["tokens"]}, batch.shapes), cfg)
                assert logits.shape == (batch_rows // D, seq, cfg.vocab_padded // M)
                del logits
    st = walk.stats()
    assert st.largest_storage_bytes <= block, (st.largest_storage_bytes, block)
    assert st.peak_live_bytes < whole, (st.peak_live_bytes, whole)
