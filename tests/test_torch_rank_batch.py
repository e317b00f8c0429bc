"""Each rank is handed its own block of the batch under a sharding recipe.

* ``sharding.local_batch`` against the reference's own placement: in a
  4-fake-device JAX subprocess, the addressable shards of
  ``jax.device_put(x, batch_shardings(recipe, x))`` on the ``(1, 4)``,
  ``(2, 2)`` and ``(4, 1)`` meshes, bitwise, for every rank: token ids,
  labels and a mask with B dividing the ``data`` axis and not (6 rows on 4
  ``data`` ranks: every rank holds every row), the audio family's ``embeds``
  under ``sp_ring`` (cut by sequence over ``model`` where it divides S,
  whole where S is ragged), the VLM's image, a decode step's one position,
  and ``microbatches=2`` (the reference's placement of each microbatch, the
  rank's blocks one microbatch after another).
* Training with ``microbatches=2`` under ``tp``, ``sp`` and ``sp_ring`` on 4
  gloo ranks of ``(2, 2)`` and ``(4, 1)``, a dense and a MoE model (the
  capacity dispatch, which routes each microbatch's tokens together), with
  a ``loss_mask`` whose counts differ between the microbatches: loss,
  metrics, gradients and the stepped parameters against the reference's
  single-device ``make_train_step`` at the recipe training tests'
  tolerances (``tests/test_torch_recipe_mla_train.py``).  Handing each rank
  its contiguous block of the global rows instead gives the wrong
  microbatches, and the loss misses the reference's.
* A whole dict under a recipe raises ``TypeError`` naming the entry point;
  blocks laid out for another microbatch count, or of another shape, raise
  ``ValueError``.
* The dry run's ``batch_bytes`` is a rank's: 1/16 of the global batch at
  16 x 16 for the VLM's and musicgen's cells (the sum of the
  ``local_shape`` blocks), the whole batch where B = 1 (``long_500k``).
"""
import dataclasses
import math
import pickle
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_families import models as family_models
from _torch_families import tokens as family_tokens
from _torch_recipe import LATENT_MOE_MODES
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import batch_specs
from repro_torch.models import lm as tlm
from repro_torch.models.sharding import (RankBatch, local_batch, local_batch_shapes,
                                         make_recipe, use_recipe)
from repro_torch.train import trainer as ttr

MESHES = [(1, 4), (2, 2), (4, 1)]


def _fake_mesh(shape, coords):
    """What ``make_recipe`` and ``local_batch`` read of a mesh: this rank at
    ``coords``."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shape[0], "model": shape[1]},
                                 coords=lambda: {"data": coords[0], "model": coords[1]},
                                 create_groups=lambda axes: None)


def _placement_cases() -> dict:
    """``{case: (arch, mode, microbatches, decode, batch)}``, numpy batches."""
    rng = np.random.default_rng(35)

    def ids(B, S):
        return rng.integers(0, 500, (B, S)).astype(np.int32)

    def tokens(B, S):
        return {"tokens": ids(B, S), "labels": ids(B, S),
                "loss_mask": (rng.random((B, S)) < 0.5).astype(np.float32)}

    def frames(B, S):
        return {"embeds": rng.standard_normal((B, S, 64)).astype(np.float32),
                "labels": ids(B, S)}

    image = {"tokens": ids(4, 8), "image_embeds": rng.standard_normal((4, 16, 64))
             .astype(np.float32)}
    return {
        "tokens_tp": ("phi4-mini-3.8b", "tp", 1, False, tokens(8, 8)),
        "tokens_sp_ring": ("phi4-mini-3.8b", "sp_ring", 1, False, tokens(8, 8)),
        "tokens_ragged_rows": ("phi4-mini-3.8b", "tp", 1, False, tokens(6, 8)),
        "tokens_microbatches": ("phi4-mini-3.8b", "sp", 2, False, tokens(8, 8)),
        "tokens_ragged_microbatches": ("phi4-mini-3.8b", "tp", 2, False, tokens(12, 8)),
        "embeds_sp_ring": ("musicgen-large", "sp_ring", 1, False, frames(4, 8)),
        "embeds_sp_ring_ragged_seq": ("musicgen-large", "sp_ring", 1, False, frames(4, 6)),
        "embeds_sp_ring_microbatches": ("musicgen-large", "sp_ring", 2, False, frames(8, 8)),
        "embeds_tp": ("musicgen-large", "tp", 1, False, frames(4, 8)),
        "embeds_decode": ("musicgen-large", "sp_ring", 1, True, frames(8, 1)),
        "image": ("llama-3.2-vision-11b", "tp", 1, False, image),
    }


CASES = _placement_cases()

_PLACEMENT = """
import pickle
import numpy as np, jax
import repro.core.compat as compat
from repro import configs
from repro.models.sharding import make_recipe, batch_shardings

with open({inputs!r}, "rb") as f:
    cases, meshes = pickle.load(f)
out = {{}}
for key, (arch, mode, k, _, batch) in cases.items():
    cfg = configs.get(arch, smoke=True)
    for shape in meshes:
        mesh = compat.make_mesh(shape, ("data", "model"))
        r = make_recipe(cfg, mesh, attn_mode=mode)
        where = {{d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
                 for d in mesh.devices.flat}}
        for name, x in batch.items():
            parts = {{}}
            n = x.shape[0] // k
            for i in range(k):  # the reference's placement of each microbatch
                xi = x[i * n:(i + 1) * n]
                arr = jax.device_put(xi, batch_shardings(r, {{name: xi}})[name])
                for s in arr.addressable_shards:
                    parts.setdefault(where[s.device.id], []).append(np.asarray(s.data))
            for coords, ps in parts.items():
                out[(key, shape, name, coords)] = np.concatenate(ps)
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def placed(distributed, tmp_path_factory):
    d = tmp_path_factory.mktemp("rank_batch_placement")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump((CASES, MESHES), f)
    assert "OK" in distributed(_PLACEMENT.format(inputs=str(d / "inputs.pkl"),
                                                 path=str(d / "placed.pkl")), devices=4)
    with open(d / "placed.pkl", "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_local_batch_is_the_reference_placement(placed, case, shape):
    arch, mode, k, decode, batch = CASES[case]
    cfg = tconfigs.get(arch, smoke=True)
    for d in range(shape[0]):
        for m in range(shape[1]):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                recipe = make_recipe(cfg, _fake_mesh(shape, (d, m)), attn_mode=mode)
            got = local_batch(recipe, batch, microbatches=k, decode=decode)
            assert isinstance(got, RankBatch) and got.microbatches == k
            assert got.shapes == {n: x.shape for n, x in batch.items()}
            want_shapes = local_batch_shapes(recipe, got.shapes, microbatches=k, decode=decode)
            for name, x in got.items():
                where = f"{case} {shape} rank {(d, m)} {name}"
                assert x.shape == want_shapes[name], where
                np.testing.assert_array_equal(x, placed[(case, shape, name, (d, m))],
                                              err_msg=where)


def test_microbatch_split_gives_each_microbatchs_block():
    """The trainer's consecutive split of blocks laid out for 2
    microbatches is, microbatch by microbatch, ``local_batch`` of that
    microbatch's global rows, whose global shapes have ``B/2`` rows."""
    x = {"tokens": np.arange(8 * 3, dtype=np.int32).reshape(8, 3)}
    cfg = tconfigs.get("phi4-mini-3.8b", smoke=True)
    for d in range(2):
        recipe = make_recipe(cfg, _fake_mesh((2, 2), (d, 1)), attn_mode="tp")
        parts = ttr._split_batch(local_batch(recipe, x, microbatches=2), 2)
        for i, part in enumerate(parts):
            want = local_batch(recipe, {"tokens": x["tokens"][4 * i:4 * i + 4]})
            assert isinstance(part, RankBatch) and part.shapes == {"tokens": (4, 3)}
            np.testing.assert_array_equal(part["tokens"], want["tokens"])
        with pytest.raises(ValueError, match="laid out for 2 microbatches"):
            ttr._split_batch(local_batch(recipe, x, microbatches=2), 4)


def test_zero_local_batch_is_the_contiguous_data_block():
    """The ZeRO step's block: rows ``[r*n, (r+1)*n)``, the reference's
    ``shard_map`` block ``P("data")``."""
    x = {"tokens": np.arange(8 * 2).reshape(8, 2), "labels": np.arange(8 * 2).reshape(8, 2)}
    for r in range(4):
        mesh = types.SimpleNamespace(shape={"data": 4}, coords=lambda r=r: {"data": r})
        got = ttr.zero_local_batch(mesh, x)
        for k in x:
            np.testing.assert_array_equal(got[k], x[k][2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="does not split"):
        ttr.zero_local_batch(types.SimpleNamespace(shape={"data": 3}, coords=lambda: {"data": 0}),
                             x)


# -------------------------------------------------- a whole dict raises ----

def _recipe():
    cfg = dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), act_dtype=torch.float32)
    return cfg, make_recipe(cfg, _fake_mesh((2, 2), (1, 0)), attn_mode="tp")


def _whole():
    toks = torch.zeros((4, 8), dtype=torch.long)
    return {"tokens": toks, "labels": toks}


ENTRY_POINTS = {
    "lm.forward": lambda cfg, r, b: (use_recipe(r), lambda: tlm.forward(None, b, cfg)),
    "lm.loss_fn": lambda cfg, r, b: (use_recipe(r), lambda: tlm.loss_fn(None, b, cfg)),
    "lm.decode_step": lambda cfg, r, b: (use_recipe(r),
                                         lambda: tlm.decode_step(None, None, b, cfg)),
    "make_train_step": lambda cfg, r, b: (use_recipe(None), lambda: ttr.make_train_step(
        cfg, r, None)(None, None, b)),
    "make_eval_step": lambda cfg, r, b: (use_recipe(None),
                                         lambda: ttr.make_eval_step(cfg, r)(None, b)),
    "make_serve_step": lambda cfg, r, b: (use_recipe(None),
                                          lambda: ttr.make_serve_step(cfg, r)(None, None, b)),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_whole_dict_under_a_recipe_raises(entry):
    cfg, recipe = _recipe()
    ctx, call = ENTRY_POINTS[entry](cfg, recipe, _whole())
    with ctx, pytest.raises(TypeError, match=entry.replace(".", r"\.")):
        call()


def test_blocks_of_another_layout_or_shape_are_refused():
    cfg, recipe = _recipe()
    two = local_batch(recipe, _whole(), microbatches=2)
    with use_recipe(recipe), pytest.raises(ValueError, match="laid out for 2 microbatches"):
        tlm.forward(None, two, cfg)
    with pytest.raises(ValueError, match="laid out for 2 microbatches"):
        ttr.make_train_step(cfg, recipe, None)(None, None, two)
    other = local_batch(recipe, _whole())
    wrong = RankBatch({k: v[:1] for k, v in other.items()}, other.shapes)
    with use_recipe(recipe), pytest.raises(ValueError, match="this rank's block"):
        tlm.forward(None, wrong, cfg)
    with pytest.raises(TypeError, match="already this rank's blocks"):
        local_batch(recipe, other)


# ------------------------------------------------- microbatched training ----

OCFG = dict(lr=1e-3, warmup_steps=0)
TRAIN_MESHES = [(2, 2), (4, 1)]
TRAIN_B, TRAIN_S, K = 8, 16, 2
TRAIN_MODELS = {"dense": "phi4-mini-3.8b", "moe": "phi3.5-moe-42b-a6.6b"}


def _train_batch(cfg, seed):
    """8 x 16 tokens and a ``loss_mask`` whose counts differ between the
    two microbatches (rows 0-3 keep about 90% of their positions, rows 4-7
    about 30%, every row at least one)."""
    toks = family_tokens(cfg, (TRAIN_B, TRAIN_S + 1), seed)
    keep = np.repeat([0.9, 0.3], TRAIN_B // K)[:, None]
    mask = (np.random.default_rng(seed + 1).random((TRAIN_B, TRAIN_S)) < keep)
    mask[:, 0] = True
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask.astype(np.float32)}


@pytest.fixture(scope="module")
def train_reference():
    out = {"trees": {}, "batch": {}}
    for i, (name, arch) in enumerate(TRAIN_MODELS.items()):
        jcfg, jp, _, _ = family_models(arch, attn_impl=None)
        batch = _train_batch(jcfg, 350 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ocfg = jopt.OptConfig(**OCFG)
        _, metrics, grads = jtr._accum_loss_grads(jp, jb, jcfg, K)
        new_p, _, m = jax.jit(jtr.make_train_step(jcfg, None, ocfg, microbatches=K))(
            jp, jopt.init_opt_state(jp, ocfg), jb)
        out["trees"][name] = (arch, {}, jax.tree.map(np.asarray, jp))
        out["batch"][name] = batch
        out[name] = dict(metrics={k: float(v) for k, v in m.items()},
                         grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                         params=[np.asarray(p) for p in jax.tree.leaves(new_p)])
    return out


@pytest.fixture(scope="module")
def trained(train_reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_named", 4,
                                    tmp_path_factory.mktemp("gloo_rank_batch_train"),
                                    timeout=400, shape=shape, models=train_reference["trees"],
                                    batch=train_reference["batch"], ocfg=OCFG, microbatches=K)
        return cache[shape]

    return get


@pytest.mark.parametrize("name", list(TRAIN_MODELS))
@pytest.mark.parametrize("shape", TRAIN_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_microbatched_step_on_rank_blocks_matches_reference(train_reference, trained, name,
                                                            shape, mode):
    want = train_reference[name]
    ranks = trained(shape)
    for rank, got in enumerate(ranks):
        where = f"{name} {shape} {mode} rank {rank}"
        m = got[(name, mode, "metrics")]
        for k in ("loss", "nll", "aux"):
            assert abs(m[k] - want["metrics"][k]) < 1e-4, (where, k, m[k], want["metrics"][k])
        np.testing.assert_allclose(m["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-5,
                                   err_msg=where)
        for i, (g, w) in enumerate(zip(got[(name, mode, "grads")], want["grads"], strict=True)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{where} grad {i}")
        for i, (p, w) in enumerate(zip(got[(name, mode, "params")], want["params"],
                                       strict=True)):
            np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4, err_msg=f"{where} leaf {i}")
            np.testing.assert_array_equal(p, ranks[0][(name, mode, "params")][i])


def test_contiguous_blocks_give_the_wrong_microbatches(train_reference, tmp_path):
    """The negative control: on ``(2, 2)`` each rank handed its contiguous
    block of the global rows (``[r*n, (r+1)*n)``) takes rows of both
    microbatches into each, and the loss misses the reference's."""
    ranks = run_gloo("_torch_recipe:train_named", 4, tmp_path, timeout=400, shape=(2, 2),
                     models={"dense": train_reference["trees"]["dense"]},
                     batch={"dense": train_reference["batch"]["dense"]}, ocfg=OCFG,
                     modes=("tp",), microbatches=K, contiguous=True)
    want = train_reference["dense"]["metrics"]["loss"]
    for got in ranks:
        assert abs(got[("dense", "tp", "metrics")]["loss"] - want) > 1e-3


# ---------------------------------------------------------- the dry run ----

@pytest.fixture
def world():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


DRYRUN_CELLS = [("llama-3.2-vision-11b", "train_4k", 5), ("musicgen-large", "train_4k", 2),
                ("musicgen-large", "prefill_32k", 2), ("musicgen-large", "long_500k", 2)]


@pytest.mark.parametrize("arch,shape,layers", DRYRUN_CELLS, ids=[f"{a}-{s}" for a, s, _ in
                                                                  DRYRUN_CELLS])
def test_dry_run_batch_bytes_are_a_ranks(world, arch, shape, layers):
    """``batch_bytes`` of rank 0 at 16 x 16: the sum of its blocks'
    ``local_shape``, 1/16 of the global batch where the 16 ``data`` ranks
    divide B (0.269, 0.537 and 0.537 GB), the whole batch at B = 1."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    rec = dryrun.lower_cell(arch, shape, sets=[f"n_layers={layers}"], device="cpu",
                            verbose=False)
    cfg = tconfigs.get(arch)
    specs = batch_specs(cfg, SHAPES[shape])
    whole = sum(math.prod(s) * d.itemsize for s, d in specs.values())
    got = rec["memory"]["batch_bytes"]
    if SHAPES[shape].global_batch == 1:
        assert got == whole
    else:
        assert got * 16 == whole, (got, whole)
    recipe = make_recipe(cfg, _fake_mesh((16, 16), (0, 0)), attn_mode=rec["attn_mode"])
    local = local_batch_shapes(recipe, {n: s for n, (s, _) in specs.items()},
                               decode=SHAPES[shape].kind == "decode")
    assert got == sum(math.prod(local[n]) * d.itemsize for n, (_, d) in specs.items())
