"""Under the plain ``sp`` recipe the residual stream stays cut over ``model``
by sequence between blocks, as the reference's compiled program carries it.

* On 4 gloo ranks of the ``(1, 4)`` and ``(2, 2)`` ``(data, model)`` meshes
  (one job a mesh), ``attn_mode="sp"`` forced, SMOKE configs in float32
  (perturbed seeded weights, ``tests/_torch_families.py``) over 4 rows of a
  ragged ``S = 29`` (chunks of 8, 8, 8, 5 and of 15, 14): the dense family,
  the MoE's capacity dispatch, its grouped dispatch, its ``f``-cut experts
  with a dense residual on ``(1, 4)`` (experts cut on ``(2, 2)``), and the
  audio family; the MoE's expert-parallel dispatch at ``S = 32`` (EP needs
  S to divide ``model``) and a dropless capacity, against the dense oracle.
  Each rank's forward logits (gathered whole) equal the reference's
  single-device ``lm.forward`` within ``1e-5`` (``5e-5`` for the MoE, the
  MoE recipe tests' ``ATOL``), the aux loss within ``1e-6``; the loss and
  its metrics and the gradients gathered back whole equal the reference's
  ``loss_fn`` and ``jax.grad`` within the recipe training tests'
  tolerances (loss ``1e-4``; metrics and gradients ``rtol=1e-4,
  atol=1e-6``).  The residual entering every block is this rank's
  ``(n_rows, cap, d_model)`` chunk.  The dense batch holds one token only
  at positions of the last chunk, whose vocab row model rank 0 owns: its
  embedding gradient, which comes only through another rank's chunk,
  equals the reference's and is not zero.
* The dry run (rank 0 of a fake 16 x 16 world, phi4-mini at 2 layers,
  train_4k): no block's checkpoint keeps a bf16 ``(16, 4096, 3072)``
  input; each keeps the rank's ``(16, 256, 3072)`` chunk.
* The reference's own compiled program (its dry run in a JAX subprocess,
  the forward layer scan's carry read from ``compiled.as_text()``) carries
  the residual a rank as the port's dry run does: phi4-mini cut by
  sequence, minicpm3-4b (MLA) whole.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from _torch_dist import SRC, run_gloo
from _torch_families import inputs as family_inputs
from _torch_families import models as family_models
from repro.models import lm as jlm
from repro_torch.launch import dryrun
from repro_torch.models import lm

B, S, S_EP = 4, 29, 32
MESHES = [(1, 4), (2, 2)]
MODELS = {
    "dense": ("phi4-mini-3.8b", {}),
    "moe": ("phi3.5-moe-42b-a6.6b", {}),
    "grouped": ("phi3.5-moe-42b-a6.6b", dict(moe_groups=2)),
    "moe_residual": ("phi3.5-moe-42b-a6.6b", dict(n_experts=6, moe_dense_residual=True)),
    "ep": ("phi3.5-moe-42b-a6.6b", dict(moe_dispatch="ep", moe_capacity_factor=2.0)),
    "audio": ("musicgen-large", {}),
}
PROBE, PROBE_AT = 5, (25, 27)  # a token of model rank 0's vocab block, in the last chunk only


def _logits_atol(name):
    return 1e-5 if name in ("dense", "audio") else 5e-5


@pytest.fixture(scope="module")
def reference():
    out = {"models": {}, "batches": {}}
    for i, (name, (arch, over)) in enumerate(MODELS.items()):
        jcfg, jp, _, _ = family_models(arch, attn_impl=None, **over)
        seq = S_EP if name == "ep" else S
        jb, _ = family_inputs(jcfg, B, seq + 1, seed=40 + i)
        jb = {k: np.asarray(v) for k, v in jb.items()}
        if "tokens" in jb:
            toks = jb["tokens"]
            if name == "dense":
                toks = np.where(toks == PROBE, PROBE + 1, toks)
                toks[[0, 3], PROBE_AT[0]] = PROBE
                toks[0, PROBE_AT[1]] = PROBE
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        else:
            labels = np.random.default_rng(50 + i).integers(0, jcfg.vocab, (B, seq))
            batch = {"embeds": jb["embeds"][:, :-1], "labels": labels.astype(np.int32)}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        oracle = dataclasses.replace(jcfg, moe_dispatch="auto") if name == "ep" else jcfg
        logits, aux = jlm.forward(jp, {k: v for k, v in jbatch.items() if k != "labels"}, oracle)
        (loss, metrics), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
            jp, jbatch, oracle)
        out["models"][name] = (arch, over, jax.tree.map(np.asarray, jp))
        out["batches"][name] = batch
        out[name] = dict(logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                         metrics={k: float(v) for k, v in metrics.items()},
                         grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                         embed_leaf=[jax.tree_util.keystr(k) for k, _ in
                                     jax.tree_util.tree_leaves_with_path(grads)].index("['embed']")
                         if "embed" in grads else None)
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:sp_residual", 4,
                                    tmp_path_factory.mktemp("gloo_sp_residual"), timeout=400,
                                    shape=shape, models=reference["models"],
                                    batches=reference["batches"])
        return cache[shape]

    return get


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_sp_forward_matches_reference(reference, port, shape, name):
    want = reference[name]
    for rank, got in enumerate(port(shape)):
        np.testing.assert_allclose(got[(name, "logits")], want["logits"], rtol=0,
                                   atol=_logits_atol(name), err_msg=f"{name} {shape} rank {rank}")
        assert abs(got[(name, "aux")] - want["aux"]) < 1e-6, (name, shape, rank)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_sp_loss_and_grads_match_reference(reference, port, shape, name):
    want = reference[name]
    ranks = port(shape)
    assert len({got[(name, "loss")] for got in ranks}) == 1
    for rank, got in enumerate(ranks):
        where = f"{name} {shape} rank {rank}"
        assert abs(got[(name, "loss")] - want["loss"]) < 1e-4, where
        for k in ("nll", "aux", "ppl_proxy"):
            np.testing.assert_allclose(got[(name, "metrics")][k], want["metrics"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{where} {k}")
        assert len(got[(name, "grads")]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got[(name, "grads")], want["grads"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=f"{where} leaf {i}")


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_residual_entering_each_block_is_the_ranks_chunk(port, shape, name):
    for rank, got in enumerate(port(shape)):
        chunk = got[(name, "chunk")]
        assert chunk[1] < (S_EP if name == "ep" else S)
        assert got[(name, "residual")] == [chunk] * 2, (name, shape, rank)
        assert got[(name, "warnings")] == 0, (name, shape, rank)  # EP runs: S divides model


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_embedding_gradient_from_another_ranks_chunk(reference, port, shape):
    """Token ``PROBE`` sits only at positions of the last chunk, on the last
    ``model`` rank, while its vocab row is model rank 0's: the lookup's sum
    is reduce-scattered to the chunks and its backward all-gathers the
    cotangent, so the row's gradient (summed over the rows' ranks) is
    whole."""
    toks = reference["batches"]["dense"]["tokens"]
    cap = -(-S // shape[1])
    assert np.all(np.argwhere(toks == PROBE)[:, 1] >= (shape[1] - 1) * cap)
    leaf = reference["dense"]["embed_leaf"]
    want = reference["dense"]["grads"][leaf][PROBE]
    assert np.abs(want).max() > 1e-3
    for rank, got in enumerate(port(shape)):
        np.testing.assert_allclose(got[("dense", "grads")][leaf][PROBE], want, rtol=1e-4,
                                   atol=1e-6, err_msg=f"{shape} rank {rank}")


# ------------------------------------------------------------- dry run ----

@pytest.fixture
def world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _checkpoint_inputs(monkeypatch, arch, shape="train_4k", layers=2):
    """The tensors each block's checkpoint is handed in the dry run of rank
    0 of a fake 16 x 16 world, ``arch`` cut to ``layers`` layers, as
    ``(shape, dtype)``."""
    seen = []
    real = lm.checkpoint

    def spy(fn, *args, **kw):
        seen.append([(tuple(a.shape), a.dtype) for a in args if isinstance(a, torch.Tensor)])
        return real(fn, *args, **kw)

    monkeypatch.setattr(lm, "checkpoint", spy)
    dryrun.lower_cell(arch, shape, sets=[f"n_layers={layers}"], verbose=False)
    return seen


def test_dry_run_checkpoint_keeps_the_chunk(world, monkeypatch):
    seen = _checkpoint_inputs(monkeypatch, "phi4-mini-3.8b")
    assert len(seen) == 2  # one checkpoint a block
    for inputs in seen:
        assert ((16, 4096, 3072), torch.bfloat16) not in inputs, inputs
        assert inputs == [((16, 256, 3072), torch.bfloat16)], inputs


_PROBE = r"""
import json, re, sys
from repro.launch import dryrun
out = {}
for arch in sys.argv[1:]:
    _, c = dryrun.lower_cell(arch, "train_4k", sets=["n_layers=2"], verbose=False)
    for line in c.as_text().splitlines():
        if " while(" in line and 'jvp()/while"' in line:
            carry = re.search(r"= \((.*?)\) while", line).group(1)
            out[arch] = [int(n) for n in re.search(r"bf16\[([0-9,]+)\]", carry).group(1).split(",")]
print(json.dumps(out))
"""


def test_residual_a_rank_equals_the_reference_compiled_carry(world, monkeypatch):
    """The reference's forward layer scan carries phi4-mini's residual as
    ``bf16[16,256,3072]`` a rank (GSPMD propagates the cut of q/attn_out,
    though its ``hidden`` spec is whole) and minicpm3-4b's whole,
    ``bf16[16,4096,2560]``; the port's blocks take the same."""
    archs = {"phi4-mini-3.8b": (16, 256, 3072), "minicpm3-4b": (16, 4096, 2560)}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + ([os.environ["PYTHONPATH"]]
                                                   if os.environ.get("PYTHONPATH") else [])))
    res = subprocess.run([sys.executable, "-c", _PROBE, *archs], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    for arch, want in archs.items():
        assert tuple(ref[arch]) == want, (arch, ref[arch])
        seen = _checkpoint_inputs(monkeypatch, arch)
        monkeypatch.undo()
        assert seen and all(inputs[0] == (want, torch.bfloat16) for inputs in seen), (arch, seen)
