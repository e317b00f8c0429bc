"""Under the plain ``sp`` recipe the VLM (llama-3.2-vision) carries its
residual stream cut over ``model`` by sequence through its self and cross
blocks, as the reference's compiled program carries it.

* On 4 gloo ranks of the ``(1, 4)`` and ``(2, 2)`` ``(data, model)`` meshes
  (one job a mesh), ``attn_mode="sp"`` forced, the SMOKE config (5 layers:
  one group of 4 self blocks and a cross block) in float32 with perturbed
  seeded weights and the cross blocks' gates drawn from U[0.5, 1]
  (``tests/_torch_families.py``), over 4 rows of a ragged ``S = 29`` (chunks
  of 8, 8, 8, 5 and of 15, 14) and each row's own image.  Each rank's
  forward logits (gathered whole) equal the reference's single-device
  ``lm.forward`` within ``1e-5``; the loss within ``1e-4``, and its metrics
  and every gradient gathered back whole equal the reference's ``loss_fn``
  and ``jax.grad`` within ``rtol=1e-4, atol=1e-6``.  The cross block's
  weights used whole by each rank's chunk (both norms, both gates, the
  attention's projections and its q/k norms) are checked by name and are
  not zero.  The residual entering every self block and the cross block is
  this rank's ``(n_rows, cap, d_model)`` chunk.
* The dry run (rank 0 of a fake 16 x 16 world, llama-3.2-vision-11b at 5
  layers, train_4k, ``sp`` forced): no checkpoint is handed a bf16
  ``(16, 4096, 4096)`` residual; the group's and each self block's take
  the rank's ``(16, 256, 4096)`` chunk.
* The reference's own compiled program (its dry run in a JAX subprocess,
  the forward self-block scan's carry read from ``compiled.as_text()``)
  carries ``bf16[16,256,4096]`` a rank, as the port's checkpoints take.
"""
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
from _torch_recipe import checkpoint_inputs
from repro.models import lm as jlm

ARCH = "llama-3.2-vision-11b"
B, S = 4, 29
MESHES = [(1, 4), (2, 2)]
GROUP_SELF = 4  # the SMOKE config's one group: 4 self blocks, then the cross block
# the cross block's weights that each rank's chunk alone uses whole
CROSS = ("ln1", "ln2", "gate_attn", "gate_ffn", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
         "attn.q_norm", "attn.k_norm")
CHUNK, WHOLE = (16, 256, 4096), (16, 4096, 4096)  # train_4k's residual a rank at 16 x 16


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def reference():
    jcfg, jp, _, _ = family_models(ARCH, attn_impl=None)
    jb, _ = family_inputs(jcfg, B, S + 1, seed=71)
    toks = np.asarray(jb["tokens"])
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "image_embeds": np.asarray(jb["image_embeds"])}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jlm.forward(jp, {k: v for k, v in jbatch.items() if k != "labels"}, jcfg)
    (loss, metrics), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jbatch, jcfg)
    paths = jax.tree_util.tree_flatten_with_path(grads)[0]
    return dict(tree=jax.tree.map(np.asarray, jp), batch=batch, logits=np.asarray(logits),
                aux=float(aux), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=[np.asarray(g) for _, g in paths],
                names=[".".join(str(k.key) for k in path) for path, _ in paths])


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:sp_residual", 4,
                                    tmp_path_factory.mktemp("gloo_sp_residual_vlm"), timeout=400,
                                    shape=shape, models={"vlm": (ARCH, {}, reference["tree"])},
                                    batches={"vlm": reference["batch"]})
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_vlm_sp_forward_matches_reference(reference, port, shape):
    for rank, got in enumerate(port(shape)):
        np.testing.assert_allclose(got[("vlm", "logits")], reference["logits"], rtol=0,
                                   atol=1e-5, err_msg=f"{shape} rank {rank}")
        assert abs(got[("vlm", "aux")] - reference["aux"]) < 1e-6, (shape, rank)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_vlm_sp_loss_and_grads_match_reference(reference, port, shape):
    ranks = port(shape)
    assert len({got[("vlm", "loss")] for got in ranks}) == 1
    for rank, got in enumerate(ranks):
        where = f"{shape} rank {rank}"
        assert abs(got[("vlm", "loss")] - reference["loss"]) < 1e-4, where
        for k in ("nll", "aux", "ppl_proxy"):
            np.testing.assert_allclose(got[("vlm", "metrics")][k], reference["metrics"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{where} {k}")
        assert len(got[("vlm", "grads")]) == len(reference["grads"])
        for name, g, w in zip(reference["names"], got[("vlm", "grads")], reference["grads"]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=f"{where} {name}")


@pytest.mark.parametrize("leaf", CROSS)
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_vlm_sp_cross_block_gradient(reference, port, shape, leaf):
    """A cross-block weight whole on every ``model`` rank and used by the
    rank's chunk alone: its gradient is summed over ``model``
    (``Placement.for_chunk``), so gathered back it is the reference's,
    and not zero (each rank's share alone would differ)."""
    i = reference["names"].index(f"cross_blocks.{leaf}")
    want = reference["grads"][i]
    assert np.abs(want).max() > 1e-4, leaf
    for rank, got in enumerate(port(shape)):
        g = got[("vlm", "grads")][i]
        assert np.abs(g).max() > 0, (leaf, shape, rank)
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{leaf} {shape} rank {rank}")


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_vlm_residual_entering_each_block_is_the_ranks_chunk(port, shape):
    for rank, got in enumerate(port(shape)):
        chunk = got[("vlm", "chunk")]
        assert chunk[1] < S
        assert got[("vlm", "residual")] == [chunk] * GROUP_SELF, (shape, rank)
        assert got[("vlm", "cross_residual")] == [chunk], (shape, rank)
        assert got[("vlm", "warnings")] == 0, (shape, rank)


# ------------------------------------------------------------- dry run ----

@pytest.fixture(scope="module")
def dry_run_checkpoints():
    try:
        return checkpoint_inputs(ARCH, layers=5, attn_mode="sp")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_vlm_dry_run_checkpoint_keeps_the_chunk(dry_run_checkpoints):
    seen = dry_run_checkpoints
    # the group's and each self block's, and the self blocks' again in the
    # group's recompute
    assert len(seen) == 1 + 2 * GROUP_SELF
    for inputs in seen:
        assert (WHOLE, torch.bfloat16) not in inputs, inputs
        assert inputs == [(CHUNK, torch.bfloat16)], inputs


_PROBE = r"""
import json, re, sys
from repro.launch import dryrun
_, c = dryrun.lower_cell(sys.argv[1], "train_4k", sets=["n_layers=5"], attn_mode="sp",
                         verbose=False)
out = []
for line in c.as_text().splitlines():
    # the forward's scans (at 5 layers the self blocks' alone: the group's
    # one trip is folded away); a layer scan's carry opens with the counter
    # and the bf16 residual
    if " while(" in line and "transpose(" not in line and 'jvp()/while/body' in line:
        carry = re.search(r"= \((.*?)\) while", line).group(1).split(", ")
        if carry[1].startswith("bf16["):
            dims = re.search(r"bf16\[([0-9,]+)\]", carry[1]).group(1)
            out.append([int(n) for n in dims.split(",")])
print(json.dumps(out))
"""


def test_vlm_residual_a_rank_equals_the_reference_compiled_carry(dry_run_checkpoints):
    """The reference's forward self-block scan carries the VLM's residual
    as ``bf16[16,256,4096]`` a rank under ``sp`` (GSPMD propagates the cut
    of q/attn_out through the self and cross blocks, though its ``hidden``
    spec is whole); the port's checkpoints take the same."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + ([os.environ["PYTHONPATH"]]
                                                   if os.environ.get("PYTHONPATH") else [])))
    res = subprocess.run([sys.executable, "-c", _PROBE, ARCH], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert ref and all(tuple(c) == CHUNK for c in ref), ref
    assert all(inputs[0] == (CHUNK, torch.bfloat16) for inputs in dry_run_checkpoints)
