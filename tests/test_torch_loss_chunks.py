"""The training loss's log-sum-exp and gold logit in row chunks
(``lm._loss_terms``: a Function that upcasts ``blocks.UPCAST_CHUNK``
float32 elements' worth of the logits block's rows at a time, saves the block in its
own dtype and writes the cotangent straight into one tensor of that dtype),
against its plain version (``lm._loss_terms_plain``, the composite on a
float32 copy of the whole block) and against the reference's ``loss_fn``.

* One rank, float32 logits ``(3, 37, 203)`` (111 rows): the whole block in
  one chunk, chunks of 7 rows (the last ragged) and of one row.  ``logz``
  and ``gold`` equal the plain version's within ``1e-6`` relative, and so
  does the masked mean nll; the logits cotangent within ``rtol=1e-5,
  atol=1e-7``.  bf16 logits: the terms within ``1e-6`` relative (both
  upcast the same values), the bf16 cotangent within one rounding
  (``rtol=2**-7``).
* 4 gloo ranks of ``(1, 4)`` and ``(2, 2)`` meshes: each rank's rows and
  vocab block of float32 logits ``(8, 31, 512)``, chunks of 3 and 7 rows
  with a ragged last one, the same tolerances against the plain version on
  the same rank; ``logz`` and ``gold`` against the whole rows' float64
  log-sum-exp and gold logit within ``1e-6`` relative.
* The port's ``loss_fn``, its metrics and gradients against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` (phi4-mini SMOKE,
  float32, 8 x 32 tokens, a ``loss_mask``), the loss in chunks of 7 rows:
  on one rank with no recipe, and under ``tp`` on 4 gloo ranks of ``(1, 4)``
  and ``(2, 2)`` (``_torch_recipe:logits_cut``), at
  ``tests/test_torch_logits_cut.py``'s tolerances (loss ``1e-4``,
  gradients ``rtol=1e-4, atol=1e-6``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import blocks, lm
from repro_torch.models.module import tree_leaves
from repro_torch.models.weights import params_from_jax
from repro_torch.train import trainer

ROWS = {"whole": None, "7-rows": 7, "1-row": 1}
MESHES = [(1, 4), (2, 2)]
B, S = 8, 32


def _logits(shape, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 4.0).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1])
    mask = (rng.random(shape[:-1]) > 0.25).astype(np.float32)
    return logits, labels, mask


def _terms(fn, logits, labels, mask):
    block = logits.clone().requires_grad_()
    logz, gold = fn(block, labels)
    nll = ((logz - gold) * mask).sum() / mask.sum()
    nll.backward()
    return logz.detach(), gold.detach(), nll.detach(), block.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", list(ROWS), ids=list(ROWS))
def test_loss_terms_match_the_plain_version(monkeypatch, rows, dtype):
    logits, labels, mask = _logits((3, 37, 203), 0)
    if ROWS[rows] is not None:
        monkeypatch.setattr(blocks, "UPCAST_CHUNK", ROWS[rows] * 203)
    x = torch.from_numpy(logits).to(dtype)
    lab, msk = torch.from_numpy(labels), torch.from_numpy(mask)
    got = _terms(lm._loss_terms, x, lab, msk)
    want = _terms(lm._loss_terms_plain, x, lab, msk)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    assert got[3].dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got[3].float().numpy(), want[3].float().numpy(), rtol=rtol,
                               atol=1e-7)


def test_row_chunks_cover_the_rows_with_a_ragged_last(monkeypatch):
    monkeypatch.setattr(blocks, "UPCAST_CHUNK", 7 * 203)
    chunks = blocks.row_chunks(111, 203)
    assert [c.stop - c.start for c in chunks] == [7] * 15 + [6]
    assert chunks[0].start == 0 and chunks[-1].stop == 111
    monkeypatch.setattr(blocks, "UPCAST_CHUNK", 100)  # fewer elements than a row: one row a chunk
    assert len(blocks.row_chunks(5, 203)) == 5


# ------------------------------------------------- vocab-parallel, 4 ranks

@pytest.fixture(scope="module")
def vocab_parallel(tmp_path_factory):
    logits, labels, mask = _logits((8, 31, 512), 1)
    runs = {shape: run_gloo("_torch_recipe:loss_terms", 4,
                            tmp_path_factory.mktemp("gloo_loss_terms"), shape=shape,
                            logits=logits, labels=labels, mask=mask, upcast_chunk=7 * 128)
            for shape in MESHES}
    return logits, labels, runs


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_vocab_parallel_chunks_match_the_plain_version(vocab_parallel, shape):
    logits, labels, runs = vocab_parallel
    D = shape[0]
    whole = logits.astype(np.float64)
    mx = whole.max(axis=-1)
    logz = mx + np.log(np.exp(whole - mx[..., None]).sum(axis=-1))
    gold = np.take_along_axis(whole, labels[..., None], axis=-1)[..., 0]
    for rank, got in enumerate(runs[shape]):
        d = got["coords"]["data"]
        rows = slice(d * (8 // D), (d + 1) * (8 // D))
        (lz, g, cot), (plz, pg, pcot) = got["chunks"], got["plain"]
        np.testing.assert_allclose(lz, plz, rtol=1e-6, atol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(g, pg, rtol=1e-6, atol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(cot, pcot, rtol=1e-5, atol=1e-7, err_msg=f"rank {rank}")
        np.testing.assert_allclose(lz, logz[rows], rtol=1e-6, atol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(g, gold[rows], rtol=1e-6, atol=0, err_msg=f"rank {rank}")


# ------------------------------------------------------ against the reference

@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(32)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}
    cfg = dataclasses.replace(jconfigs.get("phi4-mini-3.8b", smoke=True), act_dtype=jnp.float32)
    params = jlm.init_model(cfg, jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(params, jb, cfg)
    return dict(batch=batch, tree=jax.tree.map(np.asarray, params), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def _check_loss_and_grads(got_loss, got_metrics, got_grads, ref, where):
    assert abs(got_loss - ref["loss"]) < 1e-4, (where, got_loss, ref["loss"])
    for k in ("nll", "aux", "ppl_proxy"):
        np.testing.assert_allclose(got_metrics[k], ref["metrics"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{where} {k}")
    assert len(got_grads) == len(ref["grads"])
    for i, (g, w) in enumerate(zip(got_grads, ref["grads"])):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=f"{where} grad leaf {i}")


def test_loss_fn_in_chunks_matches_the_reference(reference, monkeypatch):
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), act_dtype=torch.float32)
    monkeypatch.setattr(blocks, "UPCAST_CHUNK", 7 * cfg.vocab_padded)  # 256 rows: 36 chunks of 7, 4
    params = params_from_jax(reference["tree"], device="cpu")
    b = {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(v).long()
         for k, v in reference["batch"].items()}
    loss, metrics, grads = trainer._accum_loss_grads(params, b, cfg, 1)
    _check_loss_and_grads(float(loss), {k: float(v) for k, v in metrics.items()},
                          [g.numpy() for g in tree_leaves(grads)], reference, "one rank")


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_vocab_parallel_loss_fn_in_chunks_matches_the_reference(reference, shape,
                                                                 tmp_path_factory):
    ranks = run_gloo("_torch_recipe:logits_cut", 4, tmp_path_factory.mktemp("gloo_loss_chunks"),
                     shape=shape, models={"untied": ({}, reference["tree"])},
                     batch=reference["batch"], modes={"untied": ["tp"]}, upcast_chunk=7 * 128)
    assert len({got[("untied", "tp", "loss")] for got in ranks}) == 1
    for rank, got in enumerate(ranks):
        _check_loss_and_grads(got[("untied", "tp", "loss")], got[("untied", "tp", "metrics")],
                              got[("untied", "tp", "grads")], reference, f"{shape} rank {rank}")
