"""The port's explicit ZeRO-2 train step on gloo ranks, against the
reference.

``make_zero_train_step`` runs as one rank's program on a one-axis ``data``
mesh of 2 and 4 gloo processes.  The config is phi4-mini's SMOKE with 3
layers and d_model 65, float32 activations, and a bucket threshold of 1000
bytes: 11 buckets, of which the norms' (195, 195 and 65 elements) are
ragged on both 2 and 4 ranks.  The reference's own sharded step cannot run
on this jax's ``shard_map`` (``check_rep``), so the oracle is its
single-device step on the global batch.  Held:

* the whole step, two steps from the same parameters: the loss to
  ``rtol=1e-5`` and the gradient norm to ``1e-4`` (the ranks' partial
  gradients are summed in another order than one device's), the learning
  rate to one float32 ulp (XLA's fused cosine);
* the update fed the same gradients as the reference's optimizer (each
  step's reference gradient; rank 0 hands in R times it and the others
  zeros, so the reduced mean is exactly it): parameters and moments to
  ``rtol=1e-6, atol=1e-9``, the gradient norm to ``1e-6`` (sums of squares
  ordered by bucket).  Fed the same gradients, Adam's nearly ``sign(g)``
  first update cannot flip between the two packages;
* the blocking plan equal to the double-buffered one, bitwise;
* every reduce-scatter issued before the first wait;
* the bucket tables equal to the reference's.

int8 error feedback is held in ``tests/test_torch_zero_int8.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import TESTS, run_gloo
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs as tconfigs
from repro_torch.train import trainer as ttr

OVERRIDES = dict(n_layers=3, d_model=65)
BUCKET_BYTES = 1000
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 2
SMALL_GRAD = 1e-7


def _jcfg():
    return dataclasses.replace(jconfigs.get("phi4-mini-3.8b", smoke=True), act_dtype=jnp.float32,
                               **OVERRIDES)


def _batch(B=8, S=16, seed=3):
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device steps on the global batch, as its train
    step computes them (gradients, then ``apply_updates``): the parameters,
    moments and metrics after every step, and every step's gradients."""
    cfg = _jcfg()
    params = jlm.init_model(cfg, jax.random.PRNGKey(0))
    ocfg = jopt.OptConfig(**OCFG)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    grads_of = jax.jit(lambda p: jtr._accum_loss_grads(p, batch, cfg, 1))
    update = jax.jit(lambda p, g, o: jopt.apply_updates(p, g, o, ocfg))
    p, o = params, jopt.init_opt_state(params, ocfg)
    metrics, grads = [], []
    for _ in range(STEPS):
        loss, _, g = grads_of(p)
        p, o, m = update(p, g, o)
        grads.append([np.asarray(x) for x in jax.tree.leaves(g)])
        metrics.append({"loss": np.asarray(loss), **{k: np.asarray(v) for k, v in m.items()}})
    np_tree = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    return dict(params0=jax.tree.map(np.asarray, params), params=np_tree(p), mu=np_tree(o.mu),
                nu=np_tree(o.nu), metrics=metrics, grads=grads)


def _shard(leaves, bucket, rank):
    flat = np.concatenate([leaves[i].ravel() for i in bucket.indices])
    flat = np.pad(flat, (0, bucket.padded - bucket.size))
    return flat[rank * bucket.cap:(rank + 1) * bucket.cap]


@pytest.mark.parametrize("world,microbatches", [(2, 2), (4, 1)])
def test_zero_step_matches_single_device_reference(reference, world, microbatches, tmp_path):
    tcfg = dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), **OVERRIDES)
    buckets = ttr.zero_train_buckets(tcfg, bucket_bytes=BUCKET_BYTES, ranks=world)
    ragged = [b for b in buckets if b.size % world]
    assert len(buckets) >= 3 and len(ragged) >= 3, [b.size for b in buckets]
    ranks = run_gloo("zero_train_family", world, tmp_path, params=reference["params0"],
                     batch=_batch(), cfg_overrides=OVERRIDES, ocfg=OCFG,
                     bucket_bytes=BUCKET_BYTES, steps=STEPS, microbatches=microbatches,
                     grads=reference["grads"])
    for rank, got in enumerate(ranks):
        assert got["extents"] == [b.extents for b in buckets]
        db, blocking = got[True], got[False]
        for key in ("params", "mu", "nu", "err"):
            for a, b in zip(db[key], blocking[key]):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} {key}: blocking")
        assert db["step"] == STEPS
        for s, (m, want) in enumerate(zip(db["metrics"], reference["metrics"])):
            for k in m:
                np.testing.assert_array_equal(m[k], blocking["metrics"][s][k])
            np.testing.assert_allclose(m["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], want["grad_norm"], rtol=1e-4)
            np.testing.assert_allclose(m["lr"], want["lr"], rtol=1.2e-7)
        fed = got["update"]
        np.testing.assert_allclose(fed["grad_norm"],
                                   [float(m["grad_norm"]) for m in reference["metrics"]],
                                   rtol=1e-6)
        for a, b in zip(fed["params"], reference["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        for key in ("mu", "nu"):
            for s, b in enumerate(buckets):
                np.testing.assert_allclose(fed[key][s], _shard(reference[key], b, rank),
                                           rtol=1e-6, atol=1e-9, err_msg=f"{key} bucket {s}")
    # every reduce-scatter was issued before the first wait
    log = ranks[0]["log"]
    first_wait = next(i for i, e in enumerate(log) if e[0] == "wait")
    assert log[:first_wait] == [("issue", n) for n in range(len(buckets))]
    assert sorted(n for kind, n in log if kind == "wait") == list(range(len(buckets)))


def test_zero_train_buckets_match_reference():
    for world in (1, 2, 3, 4):
        got = ttr.zero_train_buckets(
            dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), **OVERRIDES),
            bucket_bytes=BUCKET_BYTES, ranks=world)
        want = jtr.zero_train_buckets(_jcfg(), bucket_bytes=BUCKET_BYTES, ranks=world)
        assert [(b.indices, b.counts, b.displs, b.cap, b.extents) for b in got] == \
            [(b.indices, b.counts, b.displs, b.cap, b.extents) for b in want]
