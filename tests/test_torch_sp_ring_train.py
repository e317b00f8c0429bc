"""Training under an ``sp_ring`` recipe on 2 and 4 gloo ranks, against the
reference's single-device gradients and step.

The reference's sharded ring cannot run on this jax (``shard_map``'s
``check_rep``), so the oracle is its single-device ``loss_fn`` gradient and
``make_train_step`` on the same batch (phi4-mini's SMOKE, float32
activations; its attention on the CPU is the differentiable
``blockwise_attention_ref``).  Meshes (data, model): (1, 2) on 2 ranks,
(1, 4) and (2, 2) on 4 (the batch split over ``data`` there); sequences of
64 and a ragged 63 tokens.  Every rank's loss and every gradient leaf is
held, the head's and the blocks' alike, so a factor of R (the head's
gradient summed over the ring, or a block's partial not summed) shows:

* loss ``rtol=1e-5``; gradients ``rtol=1e-4, atol=1e-6`` (the ring's
  online softmax over chunks, and the ranks' partials summed in another
  order than one device's);
* one step's loss and gradient norm to ``rtol=1e-5``, and its parameters
  bitwise equal to ``apply_updates`` fed the gradients held above (Adam's
  first update is nearly ``sign(g) * lr``, so an element whose gradient is
  near 0 may move by up to ``2 * lr`` between two correct runs: the
  optimizer is held against the reference on the same gradients in
  ``tests/test_torch_train.py``);
* the ranks' results among themselves, bitwise;
* the differentiable ring shift's backward (each rank's cotangent goes
  back to the rank it received from) and the gather's (each rank gets its
  own block of the cotangent), exactly.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import SP_RING_TRAIN_MESHES, run_gloo
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr

OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SEQS = (64, 63)
B = 2


@pytest.fixture(scope="module")
def reference():
    cfg = dataclasses.replace(jconfigs.get("phi4-mini-3.8b", smoke=True), act_dtype=jnp.float32)
    params = jlm.init_model(cfg, jax.random.PRNGKey(0))
    ocfg = jopt.OptConfig(**OCFG)
    step = jax.jit(jtr.make_train_step(cfg, None, ocfg))
    rng = np.random.default_rng(11)
    out = {"params": jax.tree.map(np.asarray, params), "batches": {}}
    for S in SEQS:
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out["batches"][S] = (batch["tokens"], batch["labels"])
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(params, jb, cfg)
        _, _, m = step(params, jopt.init_opt_state(params, ocfg), jb)
        out[S] = dict(loss=float(loss), grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                      metrics={k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sp_ring_training_matches_single_device_reference(reference, world, tmp_path):
    ranks = run_gloo("sp_ring_train_family", world, tmp_path, params=reference["params"],
                     batches=reference["batches"], ocfg=OCFG)
    for shape in SP_RING_TRAIN_MESHES[world]:
        for S in SEQS:
            want = reference[S]
            for rank, got in enumerate(ranks):
                np.testing.assert_allclose(got[(shape, S, "loss")], want["loss"], rtol=1e-5)
                for i, (g, w) in enumerate(zip(got[(shape, S, "grads")], want["grads"])):
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                               err_msg=f"{shape} S={S} rank {rank} leaf {i}")
                    np.testing.assert_array_equal(g, ranks[0][(shape, S, "grads")][i])
                m, composed = got[(shape, S, "step")]
                assert composed
                for k in ("loss", "grad_norm"):
                    np.testing.assert_allclose(m[k], want["metrics"][k], rtol=1e-5)
        for rank, got in enumerate(ranks):
            d, r, R = got[(shape, "coords")]
            nxt = (r + 1) % R  # the rank that received this rank's x
            np.testing.assert_array_equal(got[(shape, "shift_grad")],
                                          np.full((2, 3), (10 * nxt + 1) + 2 * (100 * nxt + 7),
                                                  np.float32))
            grad, own = got[(shape, "gather_grad")]
            np.testing.assert_array_equal(grad, own)
