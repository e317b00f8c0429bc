"""The port's loss, gradients and single-program train step against the
reference's, on the CPU.

The reference's parameters (SMOKE configs, seeded) are carried over with
``params_from_jax``; the reference's attention on the CPU is its
differentiable ``blockwise_attention_ref`` (its Pallas kernel has no
gradient rule), the port's the plain flash version.  Tolerances, float32
activations:

* loss ``rtol=1e-5``; every gradient leaf ``rtol=1e-4, atol=1e-6`` (float32
  sums in other orders);
* the port with remat on equals remat off bitwise (the recompute repeats
  the same operations on the same inputs);
* bf16 activations: the loss to ``rtol=2e-3`` and each gradient leaf to a
  relative Frobenius error of ``3e-2``: bf16 rounds at other places in the
  two frameworks (XLA may fold converts), about one bf16 ulp (``2**-8``)
  per rounding;
* ``make_train_step`` over 3 steps with 1 and 2 microbatches against the
  reference's jitted one: loss and gradient norm ``rtol=1e-5``, the learning
  rate to one float32 ulp (XLA's fused cosine).  Adam's first update is
  nearly ``sign(g) * lr``, so an element whose gradient is near 0 may move
  by up to ``2 * lr`` between two correct runs; the parameters and moments
  are therefore held, at every step, against the reference's optimizer fed
  the same gradients and state as the port's step (its parameters,
  moments and gradient norm to ``rtol=1e-6, atol=1e-9``), while the
  gradients themselves are held above.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.module import tree_leaves
from repro_torch.models.module import tree_map as tmap
from repro_torch.models.weights import params_from_jax
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttr

ARCHS = ["phi4-mini-3.8b", "phi3.5-moe-42b-a6.6b"]
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _models(arch, act="float32"):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.dtype(act))
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), act_dtype=getattr(torch, act))
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, B=4, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
    tl, tm, tg = ttr._accum_loss_grads(tp, tb, tcfg, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("nll", "aux", "ppl_proxy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    if arch != "phi4-mini-3.8b":
        assert float(tm["aux"]) > 0  # the MoE's aux loss is in the loss ...
        router = tg["blocks"]["ffn"]["router"]
        assert float(router.abs().sum()) > 0  # ... and its gradient reaches the router
    for i, (g, w) in enumerate(zip(tree_leaves(tg), jax.tree.leaves(jg))):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bitwise(arch):
    _, _, tcfg, tp = _models(arch)
    _, tb = _batch(tcfg)
    assert tcfg.remat == "block"
    on = ttr._accum_loss_grads(tp, tb, tcfg, 2)
    off = ttr._accum_loss_grads(tp, tb, dataclasses.replace(tcfg, remat="none"), 2)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[2]), tree_leaves(off[2])):
        assert torch.equal(a, b)


def test_bf16_loss_and_grads_match_reference_loosely():
    jcfg, jp, tcfg, tp = _models("phi4-mini-3.8b", act="bfloat16")
    jb, tb = _batch(jcfg)
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
    tl, _, tg = ttr._accum_loss_grads(tp, tb, tcfg, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)
    for i, (g, w) in enumerate(zip(tree_leaves(tg), jax.tree.leaves(jg))):
        assert g.dtype == torch.float32  # the float32 masters' gradients
        w = np.asarray(w, dtype=np.float32)
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err < 3e-2, (i, err)


def test_loss_mask_and_eval_step():
    jcfg, jp, tcfg, tp = _models("phi4-mini-3.8b")
    jb, tb = _batch(jcfg)
    mask = (np.arange(32)[None, :] % 3 != 0).astype(np.float32).repeat(4, 0)
    jl, _ = jlm.loss_fn(jp, {**jb, "loss_mask": jnp.asarray(mask)}, jcfg)
    tl, _ = tlm.loss_fn(tp, {**tb, "loss_mask": torch.from_numpy(mask)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = ttr.make_eval_step(tcfg, None)(tp, tb)
    want = jtr.make_eval_step(jcfg, None)(jp, jb)
    assert not got["loss"].requires_grad
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7)


def test_split_batch_refuses_what_does_not_divide():
    with pytest.raises(ValueError, match="microbatches"):
        ttr._split_batch({"tokens": torch.zeros(3, 4)}, 2)


def _to_jax(tree):
    return tmap(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_over_three_steps(microbatches):
    jcfg, jp, tcfg, tp = _models("phi4-mini-3.8b")
    jb, tb = _batch(jcfg)
    jocfg, tocfg = jopt.OptConfig(**OCFG), topt.OptConfig(**OCFG)
    jstep = jax.jit(jtr.make_train_step(jcfg, None, jocfg, microbatches=microbatches))
    jupdate = jax.jit(lambda p, g, o: jopt.apply_updates(p, g, o, jocfg))
    tstep = ttr.make_train_step(tcfg, None, tocfg, microbatches=microbatches)
    jo, to = jopt.init_opt_state(jp, jocfg), topt.init_opt_state(tp, tocfg)
    for s in range(3):
        # the reference's optimizer fed this step's port gradients and state
        _, _, g = ttr._accum_loss_grads(tp, tb, tcfg, microbatches)
        fed = jupdate(_to_jax(tp), _to_jax(g), jopt.OptState(
            step=jnp.int32(int(to.step)), mu=_to_jax(to.mu), nu=_to_jax(to.nu), err=()))
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1.2e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(fed[2]["grad_norm"]),
                                   rtol=1e-6)
        for name, mine, theirs in (("params", tp, fed[0]), ("mu", to.mu, fed[1].mu),
                                   ("nu", to.nu, fed[1].nu)):
            for a, b in zip(tree_leaves(mine), jax.tree.leaves(theirs)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9,
                                           err_msg=f"step {s} {name}")
    assert int(to.step) == int(jo.step) == 3
