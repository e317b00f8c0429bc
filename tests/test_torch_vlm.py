"""The port's VLM family (llama-3.2-vision-11b: groups of self-attention
blocks, each followed by a gated cross-attention block over the image's
states) against the reference's, on the CPU.

The SMOKE config (5 layers: one group of 4 self blocks and 1 cross block),
float32 activations, inputs made from a numpy seed, and the reference's
seeded weights carried over with ``params_from_jax``, every constant leaf
perturbed and the cross blocks' gates drawn from U[0.5, 1]
(``tests/_torch_families.py``: at their zero init ``tanh(gate) = 0`` and
the cross path would not show; each test that holds it also checks that a
second image moves the output).  The reference's attention runs its Pallas
kernels in interpret mode, the port's its kernels' plain versions (CPU
tensors); for gradients the reference's is its differentiable
``blockwise_attention_ref``.  Tolerances: the cross attention, blocks,
logits and caches ``rtol=atol=1e-4`` (float32 sums in other orders); decode
against the forward ``2e-4``, the reference's own for the family
(``tests/test_decode.py``); the loss ``1e-5`` and every gradient leaf as
``assert_grads_close`` states; one AdamW step: loss ``1e-4``, parameters
``rtol=atol=2e-4``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import lm as jlm
from repro.models.module import init_params as jinit
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblk
from repro_torch.models import lm as tlm
from repro_torch.models.module import tree_leaves
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttr

from _torch_dist import run_gloo
from _torch_families import (BATCH_AXIS_FROM_END, RECIPE_OCFG, assert_grads_close,
                             check_recipe_step, inputs, leaves, models, named_leaves, np_,
                             open_gates, perturb, recipe_reference_step, reference_greedy)

ARCH = "llama-3.2-vision-11b"
TOL = 1e-4
DECODE_TOL = 2e-4  # tests/test_decode.py TOLS["vlm"]


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol, err_msg=msg)


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _image(cfg, B, seed):
    a = np.random.default_rng(seed).standard_normal((B, cfg.enc_len, cfg.enc_dim)).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _moved(a, b) -> float:
    return float(np.abs(np_(a) - np_(b)).max())


# ------------------------------------------------------------- structure ----

def test_param_tree_and_count_match_reference():
    """The VLM tree, leaf for leaf: self blocks stacked (n_cross,
    group_self, ...), cross blocks (n_cross, ...), the embedding and the
    head; its parameter count (published: 8 groups of 4 and 1)."""
    for smoke in (True, False):
        jcfg, tcfg = jconfigs.get(ARCH, smoke=smoke), tconfigs.get(ARCH, smoke=smoke)
        want = jax.tree.map(lambda s: tuple(s.shape), jlm.build_specs(jcfg),
                            is_leaf=lambda s: hasattr(s, "layout"))
        got = tlm.build_specs(tcfg)
        assert jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple)) == \
            [tuple(s.shape) for s in tree_leaves(got)]
        assert tlm.count_params(tcfg) == jlm.count_params(jcfg)
    assert tlm.vlm_dims(tconfigs.get(ARCH)) == (8, 4)
    assert tlm.vlm_dims(tconfigs.get(ARCH, smoke=True)) == (1, 4)


# ------------------------------------------------------- cross attention ----

@pytest.mark.parametrize("S", [32, 1])
def test_cross_attention_matches_reference(S):
    """q from the text, k/v from the image (16 positions), q/k RMS-normed,
    non-causal: a 32-token forward and a one-token decode step's call."""
    jcfg, _, tcfg, _ = models(ARCH)
    specs = jattn.cross_attn_specs(jcfg.d_model, jcfg.n_heads, jcfg.n_kv, jcfg.head_dim,
                                   jcfg.enc_dim)
    jp = perturb(jinit(specs, jax.random.PRNGKey(3)), 3)
    tp = _carry(jp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jenc, tenc = _image(jcfg, 2, 4)
    want = jattn.cross_attention(jp, jnp.asarray(x), jenc, n_heads=jcfg.n_heads, n_kv=jcfg.n_kv,
                                 head_dim=jcfg.head_dim, attn_impl="interpret",
                                 block=jcfg.attn_block)
    got = tattn.cross_attention(tp, torch.from_numpy(x), tenc, block=tcfg.attn_block)
    assert got.shape == (2, S, tcfg.d_model)
    _close(got, want)


def test_cross_block_matches_reference_and_the_image_matters():
    """The gated block (gates opened), and a second image moving its
    output by far more than the tolerance."""
    jcfg, _, tcfg, _ = models(ARCH)
    jp = open_gates({"cross_blocks": perturb(jinit(jblk.cross_block_specs(jcfg),
                                                   jax.random.PRNGKey(5)), 5)})["cross_blocks"]
    tp = _carry(jp)
    x = np.random.default_rng(5).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jenc, tenc = _image(jcfg, 2, 6)
    want = jblk.cross_block(jp, jnp.asarray(x), jenc, jcfg)
    got = tblk.cross_block(tp, torch.from_numpy(x), tenc, tcfg)
    _close(got, want)
    other = tblk.cross_block(tp, torch.from_numpy(x), _image(tcfg, 2, 7)[1], tcfg)
    assert _moved(other, got) > 100 * TOL


# ------------------------------------------------------------ the model ----

def test_forward_matches_reference_and_the_image_matters():
    jcfg, jp, tcfg, tp = models(ARCH)
    jb, tb = inputs(jcfg, 2, 32, seed=8)
    want, _ = jlm.forward(jp, jb, jcfg)
    got, aux = tlm.forward(tp, tb, tcfg)
    assert got.shape == (2, 32, tcfg.vocab_padded) and float(aux) == 0.0
    _close(got, want)
    other, _ = tlm.forward(tp, {**tb, "image_embeds": _image(tcfg, 2, 9)[1]}, tcfg)
    assert _moved(other, got) > 100 * TOL


def _decode_loop(tp, tcfg, tb, B, S):
    state = tlm.DecodeState(tlm.init_cache(tcfg, B, S, device="cpu"),
                            torch.zeros((B,), dtype=torch.int32))
    outs = []
    for t in range(S):
        logits, state = tlm.decode_step(tp, state, {"tokens": tb["tokens"][:, t:t + 1],
                                                    "image_embeds": tb["image_embeds"]}, tcfg)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1), state


def test_decode_matches_forward():
    """The twin of the reference's ``tests/test_decode.py::
    test_decode_matches_forward`` for the family: 16 one-token decode
    steps against the full-sequence forward, at the reference's tolerance;
    every self block's length advanced to 16."""
    _, _, tcfg, tp = models(ARCH)
    B, S = 2, 16
    _, tb = inputs(tcfg, B, S, seed=10)
    dec, state = _decode_loop(tp, tcfg, tb, B, S)
    full, _ = tlm.forward(tp, tb, tcfg)
    _close(dec, full, tol=DECODE_TOL)
    assert state.caches["self"].k.shape == (1, 4, B, tcfg.n_kv, S, tcfg.head_dim)
    assert bool((state.caches["self"].length == S).all())


def test_decode_step_matches_reference_with_idle_rows():
    """A whole-prompt chunk (``prefill=True``: rows of 7 and 12 tokens, a
    third row idle) and then 6 one-token steps with a row idle for two of
    them, each row with its own image: every active row's logits and every
    cache leaf against the reference's ``decode_step``; an idle row's K/V
    and lengths stay bitwise."""
    jcfg, jp, tcfg, tp = models(ARCH)
    B, T, S = 3, 32, 16
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    jimg, timg = _image(jcfg, B, 11)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (B, S + 6)).astype(np.int32)
    jstep = jax.jit(lambda p, s, b, c, prefill: jlm.decode_step(p, s, b, jcfg, new_counts=c,
                                                                prefill=prefill),
                    static_argnames="prefill")
    steps = [(toks[:, :S], np.array([7, 12, 0], np.int32), True)]
    for t in range(6):
        steps.append((toks[:, S + t:S + t + 1],
                      np.array([1, 0 if t in (2, 3) else 1, 1], np.int32), False))
    for t, (b, counts, prefill) in enumerate(steps):
        before = [x.clone() for x in leaves(tstate.caches)]
        jl, jstate = jstep(jp, jstate, {"tokens": jnp.asarray(b), "image_embeds": jimg},
                           jnp.asarray(counts), prefill=prefill)
        tl, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(b).long(),
                                                  "image_embeds": timg}, tcfg,
                                     new_counts=torch.from_numpy(counts), prefill=prefill)
        for r in np.flatnonzero(counts):
            n = counts[r]
            _close(tl[r, :n], np.asarray(jl)[r, :n], f"step {t} row {r}")
        for old, (name, new) in zip(before, named_leaves(tstate.caches)):
            axis = new.ndim - BATCH_AXIS_FROM_END[name]
            for r in np.flatnonzero(counts == 0):
                assert torch.equal(old.select(axis, r), new.select(axis, r)), (t, name)
    for g, w in zip(leaves(tstate.caches), leaves(jstate.caches), strict=True):
        _close(g, w)
    np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions))


# -------------------------------------------------------------- training ----

def test_loss_and_grads_match_reference():
    """``lm.loss_fn`` and its gradients through the stack (remat by group
    and by block) against ``jax.value_and_grad`` of the reference's; the
    cross attention's and the gates' gradients are not zero."""
    jcfg, jp, tcfg, tp = models(ARCH, attn_impl=None)
    jb, tb = inputs(jcfg, 2, 33, seed=13)
    jb = {**jb, "tokens": jb["tokens"][:, :-1], "labels": jb["tokens"][:, 1:]}
    tb = {**tb, "tokens": tb["tokens"][:, :-1], "labels": tb["tokens"][:, 1:]}
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
    tl, _, tg = ttr._accum_loss_grads(tp, tb, tcfg, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(tg, jg)
    cross = tg["cross_blocks"]
    for g in (cross["attn"]["wk"], cross["attn"]["wq"], cross["gate_attn"], cross["gate_ffn"]):
        assert float(g.abs().sum()) > 0


def test_train_step_matches_reference():
    """One ``make_train_step`` step (AdamW, ``lr=1e-3``, no warmup) on a
    pipeline batch (``tokens+image``) against the reference's jitted
    single-device step."""
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline as tpipe
    from repro_torch.launch.train import to_device

    jcfg, jp, tcfg, tp = models(ARCH, attn_impl=None)
    batch = jpipe.make_batch(jcfg, JShapeCell("t", 24, 2, "train"), 0)
    ocfg = dict(lr=1e-3, warmup_steps=0)
    jocfg = jopt.OptConfig(**ocfg)
    new_jp, _, jm = jax.jit(jtr.make_train_step(jcfg, None, jocfg))(
        jp, jopt.init_opt_state(jp, jocfg), {k: jnp.asarray(v) for k, v in batch.items()})
    tocfg = topt.OptConfig(**ocfg)
    tbatch = to_device(tpipe.make_batch(tcfg, tpipe.ShapeCell("t", 24, 2, "train"), 0), "cpu")
    assert tbatch["image_embeds"].dtype == torch.float32
    new_tp, _, tm = ttr.make_train_step(tcfg, None, tocfg)(tp, topt.init_opt_state(tp, tocfg),
                                                          tbatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
    for i, (a, b) in enumerate(zip(tree_leaves(new_tp), jax.tree.leaves(new_jp), strict=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=f"leaf {i}")


def test_checkpoint_round_trips_the_nested_tree(tmp_path):
    """The nested ``self_blocks`` tree and its AdamW state through the
    checkpoint manager and back, bitwise, into a template of zeros; and
    ``cast_params`` keeps the structure."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.models.module import tree_map
    from repro_torch.models.weights import cast_params

    _, _, tcfg, tp = models(ARCH)
    ocfg = topt.OptConfig()
    tree = {"params": tp, "opt": topt.init_opt_state(tp, ocfg)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    zeros = {"params": tree_map(torch.zeros_like, tp), "opt": topt.init_opt_state(tp, ocfg)}
    got, _ = mgr.restore(zeros)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(tp), strict=True):
        assert torch.equal(a, b)
    assert got["params"]["self_blocks"]["attn"]["wq"].shape == (1, 4, 64, 4, 16)
    half = cast_params(tp, torch.bfloat16)
    assert [tuple(t.shape) for t in tree_leaves(half)] == [tuple(t.shape) for t in tree_leaves(tp)]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(half))


# ------------------------------------------------------ under a recipe ----

TWIN_MESH = (1, 2)  # a model axis of 2: the heads and the KV groups cut in two
TWIN_COUNTS = [(7, 5, 0, 3), (1, 1, 1, 0), (1, 0, 1, 1)]


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The reference's single-device forward, greedy decode loop and train
    step, and the port's under each mode on 2 gloo ranks of a (1, 2) mesh
    (one job, ``_torch_recipe.family_twin``)."""
    ref = recipe_reference_step(ARCH, 12, 130)
    jcfg, jp, _, _ = models(ARCH)
    jb, _ = inputs(jcfg, 4, 12, seed=131)
    prompt = np.random.default_rng(132).integers(0, jcfg.vocab, (4, 7)).astype(np.int32)
    image = np.asarray(_image(jcfg, 4, 133)[0])
    counts = [np.array(c, np.int32) for c in TWIN_COUNTS]
    want = {"forward": np.asarray(jlm.forward(jp, jb, jcfg)[0]), "train": ref,
            "decode": reference_greedy(jcfg, jp, prompt, image, counts)}
    ranks = run_gloo("_torch_recipe:family_twin", 2, tmp_path_factory.mktemp("gloo_vlm_twin"),
                     timeout=400, shape=TWIN_MESH, models={"vlm": ref["tree"]},
                     batch={"vlm": {k: np.asarray(v) for k, v in jb.items()}},
                     train_batch={"vlm": ref["batch"]}, ocfg=RECIPE_OCFG,
                     prompts={"vlm": prompt}, counts=counts, image=image,
                     other_image=np.asarray(_image(jcfg, 4, 134)[0]))
    return want, ranks


@pytest.mark.parametrize("mode", ["tp", "sp", "sp_ring"])
def test_recipe_runs_by_name(twin, mode):
    """Under each recipe mode on a (1, 2) mesh the forward, the cache and
    the decode step (a whole-prompt chunk with an idle row, then greedy
    steps), and the recipe training step run, held against the
    reference's single-device programs: the forward within ``TOL``, each
    active row's decode logits within ``TOL`` and the greedy tokens equal,
    the step as ``_torch_families.check_recipe_step`` holds it; another
    image moves the chunk's logits."""
    want, ranks = twin
    check_recipe_step(want["train"], [r["train"] for r in ranks], "vlm", TWIN_MESH, mode)
    for rank, got in enumerate(ranks):
        where = f"{mode} rank {rank}"
        _close(got["forward"][("vlm", mode)], want["forward"], where)
        dec = got["decode"]
        for t, (g, w) in enumerate(zip(dec[("vlm", mode, "steps")], want["decode"]["steps"],
                                       strict=True)):
            for r, n in enumerate(TWIN_COUNTS[t]):
                _close(g[r, :n], w[r, :n], f"{where} step {t} row {r}")
        np.testing.assert_array_equal(dec[("vlm", mode, "tokens")], want["decode"]["tokens"])
        assert _moved(dec[("vlm", mode, "other")], dec[("vlm", mode, "steps")][0]) > 100 * TOL


def test_engine_refuses_the_family_with_its_reason():
    """The reference's engine builds no ``image_embeds`` batch, so it cannot
    serve its own VLM ``decode_step``; the port's engine refuses the family
    and names the reason."""
    _, _, tcfg, tp = models(ARCH)
    with pytest.raises(NotImplementedError, match="image_embeds"):
        Engine(tcfg, tp, ServeConfig(max_len=32, batch_slots=2))
