"""The port's audio family (musicgen-large: the dense stack with the GELU
MLP over the ``embeds`` input kind, the stub codec's frame embeddings plus
sinusoidal positions) against the reference's, on the CPU, and its
single-host serving through the engine's featurizer.

The SMOKE config (2 layers, MHA, head dim 16), float32 activations, inputs
made from a numpy seed, and the reference's seeded weights carried over with
``params_from_jax``, every constant leaf (the GELU's zero biases among
them) perturbed (``tests/_torch_families.py``).  The reference's attention
runs its Pallas kernels in interpret mode, the port's its kernels' plain
versions; for gradients the reference's is its differentiable
``blockwise_attention_ref``.  Tolerances: the sinusoidal table, per
position ``p``, ``(p + 1) * 2**-22``: XLA's and torch's float32 ``exp``
give frequencies up to one ulp apart (about 2**-24 relative), which moves
an angle by ``p`` such ulps, so at 4096 positions the tables differ by up
to 2.4e-4 at d_model 2048; the engine's numpy featurizer is the
reference's bitwise.  Logits and caches ``rtol=atol=1e-4``; decode against
the forward ``2e-4`` (the reference's own, ``tests/test_decode.py``);
greedy tokens equal; the loss ``1e-5`` and every gradient leaf as
``assert_grads_close`` states; one AdamW step: loss ``1e-4``, parameters
``rtol=atol=2e-4``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.module import tree_leaves
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttr

from _torch_dist import run_gloo
from _torch_families import (BATCH_AXIS_FROM_END, RECIPE_OCFG, assert_grads_close,
                             check_recipe_step, inputs, leaves, models, named_leaves, np_,
                             recipe_reference_step, serve_both)

ARCH = "musicgen-large"
TOL = 1e-4
DECODE_TOL = 2e-4  # tests/test_decode.py TOLS["audio"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol, err_msg=msg)


# ------------------------------------------------------------- structure ----

def test_param_tree_and_count_match_reference():
    """No embedding table (frames come in), the head, and the GELU MLP's
    weights and biases stacked over the layers."""
    for smoke in (True, False):
        jcfg, tcfg = jconfigs.get(ARCH, smoke=smoke), tconfigs.get(ARCH, smoke=smoke)
        want = jax.tree.map(lambda s: tuple(s.shape), jlm.build_specs(jcfg),
                            is_leaf=lambda s: hasattr(s, "layout"))
        got = tlm.build_specs(tcfg)
        assert "embed" not in got and sorted(got["blocks"]["ffn"]) == ["b_in", "b_out", "w_in",
                                                                       "w_out"]
        assert jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple)) == \
            [tuple(s.shape) for s in tree_leaves(got)]
        assert tlm.count_params(tcfg) == jlm.count_params(jcfg)


# ------------------------------------------------------------ embeddings ----

@pytest.mark.parametrize("d", [64, 2048])
def test_sinusoidal_table_matches_reference(d):
    """The table at positions 0..4095, shared (S,) and per row (B, S),
    within the tolerance the frequencies' one ulp gives (module docstring)."""
    pos = np.arange(4096, dtype=np.int32)
    want = np.asarray(jlm._sinusoidal(jnp.asarray(pos), d))
    got = tlm._sinusoidal(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (4096, d)
    err = np.abs(got.numpy() - want).max(axis=-1)
    assert np.all(err <= (pos + 1) * 2.0 ** -22), float(err.max())
    rows = torch.from_numpy(pos.reshape(2, 2048))
    assert torch.equal(tlm._sinusoidal(rows, d), got.reshape(2, 2048, d))


def test_engine_featurizer_is_the_reference_bitwise():
    ids = [0, 1, 5, 127, 2047, 100000]
    for d in (64, 2048):
        np.testing.assert_array_equal(tengine._np_sinusoidal(ids, d),
                                      jengine._np_sinusoidal(ids, d))


def test_embed_inputs_rounds_as_the_reference():
    """bf16 activations: the frames and the float32 table are each cast to
    bf16 and added there (one bf16 add), not added in float32 and rounded
    after; wherever the two tables agree the result is the reference's bit
    for bit, and the other order gives other bits."""
    jcfg, _, tcfg, _ = models(ARCH, act="bfloat16")
    B, S = 2, 64
    jb, tb = inputs(jcfg, B, S, seed=1)
    pos = np.arange(3, 3 + B * S, dtype=np.int32).reshape(B, S)  # per-row positions
    got = tlm.embed_inputs({}, tb, tcfg, positions=torch.from_numpy(pos))
    want = np.asarray(jlm.embed_inputs({}, jb, jcfg, positions=jnp.asarray(pos)).astype(
        jnp.float32))
    same = tlm._sinusoidal(torch.from_numpy(pos), tcfg.d_model).numpy() == \
        np.asarray(jlm._sinusoidal(jnp.asarray(pos), jcfg.d_model))
    assert got.dtype == torch.bfloat16 and same.mean() > 0.5
    np.testing.assert_array_equal(got.float().numpy()[same], want[same])
    pe = tlm._sinusoidal(torch.from_numpy(pos), tcfg.d_model)
    assert torch.equal(got, tb["embeds"].to(torch.bfloat16) + pe.to(torch.bfloat16))
    assert not torch.equal(got, (tb["embeds"] + pe).to(torch.bfloat16))


# ------------------------------------------------------------ the model ----

def test_forward_matches_reference():
    jcfg, jp, tcfg, tp = models(ARCH)
    jb, tb = inputs(jcfg, 2, 32, seed=2)
    want, _ = jlm.forward(jp, jb, jcfg)
    got, aux = tlm.forward(tp, tb, tcfg)
    assert got.shape == (2, 32, tcfg.vocab_padded) and float(aux) == 0.0
    _close(got, want)


def test_decode_matches_forward():
    """The twin of the reference's ``tests/test_decode.py::
    test_decode_matches_forward`` for the family: 16 one-frame decode steps
    (sinusoidal positions per row) against the full-sequence forward."""
    _, _, tcfg, tp = models(ARCH)
    B, S = 2, 16
    _, tb = inputs(tcfg, B, S, seed=3)
    tb = {"embeds": 0.3 * tb["embeds"]}  # the reference test's input scale
    state = tlm.DecodeState(tlm.init_cache(tcfg, B, S, device="cpu"),
                            torch.zeros((B,), dtype=torch.int32))
    outs = []
    for t in range(S):
        logits, state = tlm.decode_step(tp, state, {"embeds": tb["embeds"][:, t:t + 1]}, tcfg)
        outs.append(logits[:, 0])
    full, _ = tlm.forward(tp, tb, tcfg)
    _close(torch.stack(outs, dim=1), full, tol=DECODE_TOL)


def test_decode_step_matches_reference_with_idle_rows():
    """A whole-prompt chunk of frames (``prefill=True``: rows of 5 and 9,
    a third idle), then 6 one-frame steps with a row idle for two: active
    rows' logits and every cache leaf against the reference's
    ``decode_step``; idle rows' K/V and lengths bitwise."""
    jcfg, jp, tcfg, tp = models(ARCH)
    B, T, S = 3, 32, 16
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    frames = np.random.default_rng(4).standard_normal((B, S + 6, jcfg.d_model)).astype(
        np.float32)
    jstep = jax.jit(lambda p, s, b, c, prefill: jlm.decode_step(p, s, b, jcfg, new_counts=c,
                                                                prefill=prefill),
                    static_argnames="prefill")
    steps = [(frames[:, :S], np.array([5, 9, 0], np.int32), True)]
    for t in range(6):
        steps.append((frames[:, S + t:S + t + 1],
                      np.array([1, 0 if t in (1, 2) else 1, 1], np.int32), False))
    for t, (b, counts, prefill) in enumerate(steps):
        before = [x.clone() for x in leaves(tstate.caches)]
        jl, jstate = jstep(jp, jstate, {"embeds": jnp.asarray(b)}, jnp.asarray(counts),
                           prefill=prefill)
        tl, tstate = tlm.decode_step(tp, tstate, {"embeds": torch.from_numpy(b.copy())}, tcfg,
                                     new_counts=torch.from_numpy(counts), prefill=prefill)
        for r in np.flatnonzero(counts):
            _close(tl[r, :counts[r]], np.asarray(jl)[r, :counts[r]], f"step {t} row {r}")
        for old, (name, new) in zip(before, named_leaves(tstate.caches)):
            axis = new.ndim - BATCH_AXIS_FROM_END[name]
            for r in np.flatnonzero(counts == 0):
                assert torch.equal(old.select(axis, r), new.select(axis, r)), (t, name)
    for g, w in zip(leaves(tstate.caches), leaves(jstate.caches), strict=True):
        _close(g, w)


# -------------------------------------------------------------- serving ----

def test_engine_matches_reference():
    """Greedy tokens equal the reference engine's: 5 featurized requests on
    2 slots (released and reused), prompts of up to 12 ids prefilled as one
    chunk of frames."""
    want, got, teng = serve_both(ARCH)
    assert sorted(got) == list(range(5))
    assert got == want
    assert teng.steps["prefill"] < 5  # whole-prompt chunks, not token by token


def test_embeds_engine_prompt_dependence():
    """The twin of the reference's ``tests/test_engine.py::
    test_embeds_engine_prompt_dependence``: different prompts give
    different continuations, and explicit ``prompt_embeds`` reproduce the
    featurized ids' path (the embeds-only request returns generated ids
    only); the tokens are the reference engine's."""
    jcfg, jp, tcfg, tp = models(ARCH)
    scfg = tengine.ServeConfig(max_len=32, batch_slots=2, eos_token=-1)
    jscfg = jengine.ServeConfig(max_len=32, batch_slots=2, eos_token=-1)
    eng, jeng = tengine.Engine(tcfg, tp, scfg), jengine.Engine(jcfg, jp, jscfg)
    for e in (eng, jeng):
        e.submit(0, [3, 5, 7], max_new_tokens=6)
        e.submit(1, [90, 60, 110], max_new_tokens=6)
    done = eng.run()
    assert done == jeng.run()
    for rid in (0, 1):
        assert len(done[rid]) == 3 + 6
        assert all(0 <= t < tcfg.vocab for t in done[rid][3:])
    assert done[0][3:] != done[1][3:]
    emb = eng._featurize([3, 5, 7])
    eng2 = tengine.Engine(tcfg, tp, scfg)
    eng2.submit(0, [3, 5, 7], max_new_tokens=6)
    eng2.submit(1, prompt_embeds=emb, max_new_tokens=6)
    d2 = eng2.run()
    assert d2[0][3:] == d2[1] == done[0][3:]
    with pytest.raises(ValueError, match="prompt_embeds must be"):
        eng2.submit(2, prompt_embeds=emb[:, :5])
    with pytest.raises(ValueError, match="prompt and/or prompt_embeds"):
        eng2.submit(3)


def test_serve_cli_serves_the_family_on_the_cpu():
    """``launch/serve.py --arch musicgen-large --smoke --device cpu``: the
    reference launcher's seeded prompts through the featurizer, 5 requests
    on 2 slots, every request done."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                           "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
                           "--max-new", "4"], capture_output=True, text=True, timeout=240,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] 5 done / 0 in flight, 20 tokens requested" in proc.stdout


# -------------------------------------------------------------- training ----

def test_loss_and_grads_match_reference():
    jcfg, jp, tcfg, tp = models(ARCH, attn_impl=None)
    jb, tb = inputs(jcfg, 2, 32, seed=5)
    labels = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
    tl, _, tg = ttr._accum_loss_grads(tp, tb, tcfg, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(tg, jg)


def test_train_step_matches_reference():
    """One ``make_train_step`` step (AdamW, ``lr=1e-3``, no warmup) on a
    pipeline batch (``embeds``, float32 on the device) against the
    reference's jitted single-device step."""
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
    assert tbatch["embeds"].dtype == torch.float32 and tbatch["labels"].dtype == torch.long
    new_tp, _, tm = ttr.make_train_step(tcfg, None, tocfg)(tp, topt.init_opt_state(tp, tocfg),
                                                          tbatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
    for i, (a, b) in enumerate(zip(tree_leaves(new_tp), jax.tree.leaves(new_jp), strict=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=f"leaf {i}")


# ------------------------------------------------------ under a recipe ----

TWIN_MESH = (1, 2)  # a model axis of 2: two of the 4 heads a rank
TWIN_COUNTS = [(7, 5, 0, 3), (1, 1, 1, 0), (1, 0, 1, 1)]


def _twin_requests():
    rng = np.random.default_rng(141)
    return [(rid, rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist(),
             int(rng.integers(3, 8))) for rid in range(5)]


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The reference's single-device forward, engine, decode steps and
    train step, and the port's under each mode on 2 gloo ranks of a (1, 2)
    mesh (one job, ``_torch_recipe.family_twin``)."""
    ref = recipe_reference_step(ARCH, 12, 140)
    jcfg, jp, _, _ = models(ARCH)
    jb, _ = inputs(jcfg, 4, 12, seed=142)
    rng = np.random.default_rng(143)
    steps = [({"embeds": rng.standard_normal((4, 7 if t == 0 else 1, jcfg.d_model)).astype(
        np.float32)}, np.array(c, np.int32)) for t, c in enumerate(TWIN_COUNTS)]
    jeng = jengine.Engine(jcfg, jp, jengine.ServeConfig(max_len=64, batch_slots=4, eos_token=-1))
    for rid, prompt, n in _twin_requests():
        jeng.submit(rid, prompt, n)
    state = jlm.DecodeState(jlm.init_cache(jcfg, 4, 16), jnp.zeros((4,), jnp.int32))
    logits = []
    for t, (frames, counts) in enumerate(steps):
        step, state = jlm.decode_step(jp, state, {"embeds": jnp.asarray(frames["embeds"])}, jcfg,
                                      new_counts=jnp.asarray(counts), prefill=t == 0)
        logits.append(np.asarray(step))
    want = {"forward": np.asarray(jlm.forward(jp, jb, jcfg)[0]), "train": ref,
            "tokens": jeng.run(), "steps": logits}
    ranks = run_gloo("_torch_recipe:family_twin", 2, tmp_path_factory.mktemp("gloo_audio_twin"),
                     timeout=400, shape=TWIN_MESH, models={"audio": ref["tree"]},
                     batch={"audio": {k: np.asarray(v) for k, v in jb.items()}},
                     train_batch={"audio": ref["batch"]}, ocfg=RECIPE_OCFG,
                     requests={"audio": _twin_requests()}, steps={"audio": steps})
    return want, ranks


@pytest.mark.parametrize("mode", ["tp", "sp", "sp_ring"])
def test_recipe_runs_by_name(twin, mode):
    """Under each recipe mode on a (1, 2) mesh the forward, the cache and
    the decode step (a whole-prompt chunk of frames with an idle row, then
    one-frame steps), ``Engine(recipe=)`` and the recipe training step run,
    held against the reference's single-device programs: the forward and
    each active row's decode logits within ``TOL``, the engine's greedy
    tokens equal to the reference engine's, the step as
    ``_torch_families.check_recipe_step`` holds it."""
    want, ranks = twin
    check_recipe_step(want["train"], [r["train"] for r in ranks], "audio", TWIN_MESH, mode)
    for rank, got in enumerate(ranks):
        where = f"{mode} rank {rank}"
        _close(got["forward"][("audio", mode)], want["forward"], where)
        srv = got["serve"]
        assert srv[("audio", mode, "tokens")] == want["tokens"], where
        assert srv[("audio", mode, "local")], where
        for t, (g, w) in enumerate(zip(srv[("audio", mode, "steps")], want["steps"],
                                       strict=True)):
            for r, n in enumerate(TWIN_COUNTS[t]):
                _close(g[r, :n], w[r, :n], f"{where} step {t} row {r}")


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_train_launcher_trains_under_a_recipe_mode(arch, tmp_path):
    """``launch/train.py --attn-mode tp`` on 2 gloo ranks (the world
    ``torchrun`` would make: a (1, 2) mesh) trains both families under the
    recipe: every step's loss is the one-process run's (bf16 activations)."""
    from repro_torch.launch import train as tlaunch

    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--log-every", "1"]
    ranks = run_gloo("_torch_recipe:train_launcher", 2, tmp_path / "gloo",
                     argv=argv + ["--attn-mode", "tp", "--ckpt-dir", str(tmp_path / "tp")])
    one = tlaunch.run(tlaunch.parse_args(argv + ["--ckpt-dir", str(tmp_path / "one")]))
    for rank, got in enumerate(ranks):
        assert len(got["loss"]) == 2, rank
        assert max(abs(a - b) for a, b in zip(got["loss"], one["loss"])) < 1e-3, (got, one)
