"""Helpers of the SSM, hybrid, VLM and audio families' parity tests: the
reference's SMOKE weights, seeded, with every constant-initialised leaf (the
token-shift mixes, decays, bonuses, norm weights, the LoRA's zero
``lora_b``, the GELU's zero biases, ...) perturbed by seeded noise and the
VLM's cross-attention gates opened, so that no path of the port is
multiplied away, carried over to the port with ``params_from_jax``."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.models.module import tree_leaves
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import Engine, ServeConfig

SPREAD = 0.2  # the noise's std on the constant leaves
RECIPE_BATCH = 4  # the recipe steps' rows (tests/_torch_recipe.py)
RECIPE_OCFG = dict(lr=1e-3, warmup_steps=0)  # AdamW of the recipe steps


def perturb(tree, seed: int = 1):
    """``tree`` with seeded noise added to every leaf whose values are all
    equal (the zeros and ones initialisations)."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + SPREAD * rng.standard_normal(a.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree.map(leaf, tree)


def open_gates(tree, seed: int = 7):
    """The VLM's cross blocks with their ``gate_attn``/``gate_ffn`` drawn
    from U[0.5, 1] (seeded): at their zero init ``tanh(0) = 0`` and every
    cross block passes its input through, which would hide the cross path
    (the SMOKE config's gates are single elements, which :func:`perturb`
    leaves as they are)."""
    rng = np.random.default_rng(seed)
    cross = dict(tree["cross_blocks"])
    for name in ("gate_attn", "gate_ffn"):
        cross[name] = jnp.asarray(rng.uniform(0.5, 1.0, cross[name].shape).astype(np.float32))
    return {**tree, "cross_blocks": cross}


def models(arch: str, act: str = "float32", *, attn_impl: str | None = "interpret", **overrides):
    """(jax cfg, jax params, torch cfg, torch params) of ``arch``'s SMOKE
    config at ``act`` activations (a VLM's gates opened,
    :func:`open_gates`)."""
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.dtype(act),
                               attn_impl=attn_impl, **overrides)
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), act_dtype=getattr(torch, act),
                               **overrides)
    jp = perturb(jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    if jcfg.family == "vlm":
        jp = open_gates(jp)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def inputs(cfg, B: int, S: int, seed: int = 0) -> tuple[dict, dict]:
    """(reference batch, port batch) of seeded inputs of ``cfg``'s input
    kind: token ids, frames (``embeds``), and a VLM's ``image_embeds``."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        arrays = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.input_kind == "tokens+image":
        arrays["image_embeds"] = rng.standard_normal((B, cfg.enc_len, cfg.enc_dim)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
             for k, v in arrays.items()})


def tokens(cfg, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def np_(x) -> np.ndarray:
    """A torch tensor or a JAX array as float32 numpy."""
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def leaves(tree) -> list:
    """The leaves of a (nested) named tuple or dict of states, in field order
    (dicts in sorted key order), for torch and JAX trees alike."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def assert_grads_close(got, want) -> None:
    """Every leaf of the port's gradient tree ``got`` against the
    reference's ``want`` (leaves in the same sorted order) to ``rtol=1e-4``
    and an ``atol`` of 1e-4 times the leaf's largest magnitude."""
    for i, (g, w) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want), strict=True)):
        w = np.asarray(w)
        np.testing.assert_allclose(np_(g), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"leaf {i}")


# a cache leaf's batch axis, counted from its trailing end (k, v: (B, G, T, D))
BATCH_AXIS_FROM_END = {"length": 1, "wkv": 4, "ssm": 4, "shift": 2, "cm_shift": 2, "conv": 3,
                       "k": 4, "v": 4}


def named_leaves(tree) -> list:
    """``(field name, leaf)`` of a port cache tree, in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k])]
    return [x for f, t in zip(tree._fields, tree)
            for x in (named_leaves(t) if isinstance(t, tuple) else [(f, t)])]


def serve_both(arch, *, slots=2, max_len=64, requests=5, prompt_lens=(1, 12), seed=0,
               **overrides):
    """Greedy tokens of the reference's and the port's engines on the same
    seeded requests; more requests than slots, so slots are released and
    reused.  Returns (want, got, the port's engine)."""
    jcfg, jp, tcfg, tp = models(arch, **overrides)
    jeng = JEngine(jcfg, jp, JServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1))
    teng = Engine(tcfg, tp, ServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1))
    rng = np.random.default_rng(seed)
    for rid in range(requests):
        prompt = rng.integers(2, 500, size=int(rng.integers(*prompt_lens))).tolist()
        max_new = int(rng.integers(3, 8))
        jeng.submit(rid, prompt, max_new)
        teng.submit(rid, prompt, max_new)
    return jeng.run(), teng.run(), teng


def recipe_reference_step(arch: str, seq: int, seed: int) -> dict:
    """The reference's single-device gradients and jitted step of ``arch``'s
    SMOKE config (float32, :func:`models`) on a seeded batch of
    ``RECIPE_BATCH`` x ``seq`` of its input kind: tokens shifted into
    labels, or frames with seeded labels; a VLM's images beside them."""
    jcfg, jp, _, _ = models(arch, attn_impl=None)
    jb, _ = inputs(jcfg, RECIPE_BATCH, seq + 1, seed=seed)
    jb = {k: np.asarray(v) for k, v in jb.items()}
    if "tokens" in jb:
        batch = {**jb, "tokens": jb["tokens"][:, :-1], "labels": jb["tokens"][:, 1:]}
    else:  # frames: their labels are seeded ids
        labels = np.random.default_rng(seed + 1).integers(0, jcfg.vocab, (RECIPE_BATCH, seq))
        batch = {"embeds": jb["embeds"][:, :-1], "labels": labels.astype(np.int32)}
    ocfg = jopt.OptConfig(**RECIPE_OCFG)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    _, grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, b, jcfg)
    new_p, _, m = jax.jit(jtr.make_train_step(jcfg, None, ocfg))(
        jp, jopt.init_opt_state(jp, ocfg), b)
    return {"tree": (arch, {}, jax.tree.map(np.asarray, jp)), "batch": batch,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "grads": grads,
            "params": [np.asarray(p) for p in jax.tree.leaves(new_p)]}


def check_recipe_step(want, ranks, name, shape, mode) -> None:
    """Every rank's recipe step (``_torch_recipe.train_named``) against the
    reference's: loss ``1e-4``, gradient norm ``rtol=1e-5``, the gradients
    as :func:`assert_grads_close`, the stepped parameters ``2e-4`` and the
    same on every rank."""
    for rank, got in enumerate(ranks):
        where = f"{name} {shape} {mode} rank {rank}"
        assert abs(got[(name, mode, "metrics")]["loss"] - want["loss"]) < 1e-4, where
        np.testing.assert_allclose(got[(name, mode, "metrics")]["grad_norm"], want["grad_norm"],
                                   rtol=1e-5, err_msg=where)
        for i, (g, w) in enumerate(zip(got[(name, mode, "grads")], jax.tree.leaves(want["grads"]),
                                       strict=True)):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{where} grad {i}")
        assert len(got[(name, mode, "params")]) == len(want["params"])
        for i, (p, w) in enumerate(zip(got[(name, mode, "params")], want["params"])):
            np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4, err_msg=f"{where} leaf {i}")
            np.testing.assert_array_equal(p, ranks[0][(name, mode, "params")][i])


def reference_greedy(jcfg, jp, prompt, image, counts) -> dict:
    """The reference's single-device VLM ``decode_step`` over the greedy
    loop of ``_torch_recipe.decode_greedy``: a whole-prompt chunk
    ``prompt`` (B, S) with ``counts[0]``, then one-token steps, each row
    fed its greedy token (``_torch_recipe.greedy_feed``) with ``counts[t]``,
    every row over its ``image``, from empty 16-position caches."""
    from _torch_recipe import greedy_feed

    step_fn = jax.jit(lambda p, s, b, c, prefill: jlm.decode_step(p, s, b, jcfg, new_counts=c,
                                                                  prefill=prefill),
                      static_argnames="prefill")
    B = prompt.shape[0]
    state = jlm.DecodeState(jlm.init_cache(jcfg, B, 16), jnp.zeros((B,), jnp.int32))
    logits, fed = [], []
    feed, prev = prompt, prompt[:, 0]
    for t, c in enumerate(counts):
        step, state = step_fn(jp, state, {"tokens": jnp.asarray(feed),
                                          "image_embeds": jnp.asarray(image)},
                              jnp.asarray(c), prefill=t == 0)
        logits.append(np.asarray(step))
        prev = greedy_feed(logits[-1], c, prev, jcfg.vocab)
        fed.append(prev)
        feed = prev[:, None]
    return {"steps": logits, "tokens": np.stack(fed),
            "caches": [np.asarray(t) for t in jax.tree.leaves(state.caches)],
            "positions": np.asarray(state.positions)}
