"""The port's dense LM against the reference's, on the CPU.

Weights are the reference's seeded ones, carried over with
``params_from_jax``.  The reference runs its attention kernels in interpret
mode (``attn_impl="interpret"``); the port runs on CPU tensors, so its
kernels' plain versions.  At float32 activations the logits and caches
agree to ``rtol=atol=1e-4`` (float32 sums in other orders through a few
layers).  One bfloat16 forward is held to ``rtol=atol=5e-2``: bf16 rounds
at other places in the two frameworks (XLA may fold converts in the
reference's unpinned forward), about one bf16 ulp per layer at the logits'
scale of a few units.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.weights import params_from_jax

ARCHS = ["phi4-mini-3.8b", "qwen2.5-32b", "internlm2-20b"]
TOL = 1e-4


def _models(arch, act="float32"):
    """(jax cfg, jax params, torch cfg, torch params) of the SMOKE config.
    The biased config gets nonzero biases, so the bias path shows."""
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.dtype(act),
                               attn_impl="interpret")
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), act_dtype=getattr(torch, act))
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            shape = jp["blocks"]["attn"][name].shape
            jp["blocks"]["attn"][name] = jnp.asarray(
                0.5 * rng.standard_normal(shape).astype(np.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    toks = _tokens(jcfg, (2, 40))
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.shape == (2, 40, tcfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_forward_bf16_matches_reference_loosely():
    jcfg, jp, tcfg, tp = _models("phi4-mini-3.8b", act="bfloat16")
    toks = _tokens(jcfg, (1, 40))
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2, atol=5e-2)


def test_count_params_matches_reference():
    for arch in ARCHS:
        for smoke in (True, False):
            assert tlm.count_params(tconfigs.get(arch, smoke=smoke)) == \
                jlm.count_params(jconfigs.get(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """A whole-prompt chunk (counts 5, 0, 8: the middle row idle, with no
    key it may see) and then one decode step (counts 1, 1, 0): every row's
    logits and every cache leaf agree; idle rows keep their K/V and length
    and do not advance.  The idle middle row of the chunk attends, as in the
    reference, over its cache with the chunk written (the mean of v), though
    the port never writes it."""
    jcfg, jp, tcfg, tp = _models(arch)
    B, T = 3, 32
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    steps = [(_tokens(jcfg, (B, 8), 1), np.array([5, 0, 8], np.int32), True),
             (_tokens(jcfg, (B, 1), 2), np.array([1, 1, 0], np.int32), False)]
    for toks, counts, prefill in steps:
        before = [t.clone() for t in (*tstate.caches, tstate.positions)]
        jlogits, jstate = jlm.decode_step(jp, jstate, {"tokens": jnp.asarray(toks)}, jcfg,
                                          new_counts=jnp.asarray(counts), prefill=prefill)
        tlogits, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(toks).long()},
                                          tcfg, new_counts=torch.from_numpy(counts),
                                          prefill=prefill)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=TOL, atol=TOL)
        for name, got, want in zip(("k", "v"), tstate.caches[:2], jstate.caches[:2]):
            np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_array_equal(tstate.caches.length.numpy(),
                                      np.asarray(jstate.caches.length))
        np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions))
        idle = np.flatnonzero(counts == 0)
        after = (*tstate.caches, tstate.positions)
        for old, new in zip(before, after):
            rows = (slice(None), idle) if old.ndim > 1 else (idle,)
            assert torch.equal(old[rows], new[rows])
