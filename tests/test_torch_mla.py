"""The port's MLA family (minicpm3) against the reference's, on the CPU.

Weights are the reference's seeded ``minicpm3-smoke`` ones, carried over
with ``params_from_jax``; activations are float32.  The reference runs its
attention kernel in interpret mode (``attn_impl="interpret"``); the port
runs on CPU tensors, so the kernel's plain version.  Tolerances: one
attention call ``rtol=atol=1e-5`` (float32 sums in other orders through a
few products); the LM's logits and caches ``1e-4`` (the same through two
layers, as ``test_torch_lm.py``).  The plain flash attention with a v head
dim of its own is held against the reference's Pallas kernel at ``1e-5``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "minicpm3-4b"
ATTN_TOL, LM_TOL = 1e-5, 1e-4


def _models():
    """(jax cfg, jax params, torch cfg, torch params) of the SMOKE config
    at float32 activations."""
    jcfg = dataclasses.replace(jconfigs.get(ARCH, smoke=True), act_dtype=jnp.float32,
                               attn_impl="interpret")
    tcfg = dataclasses.replace(tconfigs.get(ARCH, smoke=True), act_dtype=torch.float32)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _mla_kw(cfg):
    return dict(n_heads=cfg.n_heads, d_nope=cfg.mla_d_nope, d_rope=cfg.mla_d_rope,
                d_v=cfg.mla_d_v, rope_theta=cfg.rope_theta, block=cfg.attn_block)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def layer0(models):
    """The first layer's attention weights on both sides."""
    jcfg, jp, tcfg, tp = models
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]),
            {k: t[0] for k, t in tp["blocks"]["attn"].items()})


@pytest.mark.parametrize("seq", [40, 7])
def test_mla_attention_cache_free_matches_reference(models, layer0, seq):
    """The forward branch: decompressed K/V, q/k of d_nope + d_rope = 24 and
    v of d_v = 16 through the attention kernel's plain version, against the
    reference's (its Pallas kernel in interpret mode)."""
    jcfg, _, tcfg, _ = models
    jp, tp = layer0
    x = np.random.default_rng(3).standard_normal((2, seq, tcfg.d_model)).astype(np.float32)
    want, _ = jattn.mla_attention(jp, jnp.asarray(x), attn_impl="interpret", **_mla_kw(jcfg))
    got, cache = tattn.mla_attention(tp, torch.from_numpy(x), **_mla_kw(tcfg))
    assert cache is None and got.shape == (2, seq, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL, atol=ATTN_TOL)


def test_mla_absorbed_chunk_then_steps_match_reference_idle_rows_untouched(models, layer0):
    """The absorbed branch: a whole-prompt chunk (counts 5, 0, 8; the idle
    middle row sees no key, so it reads its written chunk as the reference's
    does), then two single-token steps (counts 1, 1, 0 and 0, 1, 1), each
    with per-row positions.  Outputs within 1e-5 of the reference's; the
    caches equal the reference's with its idle rows restored (its
    ``lm._mask_rows``); the port's idle rows are bitwise untouched."""
    jcfg, _, tcfg, _ = models
    jp, tp = layer0
    B, T = 3, 32
    rng = np.random.default_rng(4)
    r, dr = tcfg.mla_kv_rank, tcfg.mla_d_rope
    c0 = rng.standard_normal((B, T, r)).astype(np.float32)
    kr0 = rng.standard_normal((B, T, dr)).astype(np.float32)
    jc = jattn.MLACache(jnp.asarray(c0), jnp.asarray(kr0), jnp.zeros((B,), jnp.int32))
    tc = tattn.MLACache(torch.from_numpy(c0.copy()), torch.from_numpy(kr0.copy()),
                        torch.zeros((B,), dtype=torch.int32))
    pos = np.zeros((B,), np.int32)
    for S, counts in ((8, (5, 0, 8)), (1, (1, 1, 0)), (1, (0, 1, 1))):
        counts = np.array(counts, np.int32)
        x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
        pos2d = pos[:, None] + np.arange(S, dtype=np.int32)[None, :]
        want, jnew = jattn.mla_attention(jp, jnp.asarray(x), positions=jnp.asarray(pos2d),
                                         cache=jc, new_counts=jnp.asarray(counts),
                                         attn_impl="interpret", **_mla_kw(jcfg))
        before = [t.clone() for t in tc]
        got, tc = tattn.mla_attention(tp, torch.from_numpy(x), positions=torch.from_numpy(pos2d),
                                      cache=tc, new_counts=torch.from_numpy(counts),
                                      **_mla_kw(tcfg))
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL, atol=ATTN_TOL)
        active = jnp.asarray(counts > 0)
        jc = jax.tree.map(lambda n, o: jnp.where(active.reshape((-1,) + (1,) * (n.ndim - 1)),
                                                 n, o), jnew, jc)
        for name, g, w in zip(("c", "kr", "length"), tc, jc):
            np.testing.assert_allclose(_np(g), _np(w), rtol=ATTN_TOL, atol=ATTN_TOL,
                                       err_msg=name)
        idle = np.flatnonzero(counts == 0)
        for old, new in zip(before, tc):
            assert torch.equal(old[idle], new[idle])
        pos = pos + counts


def test_forward_logits_match_reference(models):
    jcfg, jp, tcfg, tp = models
    toks = _tokens(jcfg, (2, 40))
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.shape == (2, 40, tcfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=LM_TOL, atol=LM_TOL)


def test_decode_step_matches_reference(models):
    """A whole-prompt chunk (counts 5, 0, 8) and one decode step (counts 1,
    1, 0) through ``lm.decode_step``: logits and latent caches within 1e-4
    of the reference's, lengths and positions equal, idle rows' caches,
    lengths and positions bitwise unchanged."""
    jcfg, jp, tcfg, tp = models
    B, T = 3, 32
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    assert isinstance(tstate.caches, tattn.MLACache)
    assert tstate.caches.c.shape == (tcfg.n_layers, B, T, tcfg.mla_kv_rank)
    assert tstate.caches.kr.shape == (tcfg.n_layers, B, T, tcfg.mla_d_rope)
    steps = [(_tokens(jcfg, (B, 8), 1), np.array([5, 0, 8], np.int32), True),
             (_tokens(jcfg, (B, 1), 2), np.array([1, 1, 0], np.int32), False)]
    for toks, counts, prefill in steps:
        before = [t.clone() for t in (*tstate.caches, tstate.positions)]
        jlogits, jstate = jlm.decode_step(jp, jstate, {"tokens": jnp.asarray(toks)}, jcfg,
                                          new_counts=jnp.asarray(counts), prefill=prefill)
        tlogits, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(toks).long()},
                                          tcfg, new_counts=torch.from_numpy(counts),
                                          prefill=prefill)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=LM_TOL, atol=LM_TOL)
        for name, got, want in zip(("c", "kr"), tstate.caches[:2], jstate.caches[:2]):
            np.testing.assert_allclose(_np(got), _np(want), rtol=LM_TOL, atol=LM_TOL,
                                       err_msg=name)
        np.testing.assert_array_equal(tstate.caches.length.numpy(),
                                      np.asarray(jstate.caches.length))
        np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions))
        idle = np.flatnonzero(counts == 0)
        for old, new in zip(before, (*tstate.caches, tstate.positions)):
            rows = (slice(None), idle) if old.ndim > 1 else (idle,)
            assert torch.equal(old[rows], new[rows])


def test_greedy_tokens_match_reference_engine(models):
    """More requests than slots: admission staggers, and a slot's
    whole-prompt chunk runs through the latent cache while other slots are
    resident."""
    jcfg, jp, tcfg, tp = models
    jeng = JEngine(jcfg, jp, JServeConfig(max_len=64, batch_slots=2, eos_token=-1))
    teng = Engine(tcfg, tp, ServeConfig(max_len=64, batch_slots=2, eos_token=-1))
    rng = np.random.default_rng(0)
    for rid in range(4):
        prompt = rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist()
        max_new = int(rng.integers(3, 8))
        jeng.submit(rid, prompt, max_new)
        teng.submit(rid, prompt, max_new)
    want = jeng.run()
    got = teng.run()
    assert sorted(got) == list(range(4))
    assert got == want
    assert teng.steps["prefill"] >= 2
    assert teng.ledger.lengths == [0, 0]
    # the ledger charges the latent cache: (kv_rank + d_rope) a position and layer
    assert teng.ledger.bytes_per_pos == tcfg.n_layers * (tcfg.mla_kv_rank + tcfg.mla_d_rope) * 4


@pytest.mark.parametrize("smoke", [True, False])
def test_count_params_matches_reference(smoke):
    """From the specs alone (no weight is allocated): about 4.08 B for the
    published config."""
    got = tlm.count_params(tconfigs.get(ARCH, smoke=smoke))
    assert got == jlm.count_params(jconfigs.get(ARCH, smoke=smoke))
    if not smoke:
        assert 4.0e9 < got < 4.2e9


def test_mla_under_a_recipe_runs_and_matches_reference(models, tmp_path):
    """The call that used to refuse: ``lm.forward`` under an ``sp_ring``
    recipe with a ``model`` axis of 2, now on 2 gloo ranks, each on its
    chunk of the sequence, against the reference's single-device forward
    (its MLA does not ring): the same logits on both ranks, within
    ``LM_TOL``.  ``tests/test_torch_recipe_mla*.py`` hold every mode."""
    from _torch_dist import run_gloo

    jcfg, jp, tcfg, _ = models
    toks = _tokens(tcfg, (1, 8))
    want = _np(jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)[0])
    ranks = run_gloo("_torch_recipe:forward_named", 2, tmp_path, shape=(1, 2),
                     models={"mla": (ARCH, {}, jax.tree.map(np.asarray, jp))},
                     tokens={"mla": toks}, modes=("sp_ring",))
    for got in ranks:
        np.testing.assert_allclose(got[("mla", "sp_ring")], want, rtol=LM_TOL, atol=LM_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(24, 16, 40, 40), (24, 16, 33, 70), (96, 64, 40, 40)])
def test_flash_attention_plain_with_own_v_head_dim_matches_pallas(dims, causal):
    """The plain flash attention with a v head dim of its own, ragged S and
    KV blocks of 16 (the last one padded), GQA 2, against the reference's
    Pallas kernel in interpret mode: (B, Hq, Sq, Dv) out."""
    D, Dv, Sq, Skv = dims
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 4, Sq, D)).astype(np.float32)
    k = rng.standard_normal((2, 2, Skv, D)).astype(np.float32)
    v = rng.standard_normal((2, 2, Skv, Dv)).astype(np.float32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  bq=16, bk=16, interpret=True)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=causal, block=16)
    assert got.shape == (2, 4, Sq, Dv) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL, atol=ATTN_TOL)
