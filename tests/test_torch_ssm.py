"""The port's SSM family (rwkv6-3b) and its two mixers against the
reference's, on the CPU.

Inputs are made from a numpy seed and the reference's seeded weights are
carried over with ``params_from_jax``, every constant-initialised leaf
perturbed (``tests/_torch_families.py``).  Float32 activations, the SMOKE
config's ``ssm_chunk=16``.  Tolerances: the mixers, blocks, logits and
states ``rtol=atol=1e-4`` (float32 sums in other orders; the reference's
own decode-vs-forward tolerance for these families is 5e-3,
``tests/test_decode.py``); the loss ``rtol=1e-5`` and every gradient leaf
to ``rtol=1e-4`` with an ``atol`` of 1e-4 times the leaf's largest
magnitude (``_torch_families.assert_grads_close``: the gradients run back
through 32 steps of the recurrence, and float32 sums in other orders leave
up to 9e-6 of a leaf's scale on its near-zero entries).  No kernel runs here: the reference's mixers
are jnp too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import blocks as jblk
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.module import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.models import blocks as tblk
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.train import trainer as ttr

from _torch_families import (assert_grads_close, leaves, models, np_, perturb, serve_both,
                             tokens)

TOL = 1e-4
M, H, CHUNK = 64, 4, 16  # the SMOKE config's width, heads and chunk
MAMBA = dict(d_state=16, head_dim=16, expand=2, n_groups=1)  # zamba2's SMOKE mixer

# (S, with an incoming state): the chunked form from zero and from a state,
# and the exact recurrence (a state and S <= 4) over 3 tokens and 1
FORMS = {"chunked": (32, False), "chunked_from_state": (32, True),
         "recurrence": (3, True), "recurrence_one_token": (1, True)}


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, M)).astype(np.float32)


def _pair(specs, seed):
    jp = perturb(jinit(specs, jax.random.PRNGKey(seed)), seed)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _rwkv_state(B, seed):
    rng = np.random.default_rng(seed)
    wkv = rng.standard_normal((B, H, M // H, M // H)).astype(np.float32)
    shift = rng.standard_normal((B, M)).astype(np.float32)
    return (jssm.RWKVState(jnp.asarray(wkv), jnp.asarray(shift)),
            tssm.RWKVState(torch.from_numpy(wkv), torch.from_numpy(shift)))


def _mamba_state(B, seed):
    rng = np.random.default_rng(seed)
    Hm = MAMBA["expand"] * M // MAMBA["head_dim"]
    conv_ch = MAMBA["expand"] * M + 2 * MAMBA["d_state"]
    ssm = rng.standard_normal((B, Hm, MAMBA["head_dim"], MAMBA["d_state"])).astype(np.float32)
    conv = rng.standard_normal((B, 3, conv_ch)).astype(np.float32)
    return (jssm.MambaState(jnp.asarray(ssm), jnp.asarray(conv)),
            tssm.MambaState(torch.from_numpy(ssm), torch.from_numpy(conv)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("form", FORMS)
def test_rwkv6_mix_matches_reference(form):
    S, with_state = FORMS[form]
    jp, tp = _pair(jssm.rwkv6_specs(M, H), 3)
    x = _x(2, S, 4)
    js, ts = _rwkv_state(2, 5) if with_state else (None, None)
    want, wstate = jssm.rwkv6_mix(jp, jnp.asarray(x), n_heads=H, chunk=CHUNK, state=js)
    got, gstate = tssm.rwkv6_mix(tp, torch.from_numpy(x), n_heads=H, chunk=CHUNK, state=ts)
    _close(got, want)
    for name, g, w in zip(("wkv", "shift"), gstate, wstate):
        _close(g, w, name)


@pytest.mark.parametrize("form", FORMS)
def test_mamba2_mix_matches_reference(form):
    S, with_state = FORMS[form]
    jp, tp = _pair(jssm.mamba2_specs(M, **MAMBA), 6)
    x = _x(2, S, 7)
    js, ts = _mamba_state(2, 8) if with_state else (None, None)
    want, wstate = jssm.mamba2_mix(jp, jnp.asarray(x), chunk=CHUNK, state=js, **MAMBA)
    got, gstate = tssm.mamba2_mix(tp, torch.from_numpy(x), chunk=CHUNK, state=ts, **MAMBA)
    _close(got, want)
    for name, g, w in zip(("ssm", "conv"), gstate, wstate):
        _close(g, w, name)


def test_rwkv6_chunked_form_keeps_the_reference_clamp():
    """At the reference's own initialisation (``w0 = 0``: a decay of about
    e^-1 a step, unperturbed) and rwkv6-3b's chunk of 64, a chunk's
    cumulative log decay passes -30, where the reference clamps each
    within-chunk factor to exp(+-30) on its own (a score whose true factor
    is far below 1 gets e^-30 * e^30): its chunked form departs from its
    recurrence there.  The port keeps those numerics: its chunked form is
    the reference's."""
    jp = jinit(jssm.rwkv6_specs(M, H), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = _x(1, 128, 16)
    logw = np.asarray(jssm._rwkv_streams(jp, jnp.asarray(x), jnp.asarray(x))[4])
    assert logw.reshape(1, 2, 64, M).sum(axis=2).max() < -30  # every chunk reaches the clamp
    want, wstate = jssm.rwkv6_mix(jp, jnp.asarray(x), n_heads=H, chunk=64)
    got, gstate = tssm.rwkv6_mix(tp, torch.from_numpy(x), n_heads=H, chunk=64)
    _close(got, want)
    _close(gstate.wkv, wstate.wkv, "wkv")


@pytest.mark.parametrize("mixer", ["rwkv6", "mamba2"])
def test_chunked_form_refuses_a_sequence_the_chunk_does_not_divide(mixer):
    x = torch.zeros((1, CHUNK + 1, M))
    if mixer == "rwkv6":
        _, tp = _pair(jssm.rwkv6_specs(M, H), 3)
        call = lambda: tssm.rwkv6_mix(tp, x, n_heads=H, chunk=CHUNK)
    else:
        _, tp = _pair(jssm.mamba2_specs(M, **MAMBA), 6)
        call = lambda: tssm.mamba2_mix(tp, x, chunk=CHUNK, **MAMBA)
    with pytest.raises(ValueError, match="multiple of chunk"):
        call()


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_block_matches_reference(with_state):
    jcfg, _, tcfg, _ = models("rwkv6-3b")
    jp, tp = _pair(jblk.rwkv_block_specs(jcfg), 9)
    S = 2 if with_state else 32
    x = _x(2, S, 10)
    js = ts = None
    if with_state:
        (jt, tt), shift = _rwkv_state(2, 11), np.random.default_rng(12).standard_normal(
            (2, M)).astype(np.float32)
        js = jblk.RWKVBlockState(jt, jnp.asarray(shift))
        ts = tblk.RWKVBlockState(tt, torch.from_numpy(shift))
    want, wstate, _ = jblk.rwkv_block(jp, jnp.asarray(x), jcfg, state=js)
    got, gstate, aux = tblk.rwkv_block(tp, torch.from_numpy(x), tcfg, state=ts)
    assert aux == 0.0
    _close(got, want)
    for g, w in zip(leaves(gstate), leaves(wstate)):
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_reference(with_state):
    jcfg, _, tcfg, _ = models("zamba2-7b")
    jp, tp = _pair(jblk.mamba_block_specs(jcfg), 13)
    S = 1 if with_state else 32
    x = _x(2, S, 14)
    js, ts = _mamba_state(2, 15) if with_state else (None, None)
    want, wstate, _ = jblk.mamba_block(jp, jnp.asarray(x), jcfg, state=js)
    got, gstate, _ = tblk.mamba_block(tp, torch.from_numpy(x), tcfg, state=ts)
    _close(got, want)
    for g, w in zip(leaves(gstate), leaves(wstate)):
        _close(g, w)


def test_forward_matches_reference():
    jcfg, jp, tcfg, tp = models("rwkv6-3b")
    toks = tokens(jcfg, (2, 32))
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.shape == (2, 32, tcfg.vocab_padded) and float(aux) == 0.0
    _close(got, want)


def test_forward_bf16_matches_reference_loosely():
    """bf16 activations, held by the relative Frobenius error of the logits,
    at most ``2e-2``: bf16 rounds at other places in the two frameworks (XLA
    may fold a convert into the float32 decay that follows it), and the
    recurrence carries a decay's bf16 ulp (``2**-8``) into every later
    token, so single logits near 0 differ by more than their size."""
    jcfg, jp, tcfg, tp = models("rwkv6-3b", act="bfloat16")
    toks = tokens(jcfg, (1, 32))
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.dtype == torch.bfloat16
    got, want = np_(got), np_(want)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_decode_loop_matches_reference_and_forward():
    """16 decode steps of one token: every step's logits and the whole
    state against the reference's ``decode_step``, and the logits against
    the port's own forward over the same 16 tokens."""
    jcfg, jp, tcfg, tp = models("rwkv6-3b")
    B, T = 2, 16
    toks = tokens(jcfg, (B, T), 1)
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    step = jax.jit(lambda p, s, b: jlm.decode_step(p, s, b, jcfg))
    got = []
    for t in range(T):
        jl, jstate = step(jp, jstate, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()},
                                     tcfg)
        _close(tl, jl, f"step {t}")
        got.append(tl)
    for g, w in zip(leaves(tstate.caches), leaves(jstate.caches)):
        _close(g, w)
    np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions))
    full, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    _close(torch.cat(got, dim=1), full)


def test_decode_step_keeps_idle_rows():
    """Counts 1, 0, 1: the active rows' logits and states are the
    reference's, the idle row's state is bitwise untouched and its position
    does not advance."""
    jcfg, jp, tcfg, tp = models("rwkv6-3b")
    B = 3
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, 8), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, 8, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    for t, counts in enumerate(([1, 1, 1], [1, 0, 1], [0, 1, 1])):
        counts = np.array(counts, np.int32)
        toks = tokens(jcfg, (B, 1), 20 + t)
        before = [x.clone() for x in leaves(tstate.caches)]
        jl, jstate = jlm.decode_step(jp, jstate, {"tokens": jnp.asarray(toks)}, jcfg,
                                     new_counts=jnp.asarray(counts))
        tl, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(toks).long()}, tcfg,
                                     new_counts=torch.from_numpy(counts))
        live = np.flatnonzero(counts)
        _close(tl[live], np.asarray(jl)[live])
        for old, g, w in zip(before, leaves(tstate.caches), leaves(jstate.caches)):
            _close(g, w)
            idle = np.flatnonzero(counts == 0)
            assert torch.equal(old[:, idle], g[:, idle])
        np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions))


def test_engine_matches_reference_with_reused_slots():
    """Greedy tokens equal the reference engine's, 5 requests on 2 slots
    (each slot released and reused; a released slot's recurrent state is
    zeroed before its next request).  No prefill chunk: the family prefills
    token by token."""
    want, got, teng = serve_both("rwkv6-3b")
    assert sorted(got) == list(range(5))
    assert got == want
    assert teng.ledger.lengths == [0, 0]
    assert teng.ledger.valid_fraction() == 1.0  # no cache grows with length


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_kv_bytes_per_pos_is_zero(arch):
    assert tengine._kv_bytes_per_pos(tconfigs.get(arch)) == 0


def test_loss_and_grads_match_reference():
    """``lm.loss_fn`` and its gradients through the RWKV6 blocks (remat on)
    against ``jax.value_and_grad`` of the reference's."""
    jcfg, jp, tcfg, tp = models("rwkv6-3b", attn_impl=None)
    toks = tokens(jcfg, (2, 33), 2)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
    tl, _, tg = ttr._accum_loss_grads(tp, tb, tcfg, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(tg, jg)


def test_count_params_matches_reference():
    assert tlm.count_params(tconfigs.get("rwkv6-3b")) == 3_073_313_280
    for smoke in (True, False):
        assert tlm.count_params(tconfigs.get("rwkv6-3b", smoke=smoke)) == \
            jlm.count_params(jconfigs.get("rwkv6-3b", smoke=smoke))
