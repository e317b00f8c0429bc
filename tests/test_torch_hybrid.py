"""The port's hybrid family (zamba2-7b: Mamba2 blocks and one shared
attention block under per-application LoRAs) against the reference's, on
the CPU, and the attention plain versions at zamba2's head dim of 112.

Inputs are made from a numpy seed and the reference's seeded weights are
carried over with ``params_from_jax``, every constant-initialised leaf
perturbed (``tests/_torch_families.py``: the LoRA's zero ``lora_b`` among
them, so each application's adapter shows).  Float32 activations, the
SMOKE config's ``ssm_chunk=16`` and shared window of 64.  The reference's
attention runs its Pallas kernels in interpret mode, the port's its
kernels' plain versions (CPU tensors).  Tolerances: blocks, logits and
states ``rtol=atol=1e-4`` (float32 sums in other orders; the reference's
own decode-vs-forward tolerance for these families is 5e-3); the loss
``rtol=1e-5`` and every gradient leaf as ``assert_grads_close`` states;
the plain attention versions as ``tests/test_torch_attention.py``'s,
float32 ``2e-4``, bfloat16 ``1e-2``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import lm as jlm
from repro.models.module import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblk
from repro_torch.models import lm as tlm
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import use_recipe
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.train import trainer as ttr

from _torch_families import (BATCH_AXIS_FROM_END, assert_grads_close, leaves, models,
                             named_leaves, np_, perturb, serve_both, tokens)

TOL = 1e-4
ATTN_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, msg=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=TOL, atol=TOL, err_msg=msg)


def _states(jcfg, tcfg, B, T):
    return (jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32)),
            tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                            torch.zeros((B,), dtype=torch.int32)))


# ------------------------------------------------------------- structure ----

def test_param_tree_matches_reference():
    """The hybrid tree, leaf for leaf: Mamba2 blocks stacked (n_shared,
    group_m, ...), one LoRA per application, one shared block, the tail."""
    for name in ("zamba2-7b", "rwkv6-3b"):
        for smoke in (True, False):
            want = jax.tree.map(lambda s: tuple(s.shape),
                                jlm.build_specs(jconfigs.get(name, smoke=smoke)),
                                is_leaf=lambda s: hasattr(s, "layout"))
            got = tlm.build_specs(tconfigs.get(name, smoke=smoke))
            assert jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple)) == \
                [tuple(s.shape) for s in tree_leaves(got)]
    assert tlm.hybrid_dims(tconfigs.get("zamba2-7b")) == (13, 5, 3)
    assert tlm.hybrid_dims(tconfigs.get("zamba2-7b", smoke=True)) == (2, 5, 1)


def test_count_params_matches_reference():
    assert tlm.count_params(tconfigs.get("zamba2-7b")) == 5_737_665_344
    for smoke in (True, False):
        assert tlm.count_params(tconfigs.get("zamba2-7b", smoke=smoke)) == \
            jlm.count_params(jconfigs.get("zamba2-7b", smoke=smoke))


# ---------------------------------------------------------- shared block ----

@pytest.mark.parametrize("with_cache", [False, True])
def test_shared_attn_block_matches_reference(with_cache):
    """The LoRA on the block's input, GQA attention and SwiGLU: a 32-token
    forward, or a 3-token chunk against a cache with 5 and 9 keys."""
    jcfg, _, tcfg, _ = models("zamba2-7b")
    seed = 30
    jsh = perturb(jinit(jblk.shared_attn_block_specs(jcfg), jax.random.PRNGKey(seed)), seed)
    jlo = perturb(jinit(jblk.shared_lora_specs(jcfg, jcfg.shared_lora_rank),
                        jax.random.PRNGKey(seed + 1)), seed + 1)
    tsh, tlo = (params_from_jax(jax.tree.map(np.asarray, t), device="cpu") for t in (jsh, jlo))
    rng = np.random.default_rng(seed)
    S = 3 if with_cache else 32
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jkw, tkw = {}, {}
    if with_cache:
        T, G, D = 16, jcfg.n_kv, jcfg.head_dim
        k = rng.standard_normal((2, G, T, D)).astype(np.float32)
        v = rng.standard_normal((2, G, T, D)).astype(np.float32)
        lens = np.array([5, 9], np.int32)
        pos = lens[:, None] + np.arange(S, dtype=np.int32)[None]
        jkw = dict(cache=jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)),
                   positions=jnp.asarray(pos))
        tkw = dict(cache=tattn.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                                       torch.from_numpy(lens)), positions=torch.from_numpy(pos))
    want, wcache, _ = jblk.shared_attn_block(jsh, jlo, jnp.asarray(x), jcfg,
                                             window=jcfg.shared_window, **jkw)
    got, gcache, aux = tblk.shared_attn_block(tsh, tlo, torch.from_numpy(x), tcfg,
                                              window=tcfg.shared_window, **tkw)
    assert aux == 0.0
    _close(got, want)
    if with_cache:
        for name, g, w in zip(("k", "v", "length"), gcache, wcache):
            _close(g, w, name)


# ------------------------------------------------------------ the model ----

def test_forward_matches_reference():
    jcfg, jp, tcfg, tp = models("zamba2-7b")
    toks = tokens(jcfg, (2, 32))
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    assert got.shape == (2, 32, tcfg.vocab_padded) and float(aux) == 0.0
    _close(got, want)


def test_decode_loop_matches_reference_and_forward():
    """16 decode steps of one token: every step's logits and every cache
    leaf (the Mamba2 states, the shared K/V and lengths) against the
    reference's ``decode_step``, and the logits against the port's own
    forward over the same 16 tokens."""
    jcfg, jp, tcfg, tp = models("zamba2-7b")
    B, T = 2, 16
    toks = tokens(jcfg, (B, T), 1)
    jstate, tstate = _states(jcfg, tcfg, B, T)
    step = jax.jit(lambda p, s, b: jlm.decode_step(p, s, b, jcfg))
    got = []
    for t in range(T):
        jl, jstate = step(jp, jstate, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()},
                                     tcfg)
        _close(tl, jl, f"step {t}")
        got.append(tl)
    for g, w in zip(leaves(tstate.caches), leaves(jstate.caches), strict=True):
        _close(g, w)
    full, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    _close(torch.cat(got, dim=1), full)


def test_decode_wraps_the_shared_window():
    """A cache of 96 positions against the smoke window of 64: the shared
    block's ring buffer holds 64, and 80 steps wrap it (row 1 idle for 10
    of them, so the rows wrap at different steps).  Every active row's
    logits and every cache leaf against the reference's ``decode_step``; an
    idle row keeps its state bitwise."""
    jcfg, jp, tcfg, tp = models("zamba2-7b")
    B, T, steps = 2, 96, 80
    jstate, tstate = _states(jcfg, tcfg, B, T)
    assert tstate.caches["shared"].k.shape[-2] == jcfg.shared_window == 64
    toks = tokens(jcfg, (B, steps), 2)
    step = jax.jit(lambda p, s, b, c: jlm.decode_step(p, s, b, jcfg, new_counts=c))
    for t in range(steps):
        counts = np.array([1, 0 if 20 <= t < 30 else 1], np.int32)
        before = [x.clone() for x in leaves(tstate.caches)]
        b = toks[:, t:t + 1]
        jl, jstate = step(jp, jstate, {"tokens": jnp.asarray(b)}, jnp.asarray(counts))
        tl, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(b).long()}, tcfg,
                                     new_counts=torch.from_numpy(counts))
        live = np.flatnonzero(counts)
        _close(tl[live], np.asarray(jl)[live], f"step {t}")
        if counts[1] == 0:
            for old, (name, new) in zip(before, named_leaves(tstate.caches)):
                axis = new.ndim - BATCH_AXIS_FROM_END[name]
                assert torch.equal(old.select(axis, 1), new.select(axis, 1)), name
    for g, w in zip(leaves(tstate.caches), leaves(jstate.caches), strict=True):
        _close(g, w)
    np.testing.assert_array_equal(tstate.caches["shared"].length.numpy(),
                                  np.asarray(jstate.caches["shared"].length))
    assert int(tstate.caches["shared"].length.min()) > 64  # both rows wrapped


def test_engine_matches_reference_with_a_reused_slot():
    """Greedy tokens equal the reference engine's: 5 requests on 2 slots of
    96 positions (each slot released and reused; a released slot's Mamba2
    states are zeroed before its next request: without that the successor
    would start from its predecessor's state), prompts of up to 70 tokens,
    so a request wraps the shared window of 64."""
    want, got, teng = serve_both("zamba2-7b", max_len=96, prompt_lens=(40, 71), seed=3)
    assert sorted(got) == list(range(5))
    assert got == want
    assert teng.ledger.lengths == [0, 0]
    assert teng.steps["prefill"] > 40  # token by token


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_reset_slot_rows_zeroes_the_recurrent_state(arch):
    """Slot 1's rows of every recurrent, shift and conv leaf and of the
    lengths are zeroed, in place, on their batch axis under every stacking;
    K/V payloads and the other slots' rows stay."""
    cfg = tconfigs.get(arch, smoke=True)
    caches = tlm.init_cache(cfg, 3, 80, device="cpu")
    for x in leaves(caches):
        x.fill_(1)
    tengine._reset_slot_rows(caches, 1)
    for name, x in named_leaves(caches):
        rows = [x.select(x.ndim - BATCH_AXIS_FROM_END[name], b) for b in range(3)]
        if name in ("k", "v"):  # length-masked: left as they were
            assert all(bool((r == 1).all()) for r in rows), name
        else:
            assert bool((rows[1] == 0).all()), name
            assert bool((rows[0] == 1).all()) and bool((rows[2] == 1).all()), name


def test_loss_and_grads_match_reference():
    """``lm.loss_fn`` and its gradients through the hybrid stack (remat by
    super-block and by block) against ``jax.value_and_grad`` of the
    reference's, whose attention is its differentiable
    ``blockwise_attention_ref``."""
    jcfg, jp, tcfg, tp = models("zamba2-7b", attn_impl=None)
    toks = tokens(jcfg, (2, 33), 2)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb, jcfg)
    tl, _, tg = ttr._accum_loss_grads(tp, tb, tcfg, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(tg, jg)
    # every application's LoRA gets a gradient of its own
    assert all(float(g.abs().sum()) > 0 for g in tg["shared_lora"]["lora_b"])


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_sharding_recipe_is_refused(arch):
    """Both families run under a recipe (``tests/test_torch_recipe_recurrent*.py``);
    what stays refused is the whole tree where a ``tp`` recipe over 2
    ``model`` ranks wants this rank's shards, with the hint."""
    from repro_torch.models.sharding import RankBatch, make_recipe

    class _Mesh:  # what make_recipe reads of a mesh
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

    cfg = tconfigs.get(arch, smoke=True)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with use_recipe(make_recipe(cfg, _Mesh(), attn_mode="tp")):
        with pytest.raises(ValueError, match="shard_params_by_recipe"):
            tlm.forward(params, RankBatch({"tokens": torch.zeros((1, 16), dtype=torch.long)},
                                          {"tokens": (1, 16)}), cfg)


# ------------------------------------------- attention at head dim 112 ----

def _normal(rng, shape, dtype):
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(JNP[dtype])
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH[dtype])


def _attn_close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference_at_head_dim_112(dtype):
    """zamba2's (112, 112): MHA, causal, ragged S = 40 in blocks of 16,
    against the reference's kernel (interpret mode) and, at float32, its
    dense ``attention_ref``."""
    rng = np.random.default_rng(40)
    (jq, tq), (jk, tk), (jv, tv) = (_normal(rng, (2, 4, 40, 112), dtype) for _ in range(3))
    want = flash_attention_pallas(jq, jk, jv, causal=True, bq=16, bk=16, interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=True, block=16)
    assert got.dtype == TORCH[dtype] and got.shape == (2, 4, 40, 112)
    _attn_close(got, want, dtype)
    if dtype == "float32":
        _attn_close(got, jref.attention_ref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mha_step", "wrapped_ring"])
def test_flash_decode_plain_matches_reference_at_head_dim_112(case, dtype):
    """Decode at head dim 112: an MHA step (one stacked row per slot and
    group, rep = 1) with an idle slot, and a ring-buffer cache of T = 40
    whose lengths pass T (every slot valid, ``q_positions >= T``), blocks of
    16 that T does not divide; against the reference's kernel in interpret
    mode."""
    rng = np.random.default_rng(41)
    B, H, T, D = 4, 4, 40, 112
    (jq, tq) = _normal(rng, (B, H, 1, D), dtype)
    (jk, tk), (jv, tv) = (_normal(rng, (B, H, T, D), dtype) for _ in range(2))
    lens = np.array([40, 17, 0, 33] if case == "mha_step" else [41, 77, 40, 120], np.int32)
    pos = None if case == "mha_step" else (lens - 1)[:, None]
    want = flash_decode_pallas(jq, jk, jv, jnp.asarray(lens),
                               q_positions=None if pos is None else jnp.asarray(pos), bk=16,
                               interpret=True)
    got = tops.flash_decode(tq, tk, tv, torch.from_numpy(lens),
                            q_positions=None if pos is None else torch.from_numpy(pos), block=16)
    _attn_close(got, want, dtype)


def test_card_wrappers_take_head_dim_112_and_the_carry_form_does_not():
    """The card wrappers' head dims (checked before any launch): the forward
    takes (112, 112), decode (112, 112), and the carry form 112 too (zamba2's
    shared attention under ``sp`` and ``sp_ring``); the carry form refuses
    a (D, Dv) pair it has no instance of, (112, 64), while its plain version
    takes any (``tests/test_torch_carry_dv.py``)."""
    assert (112, 112) in tfa.FORWARD_HEAD_DIMS
    assert tfd.DECODE_HEAD_DIMS == ((64, 64), (112, 112), (128, 128), (96, 64))
    assert tfa.CARRY_HEAD_DIMS == ((64, 64), (128, 128), (112, 112), (96, 64))
    q = torch.zeros((1, 2, 8, 112))
    with pytest.raises(ValueError, match="CUDA tensor"):  # the head dim passes, the device not
        tfd.flash_decode_cuda(q, q, q, torch.zeros((1,), dtype=torch.int32))
    carry = (torch.zeros((1, 2, 8, 112)), torch.zeros((1, 2, 8)), torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):  # the head dim passes, the device not
        tfa.flash_attention_carry_cuda(q, q, q, carry)
    with pytest.raises(ValueError, match="head dim"):
        tfa.check_carry_head_dims(112, 64)


def test_decode_plan_at_head_dim_112():
    """The planning formula sizes a 112 row as two 64-column boxes (the
    library's ``flash_decode_smem_bytes``, held equal on the card), so a
    112 block plans like a 128 one; an MHA step (1 row) takes the 16-row
    tile, and a 16-row tile fits two blocks an SM."""
    for tr in (1, 4):
        for bk in (64, 512, 4096):
            assert tfd.smem_bytes(112, tr, bk) == tfd.smem_bytes(128, tr, bk)
    assert tfd.smem_bytes(112, 1, 512) > tfd.smem_bytes(64, 1, 512)
    tr, splits, per = tfd.plan_launch(1, 4 * 32, 8, 112, 512, 132, tfd.smem_bytes)
    assert tr == 1 and splits * per >= 8
    assert 2 * tfd.smem_bytes(112, 1, 512) <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        tfd.plan_launch(1, 1, 1, 112, 512, 132, lambda D, tr, bk: -1)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_serve_cli_serves_both_families_on_the_cpu(arch):
    """``launch/serve.py --arch ... --smoke --device cpu``: 5 requests on 2
    slots, every request done (slots released and reused)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                           "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
                           "--max-new", "4"], capture_output=True, text=True, timeout=240,
                          env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] 5 done / 0 in flight, 20 tokens requested" in proc.stdout
    assert "kv occupancy 1.00" in proc.stdout  # no cache grows with length
