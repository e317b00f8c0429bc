"""The port's sequence-parallel ring attention against the reference, on
the CPU: the carry-state flash step, the sharding recipe functions, the
ring on 4 gloo ranks and the LM forward under an ``sp_ring`` recipe.

Inputs come from seeded numpy generators and go through both packages.
The reference's carry kernel runs in Pallas interpret mode; its sharded
ring cannot run on this jax (``shard_map(check_rep=...)``), so the port's
4-rank ring is held against the reference's single-device oracles
(``attention_ref`` and the dense ``lm.forward``), as the reference's own
ring tests hold its ring against them.  Tolerances, all float32:

* carry step: ``2e-4`` against the interpret-mode kernel and the jnp
  oracle, as ``tests/test_kernels.py`` holds them (sums in another order);
* gradient of the carry step: ``5e-5``, as the reference's custom-VJP test;
* ring against ``attention_ref``: ``1e-5`` (the online softmax over 2-4
  blocks against one dense softmax);
* ``sp_ring`` forward against the dense reference forward: ``1e-4``, as
  ``tests/test_torch_lm.py``;
* double-buffered against blocking, and the ranks' logits among
  themselves: bitwise.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import RING_MESHES, TESTS, run_gloo
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import sharding as tsharding

ARCHS = ["phi4-mini-3.8b", "qwen2.5-32b"]
CARRY_TOL = 2e-4


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _qkv(rng, B, Hq, G, Sq, Skv, D):
    f = np.float32
    return (rng.standard_normal((B, Hq, Sq, D)).astype(f),
            rng.standard_normal((B, G, Skv, D)).astype(f),
            rng.standard_normal((B, G, Skv, D)).astype(f))


def _check_chain(q, k, v, Sl, *, q_offset, valid_len, causal, bq):
    """Carry steps over the KV blocks of length Sl: the port's plain route
    against the reference's interpret-mode kernel and jnp oracle, every
    step's (acc, m, l)."""
    carry = jcarry = jref_carry = None
    for t in range(-(-k.shape[2] // Sl)):
        blk = slice(t * Sl, (t + 1) * Sl)
        kw = dict(q_offset=q_offset, k_offset=t * Sl, valid_len=valid_len, causal=causal)
        carry = ops.flash_attention_carry(torch.from_numpy(q), torch.from_numpy(k[:, :, blk]),
                                          torch.from_numpy(v[:, :, blk]), carry, **kw)
        jk, jv = jnp.asarray(k[:, :, blk]), jnp.asarray(v[:, :, blk])
        jcarry = jops.flash_attention_carry(jnp.asarray(q), jk, jv, jcarry, impl="interpret",
                                            bq=bq, bk=bq, **kw)
        jref_carry = jref.flash_carry_ref(jnp.asarray(q), jk, jv, jref_carry, **kw)
        for got, a, b, name in zip(carry, jcarry, jref_carry, ("acc", "m", "l")):
            assert got.shape == a.shape, name
            for want in (a, b):
                np.testing.assert_allclose(_np(got), np.asarray(want), rtol=CARRY_TOL,
                                           atol=CARRY_TOL, err_msg=f"step {t} {name}")
    return carry


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
def test_flash_carry_matches_reference_per_step(hq, hkv, causal):
    """GQA group mapping, resident rank 2 of a 4-rank ring."""
    q, k, v = _qkv(np.random.default_rng(0), 2, hq, hkv, 16, 64, 16)
    _check_chain(q, k, v, 16, q_offset=2 * 16, valid_len=None, causal=causal, bq=16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_carry_ragged_valid_len(causal):
    """Global keys >= valid_len are padding: rank 2's block is half padding,
    rank 3's all padding; the normalized chain equals dense attention over
    the valid keys."""
    q, k, v = _qkv(np.random.default_rng(1), 1, 2, 2, 16, 64, 16)
    valid = 34
    acc, m, l = _check_chain(q, k, v, 16, q_offset=0, valid_len=valid, causal=causal, bq=16)
    if not causal:
        out = acc / torch.where(l == 0, 1.0, l)[..., None]
        dense = jref.attention_ref(jnp.asarray(q), jnp.asarray(k[:, :, :valid]),
                                   jnp.asarray(v[:, :, :valid]), causal=False)
        np.testing.assert_allclose(_np(out), np.asarray(dense), rtol=CARRY_TOL, atol=CARRY_TOL)


def test_flash_carry_ragged_q_chunk():
    """A resident Q chunk (30 rows) that does not divide the reference's
    block: the padded rows never show, the state keeps q's 30 rows."""
    q, k, v = _qkv(np.random.default_rng(2), 1, 2, 2, 30, 30, 16)
    _check_chain(q, k, v, 30, q_offset=0, valid_len=None, causal=True, bq=32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_carry_gradient_matches_reference(causal):
    """The plain route's gradient (autograd through ``flash_carry_ref``)
    against ``jax.vjp`` of the reference's ``flash_carry_ref``, through one
    step and through two chained steps, of the loss sum(normalized out^2)."""
    B, Hq, G, S, D = 1, 4, 2, 64, 16
    q, k, v = _qkv(np.random.default_rng(3), B, Hq, G, S, S, D)

    def norm(acc, l, xp):
        return acc / xp.where(l == 0, 1.0, l)[..., None]

    for steps in (1, 2):
        Sl = S // steps

        def jloss(q, k, v):
            c = None
            for t in range(steps):
                c = jref.flash_carry_ref(q, k[:, :, t * Sl:(t + 1) * Sl],
                                         v[:, :, t * Sl:(t + 1) * Sl], c, q_offset=0,
                                         k_offset=t * Sl, causal=causal)
            return jnp.sum(jnp.square(norm(c[0], c[2], jnp)))

        want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        c = None
        for t in range(steps):
            c = ops.flash_attention_carry(tq, tk[:, :, t * Sl:(t + 1) * Sl],
                                          tv[:, :, t * Sl:(t + 1) * Sl], c, q_offset=0,
                                          k_offset=t * Sl, causal=causal)
        torch.square(norm(c[0], c[2], torch)).sum().backward()
        for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
            d = np.abs(_np(got) - np.asarray(w)).max()
            assert d < 5e-5, (steps, name, d)


def test_flash_carry_refuses_what_does_not_fit():
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(4), 1, 4, 2, 8, 8, 16))
    bad = (torch.zeros(1, 4, 7, 16), torch.zeros(1, 4, 7), torch.zeros(1, 4, 7))
    with pytest.raises(ValueError, match="carry"):
        ops.flash_attention_carry(q, k, v, bad)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention_carry(q, k, v, impl="pallas")


# ----------------------------------------------------------------- sharding

def test_ragged_seq_extents_match_reference():
    for S in range(1, 40):
        for R in range(1, 9):
            assert tsharding.ragged_seq_extents(S, R) == jsharding.ragged_seq_extents(S, R)
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            tsharding.ragged_seq_extents(*bad)


_RECIPES = """
import pickle, sys
from repro import configs
from repro.core.compat import make_mesh
from repro.models.sharding import make_recipe
out = {{}}
for shape in {meshes!r}:
    mesh = make_mesh(shape, ("data", "model"))
    for arch in {archs!r}:
        cfg = configs.get(arch, smoke=True)
        for mode in {modes!r}:
            r = make_recipe(cfg, mesh, attn_mode=mode)
            out[(shape, arch, mode)] = dict(
                bindings=dict(r.bindings), attn_mode=r.attn_mode, sp_ring=r.sp_ring,
                batch_axes=tuple(r.batch_axes),
                act_specs={{k: tuple(v) for k, v in r.act_specs.items()}})
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""
MODES = ["auto", "sp", "tp", "sp_ring"]


class _Shape:
    """What ``make_recipe`` reads of a mesh: its shape and axis names."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


@pytest.fixture(scope="module")
def reference_recipes(distributed, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_recipes") / "recipes.pkl")
    code = _RECIPES.format(meshes=RING_MESHES, archs=ARCHS, modes=MODES, path=path)
    assert "OK" in distributed(code, devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", RING_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_make_recipe_matches_reference(reference_recipes, shape, arch):
    """``bindings``, ``attn_mode``, ``sp_ring``, batch axes and every
    activation spec, for every attention mode."""
    for mode in MODES:
        want = reference_recipes[(shape, arch, mode)]
        r = tsharding.make_recipe(tconfigs.get(arch, smoke=True), _Shape(shape), attn_mode=mode)
        assert r.bindings == want["bindings"], mode
        assert (r.attn_mode, r.sp_ring, r.batch_axes) == \
            (want["attn_mode"], want["sp_ring"], want["batch_axes"]), mode
        assert {k: tuple(v) for k, v in r.act_specs.items()} == want["act_specs"], mode


def test_use_recipe_nests():
    r1 = tsharding.make_recipe(tconfigs.get("phi4-mini-3.8b", smoke=True), _Shape((1, 4)))
    r2 = dataclasses.replace(r1, sp_ring=True)
    assert tsharding.current_recipe() is None
    with tsharding.use_recipe(r1):
        with tsharding.use_recipe(r2):
            assert tsharding.current_recipe() is r2
        with tsharding.use_recipe(None):
            assert tsharding.current_recipe() is r1
    assert tsharding.current_recipe() is None


# --------------------------------------------------------------------- ring

RING_CASES = [(32, True), (32, False), (30, True), (30, False)]  # (S, causal)


@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.default_rng(5)
    return {key: _qkv(rng, 2, 4, 2, key[0], key[0], 16) for key in RING_CASES}


@pytest.fixture(scope="module")
def ring_runs(ring_inputs, tmp_path_factory):
    return run_gloo("ring_family", 4, tmp_path_factory.mktemp("gloo_ring"), cases=ring_inputs)


@pytest.mark.parametrize("key", RING_CASES, ids=lambda c: f"S{c[0]}-{'causal' if c[1] else 'full'}")
@pytest.mark.parametrize("shape", RING_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_ring_attention_matches_dense_reference(ring_inputs, ring_runs, shape, key):
    """Every data row of the mesh runs a ring over its ``model`` ranks; the
    model ranks' chunks put together in rank order are the whole output."""
    q, k, v = (jnp.asarray(a) for a in ring_inputs[key])
    want = np.asarray(jref.attention_ref(q, k, v, causal=key[1]))
    data, R = shape
    for d in range(data):
        ranks = [d * R + r for r in range(R)]
        got = np.concatenate([ring_runs[i][(shape, key, True)] for i in ranks], axis=2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", RING_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_ring_double_buffered_equals_blocking(ring_runs, shape):
    for rank in ring_runs:
        for key in RING_CASES:
            np.testing.assert_array_equal(rank[(shape, key, True)], rank[(shape, key, False)])


def test_ring_refuses_mismatched_lengths(ring_runs):
    assert all(rank[(shape, "mismatch_raises")] for rank in ring_runs for shape in RING_MESHES)


# -------------------------------------------------------------------- model

SEQS = [32, 30]  # dividing and ragged over 2 and 4 ranks


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.float32,
                                   attn_impl="interpret")
        jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
        if jcfg.qkv_bias:
            rng = np.random.default_rng(1)
            for name in ("bq", "bk", "bv"):
                shape = jp["blocks"]["attn"][name].shape
                jp["blocks"]["attn"][name] = jnp.asarray(
                    0.5 * rng.standard_normal(shape).astype(np.float32))
        out[arch] = (jcfg, jp)
    return out


@pytest.fixture(scope="module")
def tokens(models):
    vocab = min(cfg.vocab for cfg, _ in models.values())
    rng = np.random.default_rng(6)
    return {S: rng.integers(0, vocab, size=(2, S)).astype(np.int32) for S in SEQS}


@pytest.fixture(scope="module")
def sp_ring_runs(models, tokens, tmp_path_factory):
    trees = {arch: jax.tree.map(np.asarray, jp) for arch, (_, jp) in models.items()}
    return run_gloo("sp_ring_forward_family", 4, tmp_path_factory.mktemp("gloo_sp_ring"),
                    models=trees, tokens=tokens)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("shape", RING_MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_ring_forward_matches_dense_reference(models, tokens, sp_ring_runs, arch, shape, S):
    """Batch 2 over ``data``, the sequence over ``model``: every rank returns
    the whole logits, the same bits, equal to the reference's dense forward."""
    jcfg, jp = models[arch]
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(tokens[S])}, jcfg)
    first = sp_ring_runs[0][(arch, shape, S)]
    assert first.shape == want.shape
    np.testing.assert_allclose(first, np.asarray(want), rtol=1e-4, atol=1e-4)
    for rank in sp_ring_runs[1:]:
        np.testing.assert_array_equal(rank[(arch, shape, S)], first)
