"""The port's optimizer, gradient buckets and ZeRO tables against the
reference's, on identical numpy inputs (CPU).

* ``lr_at_step`` and the int8 quantization (``compress_leaf``: the
  dequantized gradient and its residual) equal the reference's eager
  float32 operations bitwise;
* ``apply_updates`` from a mid-training state (the reference's moments
  after two steps, carried over with ``opt_state_from_jax``), with the clip
  active and not, with and without int8 compression: parameters, moments
  and residuals to ``rtol=1e-6, atol=1e-9`` against the reference's update
  run op by op (its jitted form fuses the residual's ``x - q * scale`` into
  one rounding), the gradient norm to ``rtol=1e-6`` (its sum of squares in
  another order);
* ``adamw_leaf_update`` on the flattened leaves equals ``apply_updates``
  bitwise;
* the bucket tables (indices, counts, displacements, capacity, extents),
  ``zero_comm_model`` and ``ragged_grad_extents`` are the reference's, for 2
  configs x 3 thresholds x R in 1..4; ``pack_bucket``/``unpack_bucket``
  round-trip bitwise and pack the reference's buffer.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import sharding as jsharding
from repro.train import buckets as jbuckets
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models import sharding as tsharding
from repro_torch.models.module import tree_leaves, tree_unflatten
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.train import buckets as tbuckets
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttr

OCFG = dict(lr=1e-3, warmup_steps=3, total_steps=20)


def test_lr_at_step_matches_reference_bitwise():
    for kw in (OCFG, dict(lr=3e-4, warmup_steps=1, total_steps=7, min_lr_ratio=0.05), {}):
        j, t = jopt.OptConfig(**kw), topt.OptConfig(**kw)
        for step in list(range(0, 25)) + [99, 100, 101, 5000, 10_000, 20_000]:
            want = np.float32(jopt.lr_at_step(jnp.int32(step), j))
            got = topt.lr_at_step(torch.tensor(step, dtype=torch.int32), t)
            assert got.dtype == torch.float32
            assert got.item() == want, (kw, step)


def test_compress_leaf_matches_reference_bitwise():
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 1e4):
        g = (rng.standard_normal((37, 5)) * scale).astype(np.float32)
        e = (rng.standard_normal((37, 5)) * scale * 1e-2).astype(np.float32)
        want = jopt.compress_leaf(jnp.asarray(g), jnp.asarray(e))
        got = topt.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        q, s = topt._quantize_int8(torch.from_numpy(g))
        assert q.dtype == torch.int8 and int(q.abs().max()) == 127


def _mid_state(compress):
    """The reference's parameters, state after two updates, and a third
    gradient; all float32."""
    cfg = jconfigs.get("phi4-mini-3.8b", smoke=True)
    ocfg = jopt.OptConfig(compress=compress, **OCFG)
    params = jlm.init_model(cfg, jax.random.PRNGKey(0))
    state = jopt.init_opt_state(params, ocfg)
    rng = np.random.default_rng(7)
    grad = lambda s: jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * s), params)
    for _ in range(2):
        params, state, _ = jopt.apply_updates(params, grad(0.01), state, ocfg)
    return params, state, ocfg


def _np_state(state):
    return {"step": np.asarray(state.step), "mu": jax.tree.map(np.asarray, state.mu),
            "nu": jax.tree.map(np.asarray, state.nu), "err": jax.tree.map(np.asarray, state.err)}


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("gscale", [1e-4, 0.05])  # clip off, clip on (norm > 1)
def test_apply_updates_matches_reference_from_mid_training(compress, gscale):
    jp, js, jocfg = _mid_state(compress)
    g = jax.tree.map(lambda p: jnp.asarray(np.random.default_rng(9).standard_normal(
        p.shape).astype(np.float32) * gscale), jp)
    want_p, want_s, want_m = jopt.apply_updates(jp, g, js, jocfg)  # op by op
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tg = params_from_jax(jax.tree.map(np.asarray, g), device="cpu")
    ts = opt_state_from_jax(_np_state(js), device="cpu")
    assert int(ts.step) == 2 and float(tree_leaves(ts.nu)[0].abs().max()) > 0
    tocfg = topt.OptConfig(compress=compress, **OCFG)
    got_p, got_s, got_m = topt.apply_updates(tp, tg, ts, tocfg)
    assert (float(want_m["grad_norm"]) > 1.0) == (gscale > 0.01)
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]), rtol=1e-6)
    assert got_m["lr"].item() == np.float32(want_m["lr"])
    for name, a, b in (("params", got_p, want_p), ("mu", got_s.mu, want_s.mu),
                       ("nu", got_s.nu, want_s.nu), ("err", got_s.err, want_s.err)):
        for x, y in zip(tree_leaves(a) if a != () else [], jax.tree.leaves(b)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    # the per-leaf update is the tree update, bitwise
    if compress == "none":
        lr, b1c, b2c = topt._step_scalars(ts.step + 1, tocfg)
        scale = topt._clip_scale(got_m["grad_norm"], tocfg)
        for p, g1, m, n, want in zip(tree_leaves(tp), tree_leaves(tg), tree_leaves(ts.mu),
                                     tree_leaves(ts.nu), tree_leaves(got_p)):
            new_p, _, _ = topt.adamw_leaf_update(p, g1, m, n, scale=scale, lr=lr, b1c=b1c,
                                                 b2c=b2c, ocfg=tocfg)
            assert torch.equal(new_p, want)


def _configs():
    phi = jconfigs.get("phi4-mini-3.8b", smoke=True)
    moe = jconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    return [("phi4-mini-3.8b", {}), ("phi3.5-moe-42b-a6.6b", dict(n_layers=3, d_model=65))], \
        (phi, moe)


@pytest.mark.parametrize("arch,over", _configs()[0])
@pytest.mark.parametrize("bucket_bytes", [1000, 40 << 10, 4 << 20])
def test_bucket_tables_match_reference(arch, over, bucket_bytes):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **over)
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), **over)
    for R in (1, 2, 3, 4):
        want = jbuckets.assign_buckets(jlm.abstract_model(jcfg), bucket_bytes=bucket_bytes,
                                       ranks=R)
        got = tbuckets.assign_buckets(tlm.build_specs(tcfg), bucket_bytes=bucket_bytes, ranks=R)
        assert [(b.indices, b.shapes, b.counts, b.displs, b.size, b.cap, b.extents, b.padded,
                 b.nbytes) for b in got] == \
            [(b.indices, b.shapes, b.counts, b.displs, b.size, b.cap, b.extents, b.padded,
              b.nbytes) for b in want]
        assert got == ttr.zero_train_buckets(tcfg, bucket_bytes=bucket_bytes, ranks=R)
        assert tbuckets.zero_comm_model(got) == jbuckets.zero_comm_model(want)


def test_ragged_grad_extents_match_reference():
    for n in range(1, 70):
        for R in range(1, 9):
            assert tsharding.ragged_grad_extents(n, R) == jsharding.ragged_grad_extents(n, R)


def test_pack_unpack_round_trip_bitwise():
    jcfg = dataclasses.replace(jconfigs.get("phi4-mini-3.8b", smoke=True), d_model=65)
    tcfg = dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), d_model=65)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves, jleaves = tree_leaves(tp), jax.tree.leaves(jp)
    for R in (1, 3, 4):
        buckets = tbuckets.assign_buckets(tp, bucket_bytes=5000, ranks=R)
        jb = jbuckets.assign_buckets(jp, bucket_bytes=5000, ranks=R)
        out = [None] * len(leaves)
        for b, w in zip(buckets, jb):
            flat = tbuckets.pack_bucket(leaves, b)
            assert flat.shape == (b.padded,) and not flat[b.size:].any()
            np.testing.assert_array_equal(flat.numpy(), np.asarray(jbuckets.pack_bucket(jleaves, w)))
            for i, leaf in zip(b.indices, tbuckets.unpack_bucket(flat, b)):
                out[i] = leaf
            assert [t.data_ptr() for t in tbuckets.bucket_leaves(leaves, b)] == \
                [leaves[i].data_ptr() for i in b.indices]
        for a, b in zip(tree_leaves(tree_unflatten(tp, out)), leaves):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tbuckets.assign_buckets(tp, bucket_bytes=0, ranks=2)
    with pytest.raises(ValueError):
        tbuckets.zero_comm_model(())


def test_zero_opt_state_from_reference_is_this_ranks_shard():
    cfg = dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), d_model=65)
    buckets = ttr.zero_train_buckets(cfg, bucket_bytes=5000, ranks=3)
    rng = np.random.default_rng(0)
    flats = tuple(rng.standard_normal(b.padded).astype(np.float32) for b in buckets)
    state = {"step": np.int32(4), "mu": flats, "nu": flats, "err": ()}
    for rank in range(3):
        got = opt_state_from_jax(state, device="cpu", buckets=buckets, rank=rank)
        assert int(got.step) == 4 and got.err == ()
        for t, f, b in zip(got.mu, flats, buckets):
            np.testing.assert_array_equal(t.numpy(), f[rank * b.cap:(rank + 1) * b.cap])
    fresh = topt.init_zero_opt_state(tlm.init_model(cfg, torch.Generator().manual_seed(0),
                                                    device="cpu"),
                                     buckets, topt.OptConfig(compress="int8"))
    assert [t.shape for t in fresh.mu] == [(b.cap,) for b in buckets] == \
        [t.shape for t in fresh.err]
