"""The carry form of the flash attention with a v head dim of its own
(Dv != D), the plain version on the CPU: MLA under the sequence-parallel
recipes runs its queries (q/k of ``d_nope + d_rope``) through it with v of
``d_v``, the state ``acc`` as wide as v.

* ``flash_carry_ref`` step by step against the reference's
  ``flash_attention_carry_pallas`` in interpret mode, at (D, Dv) = (24, 16)
  (minicpm3's SMOKE dims) and (96, 64) (its published ones), causal and
  not, GQA 2, a resident chunk of rank 2 of a 4-rank ring, with ragged
  ``valid_len``: ``CARRY_TOL = 2e-4`` (``tests/test_torch_ring.py``'s).
* The normalized chain over 4 KV chunks against the reference's
  single-shot ``flash_attention_pallas``: ``CARRY_TOL``.
* ``ops._CarryStep`` (the card's autograd route, its forward the kernel)
  with its forward bound to the plain version: its backward, the plain
  recompute, against autograd through the plain version, within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_carry_pallas, flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

CARRY_TOL = 2e-4
DIMS = [(24, 16), (96, 64)]


def _qkv(rng, B, Hq, G, Sq, Skv, D, Dv):
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, G, Skv, D)).astype(np.float32),
            rng.standard_normal((B, G, Skv, Dv)).astype(np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("valid_len", [None, 50])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_carry_steps_match_reference_kernel(dims, valid_len, causal):
    """Rank 2's 16 queries against the 4 KV chunks of 16 keys, in ring
    order from its own block; keys at or past ``valid_len`` masked (chunk 3
    half padding)."""
    D, Dv = dims
    q, k, v = _qkv(np.random.default_rng(D), 2, 4, 2, 16, 64, D, Dv)
    carry = jcarry = None
    for step in range(4):
        blk = ((2 - step) % 4) * 16
        kw = dict(q_offset=32, k_offset=blk, valid_len=valid_len, causal=causal)
        carry = ops.flash_attention_carry(torch.from_numpy(q),
                                          torch.from_numpy(k[:, :, blk:blk + 16]),
                                          torch.from_numpy(v[:, :, blk:blk + 16]), carry, **kw)
        jcarry = flash_attention_carry_pallas(jnp.asarray(q), jnp.asarray(k[:, :, blk:blk + 16]),
                                              jnp.asarray(v[:, :, blk:blk + 16]), jcarry, bq=16,
                                              bk=16, interpret=True, **kw)
        assert carry[0].shape == (2, 4, 16, Dv)
        for got, want, name in zip(carry, jcarry, ("acc", "m", "l")):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=CARRY_TOL,
                                       atol=CARRY_TOL, err_msg=f"step {step} {name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_carry_chain_matches_reference_single_shot(dims, causal):
    """The whole sequence's queries through 4 chained steps over its KV
    chunks, normalized as the ring's epilogue does, against the reference's
    single-shot kernel: (B, Hq, S, Dv)."""
    D, Dv = dims
    q, k, v = _qkv(np.random.default_rng(D + 1), 1, 4, 2, 64, 64, D, Dv)
    carry = None
    for t in range(4):
        carry = ops.flash_attention_carry(torch.from_numpy(q),
                                          torch.from_numpy(k[:, :, 16 * t:16 * t + 16]),
                                          torch.from_numpy(v[:, :, 16 * t:16 * t + 16]), carry,
                                          k_offset=16 * t, causal=causal)
    acc, _, l = carry
    got = acc / torch.where(l == 0, 1.0, l)[..., None]
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  bq=16, bk=16, interpret=True)
    assert got.shape == want.shape == (1, 4, 64, Dv)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=CARRY_TOL, atol=CARRY_TOL)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_carry_step_gradient_matches_plain_autograd(dims, monkeypatch):
    """Two chained steps at the sp recipe's offsets (a chunk at
    ``q_offset = 16``, a ragged ``valid_len``) through ``ops._CarryStep``,
    the card kernel replaced by the plain version, against autograd through
    the plain version: the gradients of q, k, v and of the incoming state."""
    D, Dv = dims

    def plain(q, k, v, carry, **kw):  # what the card kernel computes, in place
        with torch.no_grad():
            new = tref.flash_carry_ref(q, k, v, carry, **kw)
        for t, n in zip(carry, new):
            t.copy_(n)
        return carry

    monkeypatch.setattr(ops, "flash_attention_carry_cuda", plain)
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(D + 2), 1, 4, 2, 16, 32,
                                                    D, Dv))
    rng = np.random.default_rng(D + 3)
    w = torch.from_numpy(rng.standard_normal((1, 4, 16, Dv)).astype(np.float32))
    kw = dict(q_offset=16, causal=True, valid_len=30, scale=D ** -0.5)

    def loss(step):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        c = step(qq, kk[:, :, :16], vv[:, :, :16], None, k_offset=0)
        c = step(qq, kk[:, :, 16:], vv[:, :, 16:], c, k_offset=16)
        out = c[0] / torch.where(c[2] == 0, 1.0, c[2])[..., None]
        (out * w).sum().backward()
        return out.detach(), [t.grad for t in (qq, kk, vv)]

    def card(q, k, v, carry, *, k_offset):
        if carry is None:
            carry = (torch.zeros((1, 4, 16, Dv)), torch.full((1, 4, 16), tref.NEG_INF),
                     torch.zeros((1, 4, 16)))
        return ops._CarryStep.apply(q, k, v, *carry, dict(kw, k_offset=k_offset))

    def ref(q, k, v, carry, *, k_offset):
        return tref.flash_carry_ref(q, k, v, carry, k_offset=k_offset, **kw)

    got_out, got = loss(card)
    want_out, want = loss(ref)
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=0)
    for g, w_, name in zip(got, want, "qkv"):
        assert g.shape == w_.shape, name
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6, msg=name)
