"""The port's attention kernels' plain versions against the reference's
Pallas kernels, on the CPU.

The same seeded numpy inputs go through the reference's
``flash_attention_pallas`` / ``flash_decode_pallas`` in interpret mode and
through the port's ``ops.flash_attention`` / ``ops.flash_decode`` on CPU
tensors (their plain versions).  Tolerances: float32 ``rtol=atol=2e-4``
(float32 sums in another order, and XLA's ``exp`` against PyTorch's);
bfloat16 ``rtol=atol=1e-2`` (one bf16 ulp of the output on top of that).
The CUDA kernels are held against these plain versions in
``test_torch_attention_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-4, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(rng, shape, dtype):
    """Seeded values, rounded to ``dtype`` once, as (jax array, torch tensor)."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(JNP[dtype])
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH[dtype])


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_kernel(causal, heads, dtype):
    """Ragged S = 40 with blocks of 16: the last KV block is padded and its
    padded keys masked; GQA maps query head h to KV head h // group."""
    Hq, G = heads
    rng = np.random.default_rng(0)
    jq, tq = _normal(rng, (2, Hq, 40, 16), dtype)
    jk, tk = _normal(rng, (2, G, 40, 16), dtype)
    jv, tv = _normal(rng, (2, G, 40, 16), dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, bq=16, bk=16, interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=causal, block=16)
    assert got.dtype == TORCH[dtype] and got.shape == (2, Hq, 40, 16)
    _close(got, want, dtype)


def test_flash_attention_plain_matches_dense_oracle():
    """The plain version's blocks change nothing beyond float32 rounding."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 64, 16)).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    for block in (16, 64):
        torch.testing.assert_close(tops.flash_attention(q, k, v, block=block),
                                   tref.attention_ref(q, k, v), rtol=2e-5, atol=2e-5)


def _decode_case(case, dtype, rng):
    """(q, k_cache, v_cache, cache_len, q_positions, block) as jax and torch
    pairs.  ``ragged``: T = 40 that blocks of 16 do not divide, per-row
    lengths with an idle row (length 0), one query each.  ``chunk``: an
    8-token chunk per row at its own position (whole-prompt prefill and a
    continuing row), ``q_positions`` masking within the chunk."""
    B, Hq, G, T, D = 4, 4, 2, 40, 16
    S = 1 if case == "ragged" else 8
    jq, tq = _normal(rng, (B, Hq, S, D), dtype)
    jk, tk = _normal(rng, (B, G, T, D), dtype)
    jv, tv = _normal(rng, (B, G, T, D), dtype)
    if case == "ragged":
        lens, pos = np.array([40, 17, 0, 33], np.int32), None
    else:
        start = np.array([0, 9, 0, 30], np.int32)
        counts = np.array([8, 3, 0, 8], np.int32)
        lens = start + counts
        pos = start[:, None] + np.arange(S, dtype=np.int32)[None, :]
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.from_numpy(pos)
    return (jq, tq), (jk, tk), (jv, tv), (jnp.asarray(lens), torch.from_numpy(lens)), \
        (jpos, tpos), 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "chunk"])
def test_flash_decode_plain_matches_pallas_kernel(case, dtype):
    """Every row, idle ones included (the plain version skips nothing).  At
    bfloat16 the caches are bf16 and each KV block's probabilities round to
    bf16 relative to that block's own max, on both sides."""
    q, k, v, lens, pos, block = _decode_case(case, dtype, np.random.default_rng(2))
    want = flash_decode_pallas(q[0], k[0], v[0], lens[0], q_positions=pos[0], bk=block,
                               interpret=True)
    got = tops.flash_decode(q[1], k[1], v[1], lens[1], q_positions=pos[1], block=block)
    assert got.dtype == TORCH[dtype] and got.shape == q[1].shape
    _close(got, want, dtype)


def test_flash_decode_block_split_is_part_of_the_function():
    """With bf16 caches the block size changes the result (each block rounds
    relative to its own max); the plain version matches the reference
    kernel at the kernel's block."""
    q, k, v, lens, pos, _ = _decode_case("ragged", "bfloat16", np.random.default_rng(3))
    want16 = np.asarray(flash_decode_pallas(q[0], k[0], v[0], lens[0], bk=16, interpret=True)
                        .astype(jnp.float32))
    got16 = tops.flash_decode(q[1], k[1], v[1], lens[1], block=16).float().numpy()
    got40 = tops.flash_decode(q[1], k[1], v[1], lens[1], block=40).float().numpy()
    live = [0, 1, 3]  # rows with a visible key
    np.testing.assert_allclose(got16[live], want16[live], rtol=1e-2, atol=1e-2)
    assert np.abs(got40 - got16)[live].max() > 0


def test_flash_decode_plain_matches_dense_oracles():
    """At float32 the block split changes nothing beyond rounding: the plain
    version equals the dense oracle on every row with a visible key, and the
    port's dense oracle equals the reference's on every row."""
    q, k, v, lens, pos, _ = _decode_case("chunk", "float32", np.random.default_rng(6))
    dense = tref.decode_attention_ref(q[1], k[1], v[1], lens[1], q_positions=pos[1])
    _close(dense, jref.decode_attention_ref(q[0], k[0], v[0], lens[0], q_positions=pos[0]),
           "float32")
    live = lens[1] > 0
    torch.testing.assert_close(tops.flash_decode(q[1], k[1], v[1], lens[1], q_positions=pos[1],
                                                 block=16)[live], dense[live],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jnp_decode_route_matches_reference(dtype):
    """``attn_impl="jnp"``: dense scores, probabilities normalized and then
    rounded to the cache dtype, against the reference's jnp path."""
    q, k, v, lens, pos, _ = _decode_case("chunk", dtype, np.random.default_rng(4))
    want = jattn.attention_decode(q[0], k[0], v[0], lens[0], q_positions=pos[0], impl="jnp")
    got = tattn.attention_decode(q[1], k[1], v[1], lens[1], q_positions=pos[1], impl="jnp")
    _close(got, want, dtype)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_reference(per_row):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    pos = (rng.integers(0, 100, size=(2, 6)) if per_row else np.arange(6)).astype(np.int32)
    jc, js = jattn.rope_angles(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tattn.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    want = jattn.apply_rope(jnp.asarray(x), jc, js)
    got = tattn.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["check_attention", "flash_attention",
                                   "flash_attention_carry"])
def test_v_head_dim_other_than_qk_is_refused(entry):
    """A v head dim Dv != D: the forward and the carry form take it as the
    reference does (``check_attention`` passes, ``flash_attention`` returns
    (..., Dv) and one carry step from an empty state, normalized, gives the
    same, each equal to the reference's Pallas kernel in interpret mode).
    Decode takes it too: :func:`test_decode_takes_a_v_head_dim_of_its_own`."""
    from repro_torch.kernels.flash_attention import check_attention

    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8, 128)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 8, 128)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 8, 64)).astype(np.float32))
    want = flash_attention_pallas(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                  jnp.asarray(v.numpy()), causal=True, interpret=True)
    assert want.shape == (1, 4, 8, 64)
    if entry == "check_attention":
        assert check_attention(q, k, v) == (1, 4, 2, 8, 8, 128)
        return
    if entry == "flash_attention":
        got = tops.flash_attention(q, k, v)
        assert got.shape == (1, 4, 8, 64)
        _close(got, want, "float32")
        return
    acc, _, l = tops.flash_attention_carry(q, k, v)
    assert acc.shape == (1, 4, 8, 64)
    _close(acc / torch.where(l == 0, 1.0, l)[..., None], want, "float32")


@pytest.mark.parametrize("entry", ["check_decode", "flash_decode"])
def test_decode_takes_a_v_head_dim_of_its_own(entry):
    """Decode with MLA's widths, q/k of 96 and v of 64, as the reference's
    ``flash_decode_pallas`` takes them (``Dv = v_cache.shape[-1]``):
    ``check_decode`` returns Dv, and ``flash_decode``'s plain version
    returns (B, Hq, S, Dv) equal to the reference's kernel in interpret mode
    (float32, ``TOL``), 3 of 4 KV blocks of 16 holding keys and one row
    idle."""
    from repro_torch.kernels.flash_decode import check_decode

    rng = np.random.default_rng(7)
    jq, q = _normal(rng, (2, 4, 1, 96), "float32")
    jk, k = _normal(rng, (2, 2, 64, 96), "float32")
    jv, v = _normal(rng, (2, 2, 64, 64), "float32")
    lens = np.array([41, 0], np.int32)
    if entry == "check_decode":
        assert check_decode(q, k, v, torch.from_numpy(lens), None) == (2, 4, 2, 1, 64, 96, 64)
        return
    want = flash_decode_pallas(jq, jk, jv, jnp.asarray(lens), bk=16, interpret=True)
    assert want.shape == (2, 4, 1, 64)
    got = tops.flash_decode(q, k, v, torch.from_numpy(lens), block=16)
    assert got.shape == (2, 4, 1, 64)
    _close(got, want, "float32")
