"""The port's GEMM on bf16 operands against the reference's Pallas kernels,
on the CPU.

The same seeded numpy values, rounded to bf16 once, go through the
reference's ``ops.gemm`` / ``ops.gemm_panel`` with ``impl="interpret"``
(the Pallas kernels' bodies on the CPU, blocks of 32) and through the
port's ``ops.gemm`` / ``ops.gemm_panel`` on CPU tensors (their plain
versions), in all 8 majors.  The contract is the reference's: float32
sums, ``acc`` (bf16 or float32) added in float32, the output in
``out_dtype or a.dtype`` rounded once, the panel's block added to in
float32 and rounded to the panel's dtype, every other block untouched.
Tolerance: a bf16 output ``rtol=atol=2e-2`` (the reference's own, one bf16
ulp on float32 sums in another order); a float32 output ``1e-4`` (float32
sums in another order; the reference adds acc before the product, the port
after).  The card's kernels are held against these plain versions in
``test_torch_kernels_bf16_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops

ALL_MAJORS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]
BLOCKS = dict(bm=32, bn=32, bk=32)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _pair(rng, shape, dtype=torch.bfloat16):
    """Seeded values rounded to ``dtype`` once, as (jax array, torch tensor)."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(JNP[dtype])
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


def _operands(rng, M, N, K, majors):
    _, a_major, b_major = majors.split("/")
    a = _pair(rng, (K, M) if a_major == "K" else (M, K))
    b = _pair(rng, (N, K) if b_major == "J" else (K, N))
    return a, b


def _close(got: torch.Tensor, want, dtype):
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("majors", ALL_MAJORS)
@pytest.mark.parametrize("shape", [(32, 32, 32), (128, 64, 32), (64, 128, 256)])
def test_gemm_bf16_matches_reference_kernel(shape, majors):
    """The reference's own bf16 sweep (``tests/test_kernels.py``), in every
    majors: the output is bf16 (``a.dtype``)."""
    M, N, K = shape
    (ja, ta), (jb, tb) = _operands(np.random.default_rng(M + N + K), M, N, K, majors)
    want = jops.gemm(ja, jb, majors=majors, impl="interpret", **BLOCKS)
    assert want.dtype == jnp.bfloat16
    _close(tops.gemm(ta, tb, majors=majors), want, torch.bfloat16)


@pytest.mark.parametrize("majors", ALL_MAJORS)
@pytest.mark.parametrize("acc_dtype,out_dtype", [(torch.bfloat16, None),
                                                 (torch.bfloat16, torch.float32),
                                                 (torch.float32, None),
                                                 (torch.float32, torch.float32)])
def test_gemm_bf16_acc_and_out_dtype_match_reference_kernel(acc_dtype, out_dtype, majors):
    """``acc`` in bf16 or float32, added in float32 after the product; the
    output in ``out_dtype or a.dtype``, rounded once."""
    M, N, K = 64, 96, 64
    rng = np.random.default_rng(11)
    (ja, ta), (jb, tb) = _operands(rng, M, N, K, majors)
    jacc, tacc = _pair(rng, (N, M) if majors.startswith("J") else (M, N), acc_dtype)
    want = jops.gemm(ja, jb, jacc, majors=majors, impl="interpret",
                     out_dtype=None if out_dtype is None else jnp.float32, **BLOCKS)
    got = tops.gemm(ta, tb, tacc, majors=majors, out_dtype=out_dtype)
    _close(got, want, out_dtype or torch.bfloat16)


@pytest.mark.parametrize("majors", ALL_MAJORS)
@pytest.mark.parametrize("panel_dtype", [torch.bfloat16, torch.float32])
def test_gemm_panel_bf16_matches_reference_kernel(panel_dtype, majors):
    """Each block jb of a 3-block panel, bf16 or float32: block jb added to
    in float32 and rounded to the panel's dtype; every other block bitwise
    the input's, on both sides."""
    M, N, K, nb = 64, 32, 64, 3
    rng = np.random.default_rng(12)
    (ja, ta), (jb_, tb) = _operands(rng, M, N, K, majors)
    j_major = majors.startswith("J")
    shape = (nb * N, M) if j_major else (M, nb * N)
    jpanel, tpanel = _pair(rng, shape, panel_dtype)
    for jb in range(nb):
        want = jops.gemm_panel(ja, jb_, jpanel, jb, majors=majors, impl="interpret", **BLOCKS)
        got = tops.gemm_panel(ta, tb, tpanel.clone(), jb, majors=majors)
        _close(got, want, panel_dtype)
        keep = np.ones(shape, bool)
        blk = slice(jb * N, (jb + 1) * N)
        if j_major:
            keep[blk, :] = False
        else:
            keep[:, blk] = False
        assert torch.equal(got[torch.from_numpy(keep)], tpanel[torch.from_numpy(keep)])
        np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32))[keep],
                                      tpanel.float().numpy()[keep])


def test_gemm_bf16_rounds_once():
    """With acc, the bf16 output is the float32 sum of product and acc
    rounded once: not the product rounded to bf16 and then added."""
    rng = np.random.default_rng(13)
    (_, ta), (_, tb) = _operands(rng, 64, 64, 64, "I/I/K")
    _, acc = _pair(rng, (64, 64), torch.float32)
    acc = acc * 1e-3
    got = tops.gemm(ta, tb, acc)
    product = ta.float() @ tb.float()
    assert torch.equal(got, (product + acc).to(torch.bfloat16))
    assert not torch.equal(got, (product.to(torch.bfloat16).float() + acc).to(torch.bfloat16))


CARD_REFUSALS = {
    "gemm_float16": (lambda a, b, p: tops.gemm(a.half(), b.half(), impl="cuda"), "float16"),
    "gemm_mixed": (lambda a, b, p: tops.gemm(a, b.float(), impl="cuda"), "one dtype"),
    "gemm_float16_acc": (lambda a, b, p: tops.gemm(a, b, p[:, :3].half().contiguous(),
                                                   impl="cuda"), "float16"),
    "gemm_float16_out": (lambda a, b, p: tops.gemm(a, b, impl="cuda", out_dtype=torch.float16),
                         "float16"),
    "panel_float16": (lambda a, b, p: tops.gemm_panel(a.half(), b.half(), p, 0, impl="cuda"),
                      "float16"),
    "panel_mixed": (lambda a, b, p: tops.gemm_panel(a.float(), b, p, 0, impl="cuda"),
                    "one dtype"),
    "panel_float16_panel": (lambda a, b, p: tops.gemm_panel(a, b, p.half(), 0, impl="cuda"),
                            "float16"),
}


@pytest.mark.parametrize("case", sorted(CARD_REFUSALS))
def test_card_refuses_what_the_kernels_do_not_take(case):
    """On the card the GEMM takes float32 or bf16 operands of one dtype:
    float16 anywhere, and A and B of two dtypes, raise a ``TypeError``
    that names it, before any device is touched (so on CPU tensors too),
    and nothing launches."""
    call, names = CARD_REFUSALS[case]
    a, b = torch.zeros(4, 5, dtype=torch.bfloat16), torch.zeros(5, 3, dtype=torch.bfloat16)
    panel = torch.zeros(4, 6, dtype=torch.bfloat16)
    tgemm.reset_launches()
    with pytest.raises(TypeError, match=names):
        call(a, b, panel)
    assert tgemm.gemm_bf16_cuda.launches == 0 and tgemm.gemm_panel_bf16_cuda.launches == 0


def test_bf16_operands_reach_the_bf16_kernels_on_the_card_only():
    """``impl="cuda"`` on bf16 CPU tensors routes to the bf16 wrappers,
    which refuse a CPU tensor (no fallback to the plain version)."""
    a, b = torch.zeros(4, 5, dtype=torch.bfloat16), torch.zeros(5, 3, dtype=torch.bfloat16)
    tgemm.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.gemm(a, b, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.gemm_panel(a, b, torch.zeros(4, 6), 1, impl="cuda")
    assert all(fn.launches == 0 for fn in (tgemm.gemm_cuda, tgemm.gemm_panel_cuda,
                                           tgemm.gemm_bf16_cuda, tgemm.gemm_panel_bf16_cuda))
    assert tgemm.gemm_bf16_cuda.launches_by_path == {"plain": 0, "tma": 0}


@pytest.mark.parametrize("case,args,want", [
    ("extralarge", ((2048, 2560, 1408), 0, 0), "tma"),
    ("ragged_dims_plus_1", ((2049, 2561, 1409), 0, 0), "plain"),
    ("k_not_multiple_of_8", ((128, 128, 100), 0, 0), "plain"),
    ("n_multiple_of_8", ((127, 136, 64), 0, 0), "tma"),
    ("base_off_16_bytes", ((128, 128, 64), 2, 0), "plain"),
    ("no_k", ((128, 128, 0), 0, 0), "plain"),
])
def test_loader_path_bf16(case, args, want):
    """TMA wants 16-byte aligned bases and rows of a multiple of 8 bf16
    values; anything else takes the plain loads."""
    (M, N, K), a_off, b_off = args
    assert tgemm.loader_path_bf16(M, N, K, "I/I/K", 1024 + a_off, 4096 + b_off) == want


@pytest.mark.parametrize("majors", ALL_MAJORS)
def test_loader_path_bf16_reads_each_operands_row_length(majors):
    """The row length that must be a multiple of 8 is M or K for A, K or N
    for B, by majors: at (M, N, K) = (128, 132, 64) only B's K-major rows
    (N = 132 values) miss it."""
    want = "tma" if majors.endswith("J") else "plain"
    assert tgemm.loader_path_bf16(128, 132, 64, majors, 0, 0) == want


# (M, N, majors, nb, (C's address, item size), (acc's address, item size) or
# None, the loader's path)
STORE_CASES = {
    "extralarge_bf16": ((2048, 2560, "I/I/K", 1, (1024, 2), None, "tma"), "tma"),
    "extralarge_f32_out": ((2048, 2560, "I/I/K", 1, (1024, 4), None, "tma"), "tma"),
    "behind_plain_loads": ((2048, 2560, "I/I/K", 1, (1024, 2), None, "plain"), "direct"),
    "panel_behind_plain_loads": ((2048, 1280, "J/I/K", 2, (1024, 4), None, "plain"), "direct"),
    "c_base_off_16_bytes": ((2048, 2560, "I/I/K", 1, (1026, 2), None, "tma"), "direct"),
    "c_base_off_8_bytes_f32": ((2048, 2560, "I/I/K", 1, (1032, 4), None, "tma"), "direct"),
    "acc_aligned": ((2048, 2560, "I/I/K", 1, (1024, 2), (4096, 2), "tma"), "tma"),
    "acc_base_off_16_bytes": ((2048, 2560, "I/I/K", 1, (1024, 2), (4098, 2), "tma"), "direct"),
    "ragged_dims_plus_1": ((2049, 2561, "I/I/K", 1, (1024, 2), None, "tma"), "direct"),
    "i_major_ignores_M": ((2049, 2560, "I/I/K", 1, (1024, 2), None, "tma"), "tma"),
    "row_of_8_bytes_bf16": ((64, 132, "I/I/K", 1, (1024, 2), None, "tma"), "direct"),
    "row_of_16_bytes_f32": ((64, 132, "I/I/K", 1, (1024, 4), None, "tma"), "tma"),
    "acc_own_item_size": ((64, 132, "I/I/K", 1, (1024, 4), (4096, 2), "tma"), "direct"),
    "acc_f32_row_of_16_bytes": ((64, 136, "I/I/K", 1, (1024, 2), (4096, 4), "tma"), "tma"),
    "j_major_reads_M": ((2049, 2560, "J/I/K", 1, (1024, 2), None, "tma"), "direct"),
    "j_major_ignores_N": ((2056, 2561, "J/K/J", 1, (1024, 2), None, "tma"), "tma"),
    "j_major_acc_unaligned": ((2056, 2568, "J/I/J", 1, (1024, 4), (4100, 4), "tma"), "direct"),
    "panel_width_45": ((67, 45, "I/I/K", 4, (1024, 2), None, "tma"), "direct"),
    "panel_width_45_f32": ((67, 45, "I/K/J", 4, (1024, 4), None, "tma"), "direct"),
    "panel_row_aligned_block_offset_not": ((64, 4, "I/I/K", 4, (1024, 2), None, "tma"), "direct"),
    "panel_block_offset_of_16_bytes": ((64, 8, "I/I/K", 3, (1024, 2), None, "tma"), "tma"),
    "panel_j_major_width_45": ((2056, 45, "J/I/K", 2, (1024, 2), None, "tma"), "tma"),
    "panel_j_major_odd_M": ((67, 64, "J/K/K", 2, (1024, 4), None, "tma"), "direct"),
    "empty": ((0, 128, "I/I/K", 1, (1024, 2), None, "tma"), "direct"),
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_path_bf16(case):
    """The TMA store (and acc's TMA load) goes with the TMA loader, and
    wants 16-byte aligned bases and map strides of multiples of 16 bytes:
    the rows of C and acc (N values i-major, M j-major, each at its own item
    size) and, for a panel, the step from one j-block to the next (N values
    i-major, N rows of M j-major); anything else stores directly."""
    (M, N, majors, nb, (c_addr, c_size), acc, loader), want = STORE_CASES[case]
    acc_addr, acc_size = acc or (None, 0)
    assert tgemm.store_path_bf16(M, N, majors, c_addr, c_size, acc_addr, acc_size, nb=nb,
                                 loader=loader) == want


@pytest.mark.parametrize("majors", ALL_MAJORS)
def test_gemm_bf16_on_cpu_takes_the_plain_version_and_counts_nothing(majors):
    """On CPU tensors ``ops.gemm`` and ``ops.gemm_panel`` run their plain
    versions: the results are the plain functions' own, and neither the
    loader nor the store counters of the bf16 wrappers move."""
    rng = np.random.default_rng(14)
    (_, ta), (_, tb) = _operands(rng, 40, 24, 16, majors)
    shape = (24, 40) if majors.startswith("J") else (40, 24)
    _, acc = _pair(rng, shape, torch.float32)
    _, panel = _pair(rng, (48, 40) if majors.startswith("J") else (40, 48))
    tgemm.reset_launches()
    got = tops.gemm(ta, tb, acc, majors=majors, out_dtype=torch.float32)
    assert torch.equal(got, tops.gemm(ta, tb, acc, majors=majors, out_dtype=torch.float32,
                                      impl="ref"))
    got_panel = tops.gemm_panel(ta, tb, panel.clone(), 1, majors=majors)
    assert torch.equal(got_panel, tops.gemm_panel(ta, tb, panel.clone(), 1, majors=majors,
                                                  impl="ref"))
    for fn in (tgemm.gemm_bf16_cuda, tgemm.gemm_panel_bf16_cuda):
        assert fn.launches == 0
        assert fn.launches_by_path == {"plain": 0, "tma": 0}
        assert fn.launches_by_store == {"direct": 0, "tma": 0}
