"""The arithmetic and the loader choice of the port's tensor-core GEMM, on the CPU.

The kernels in ``src/repro_torch/kernels/csrc/gemm.cu`` run only on the card;
what they compute is split TF32: each float32 x becomes hi = tf32(x) and
lo = tf32(x - hi), both rounded to nearest with ties away from zero
(``cvt.rna.tf32.f32``), and A @ B is taken as A_lo B_hi + A_hi B_lo +
A_hi B_hi.  These tests emulate that split in plain PyTorch and hold its
accuracy against a float64 product, and check the wrapper's choice between
the aligned TMA, the strided TMA and the ``cp.async`` loader, a plain
function of shapes, strides and addresses.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gemm import loader_path

EXTRALARGE = (2048, 2560, 1408)
LAYOUT_CONFIGS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]
LOW_BITS = 0x1FFF  # the 13 low mantissa bits that TF32 does not keep


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (kept in float32), round to nearest, ties away from
    zero: add half of the dropped part to the magnitude bits, then cut."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & ~LOW_BITS & 0xFFFFFFFF
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def low_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & LOW_BITS


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # TF32 keeps 10 explicit mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0**-23,
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0])
    assert torch.equal(tf32_rna(x), want)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e30])
def test_split_parts_are_tf32_and_sum_back(scale):
    """hi and lo have their 13 low mantissa bits zero, and hi + lo is x to
    2^-22 of |x|.  The remainder x - hi can hold 13 significant bits, so lo
    may round off two of them: hi + lo == x exactly where x has at most 22
    significant bits."""
    x = _normal((4096,), seed=1) * scale
    hi, lo = split(x)
    assert not low_bits(hi).any() and not low_bits(lo).any()
    assert torch.equal(x - hi, (x.double() - hi.double()).float())  # the difference is exact
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0**-22 * x.double().abs()).all()
    x22 = (x.view(torch.int32) & ~0x3).view(torch.float32)  # 22 significant bits
    hi, lo = split(x22)
    assert torch.equal(hi + lo, x22)


def test_three_products_keep_float32_accuracy():
    """At K = 1408 (the case study's EXTRALARGE depth) with unit-normal
    inputs, the three-product sum stays within the kernel check's tolerance
    of the float64 product and within 10x of a float32 product's error,
    while hi @ hi alone is over 100x worse."""
    m, n, k = 192, 160, EXTRALARGE[2]
    a, b = _normal((m, k), seed=2), _normal((k, n), seed=3)
    exact = a.double() @ b.double()
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    three = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    one = a_hi @ b_hi
    err_f32 = (a @ b - exact).abs().max().item()
    err_three = (three.double() - exact).abs().max().item()
    err_one = (one.double() - exact).abs().max().item()
    torch.testing.assert_close(three.double(), exact, rtol=1e-4, atol=1e-3)
    assert err_three <= 10 * err_f32, (err_three, err_f32)
    assert err_one > 100 * err_f32, (err_one, err_f32)


def _gemm_path(m, n, k, majors, *, offsets=(0, 0)):
    """The loader of ``gemm`` on A and B at 256-aligned addresses plus
    ``offsets`` bytes."""
    return loader_path(m, n, k, majors, 0x7F0000000000 + offsets[0], 0x7F0100000000 + offsets[1])


@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_loader_path_extralarge_takes_tma(majors):
    assert _gemm_path(*EXTRALARGE, majors) == "tma"
    assert _gemm_path(2000, 2304, 1000, majors) == "tma"  # aligned, not tile-divisible


@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_loader_path_ragged_takes_strided_tma(majors):
    """Rows whose stride is no multiple of 16 bytes: every 4th row's is."""
    m, n, k = EXTRALARGE
    assert _gemm_path(m + 1, n + 1, k + 1, majors) == "tma_strided"  # the ragged SUMMA's dims+1
    assert _gemm_path(67, 131, 45, majors) == "tma_strided"
    assert _gemm_path(4, 5, 7, majors) == "tma_strided"


@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_loader_path_ragged_takes_async(majors):
    """Under 4 rows in a dimension a residue class of rows is empty and no
    strided map exists: cp.async."""
    for shape in ((3, 131, 45), (67, 2, 45), (67, 131, 3), (1, 1, 1)):
        assert _gemm_path(*shape, majors) == "async", shape


@pytest.mark.parametrize("operand", range(4))
def test_loader_path_unaligned_address_takes_async(operand):
    """A's or B's base off 16 bytes by 4, 8 or 12 leaves the aligned TMA:
    strided TMA at EXTRALARGE, cp.async with K = 3; by 16, TMA."""
    which, by = [(0, 4), (1, 8), (0, 12), (1, 4)][operand]
    offsets = [0, 0]
    offsets[which] = by
    assert _gemm_path(*EXTRALARGE, "I/I/K", offsets=tuple(offsets)) == "tma_strided"
    assert _gemm_path(256, 320, 3, "I/I/K", offsets=tuple(offsets)) == "async"
    offsets[which] = 16
    assert _gemm_path(*EXTRALARGE, "I/I/K", offsets=tuple(offsets)) == "tma"


def test_loader_path_needs_k():
    assert _gemm_path(256, 320, 0, "I/I/K") == "async"


@pytest.mark.parametrize("majors", ["I/I/K", "J/K/J"])
@pytest.mark.parametrize("n", [EXTRALARGE[1] // 4, 45, 641])
def test_loader_path_panel_block_offset(majors, n):
    """A panel's block starts jb * N columns in, which only the output's
    stores see: the loader follows B's row stride, N floats when B is
    K-major (``I/I/K``: TMA for N a multiple of 4, else strided TMA) and K
    floats when it is J-major (``J/K/J``: TMA at every N)."""
    m, k = EXTRALARGE[0], EXTRALARGE[2]
    want = "tma" if majors.endswith("J") or n % 4 == 0 else "tma_strided"
    assert loader_path(m, n, k, majors, 0x7F0000000000, 0x7F0100000000) == want
