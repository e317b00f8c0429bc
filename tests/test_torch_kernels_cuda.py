"""The port's CUDA GEMM kernels against their plain PyTorch versions, on the
card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run ``pytest tests/test_torch_kernels_cuda.py``.
Odd shapes exercise every edge tile.  Tolerance ``rtol=1e-4, atol=1e-3``:
both sides take float32 products (TF32 off), summed in different orders.
"""
import pytest
import torch

from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

LAYOUT_CONFIGS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.set_float32_matmul_precision(prev)


def _buffers(majors, m, n, k, device, *, nb=1):
    c_major, a_major, b_major = majors.split("/")
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((k, m) if a_major == "K" else (m, k), device=device, generator=g)
    b = torch.randn((n, k) if b_major == "J" else (k, n), device=device, generator=g)
    c = torch.randn((nb * n, m) if c_major == "J" else (m, nb * n), device=device, generator=g)
    return a, b, c


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_cuda_matches_plain_version(cuda, majors, with_acc):
    a, b, acc = _buffers(majors, 67, 131, 45, cuda)
    acc = acc if with_acc else None
    got = ops.gemm(a, b, acc, majors=majors)
    want = ops.gemm(a, b, acc, majors=majors, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_panel_cuda_matches_plain_version(cuda, majors):
    """Every block, jb as an int and as a device tensor; the other blocks
    stay bitwise unchanged."""
    n, nb = 45, 4
    a, b, panel = _buffers(majors, 67, n, 33, cuda, nb=nb)
    for jb in range(nb):
        for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32, device=cuda)):
            got = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
            want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
            keep = torch.ones_like(panel, dtype=torch.bool)
            if majors.startswith("J"):
                keep[jb * n:(jb + 1) * n, :] = False
            else:
                keep[:, jb * n:(jb + 1) * n] = False
            assert torch.equal(got[keep], panel[keep])


def test_kernel_launches_are_counted(cuda):
    from repro_torch.kernels import gemm

    a, b, panel = _buffers("I/I/K", 8, 8, 8, cuda, nb=2)
    before = (gemm.gemm_cuda.launches, gemm.gemm_panel_cuda.launches)
    ops.gemm(a, b)
    ops.gemm_panel(a, b, panel, 1)
    ops.gemm(a, b, impl="ref")
    assert (gemm.gemm_cuda.launches, gemm.gemm_panel_cuda.launches) == (before[0] + 1, before[1] + 1)
