"""The port's CUDA GEMM kernels against their plain PyTorch versions, on the
card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run ``pytest tests/test_torch_kernels_cuda.py``.
Odd shapes exercise every edge tile, aligned shapes the TMA loader.
Tolerance ``rtol=1e-4, atol=1e-3``: the plain version takes float32
products (TF32 off), the kernel split-TF32 products of float32-class
accuracy, summed in different orders.
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


# The kernels load k-tiles through TMA when A's and B's base addresses are
# 16-byte aligned and their row strides multiples of 16 bytes, else through
# strided TMA (every 4th row) when M, N, K >= 4, else through cp.async
# (repro_torch.kernels.gemm.loader_path).  Tile 128 x 160, k-tile 32.
PATH_SHAPES = [((256, 320, 128), "tma"),         # tile multiples, aligned
               ((200, 232, 100), "tma"),         # aligned, ragged edges in i, j and k
               ((67, 131, 45), "tma_strided"),   # unaligned rows
               ((67, 131, 3), "async")]          # K under 4: a residue class is empty


def _only(path):
    return {p: int(p == path) for p in ("tma", "tma_strided", "async")}


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
@pytest.mark.parametrize("shape, path", PATH_SHAPES,
                         ids=["tiles", "aligned_ragged", "unaligned", "tiny_k"])
def test_gemm_cuda_each_loader_matches_plain_version(cuda, shape, path, majors, with_acc):
    from repro_torch.kernels import gemm

    a, b, acc = _buffers(majors, *shape, cuda)
    acc = acc if with_acc else None
    gemm.reset_launches()
    got = ops.gemm(a, b, acc, majors=majors)
    assert gemm.gemm_cuda.launches_by_path == _only(path)
    want = ops.gemm(a, b, acc, majors=majors, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("k", [0, 4, 5])
@pytest.mark.parametrize("with_acc", [False, True])
def test_gemm_cuda_k_below_one_k_tile(cuda, k, with_acc):
    """K shorter than a k-tile is zero-filled; K = 0 gives acc or zeros."""
    a, b, acc = _buffers("I/I/K", 96, 200, k, cuda)
    acc = acc if with_acc else None
    got = ops.gemm(a, b, acc, majors="I/I/K")
    want = ops.gemm(a, b, acc, majors="I/I/K", impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    if k == 0:
        assert torch.equal(got, acc if with_acc else torch.zeros_like(got))


@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
@pytest.mark.parametrize("n", [33, 164])
def test_gemm_panel_cuda_block_offset(cuda, majors, n):
    """The block offset jb * N is unaligned at N = 33: every block matches
    the plain version and leaves the others bitwise alone.  The loader
    follows B's row stride: N floats when B is K-major, else K = 64."""
    from repro_torch.kernels import gemm

    path = "tma_strided" if n % 4 and majors.endswith("K") else "tma"
    nb = 3
    a, b, panel = _buffers(majors, 200, n, 64, cuda, nb=nb)
    for jb in range(nb):
        gemm.reset_launches()
        got = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors)
        assert gemm.gemm_panel_cuda.launches_by_path[path] == 1
        want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        keep = torch.ones_like(panel, dtype=torch.bool)
        if majors.startswith("J"):
            keep[jb * n:(jb + 1) * n, :] = False
        else:
            keep[:, jb * n:(jb + 1) * n] = False
        assert torch.equal(got[keep], panel[keep])


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("k, path", [(100, "tma_strided"), (3, "async")])
def test_gemm_cuda_unaligned_base_address(cuda, k, path, shift, majors, with_acc):
    """A and B start ``shift`` floats past a 16-byte boundary (contiguous
    views into larger buffers): every row's shift is taken from the base
    address, by the strided TMA's maps and by cp.async."""
    from repro_torch.kernels import gemm

    a0, b0, acc = _buffers(majors, 200, 232, k, cuda)
    a = torch.empty(a0.numel() + shift, device=cuda)[shift:].view(a0.shape).copy_(a0)
    b = torch.empty(b0.numel() + 4 - shift, device=cuda)[4 - shift:].view(b0.shape).copy_(b0)
    acc = acc if with_acc else None
    gemm.reset_launches()
    got = ops.gemm(a, b, acc, majors=majors)
    assert gemm.gemm_cuda.launches_by_path == _only(path)
    torch.testing.assert_close(got, ops.gemm(a0, b0, acc, majors=majors, impl="ref"),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(1000, 1200, 700), (1001, 1199, 701), (1001, 1199, 3)],
                         ids=["tma", "tma_strided", "async"])
@pytest.mark.parametrize("majors", ["I/I/K", "J/K/J"])
def test_gemm_cuda_is_deterministic(cuda, shape, majors):
    a, b, acc = _buffers(majors, *shape, cuda)
    first = ops.gemm(a, b, acc, majors=majors)
    second = ops.gemm(a, b, acc, majors=majors)
    assert torch.equal(first, second)


def test_launches_by_path_sum_to_launches(cuda):
    from repro_torch.kernels import gemm

    gemm.reset_launches()
    for shape in ((256, 320, 128), (67, 131, 45), (64, 64, 0)):
        a, b, panel = _buffers("I/I/K", *shape, cuda, nb=2)
        ops.gemm(a, b)
        ops.gemm_panel(a, b, panel, 1)
    for fn in (gemm.gemm_cuda, gemm.gemm_panel_cuda):
        assert fn.launches == 3 == sum(fn.launches_by_path.values())
        assert fn.launches_by_path["tma"] == 1
