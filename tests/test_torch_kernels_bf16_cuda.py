"""The bf16 GEMM kernels and the decode kernel's (96, 64) instance against
their plain PyTorch versions, on the card.

These tests import neither ``jax`` nor the reference package, and skip
without a CUDA device; on a GPU host run
``pytest tests/test_torch_kernels_bf16_cuda.py``.  Odd shapes exercise
every edge tile and the plain loader, aligned ones the TMA loader.
Tolerances: a GEMM's bf16 output ``rtol=atol=1e-2`` (the kernel and its
plain version both sum in float32, in other orders, and round once: one
bf16 ulp apart at most); its float32 output ``rtol=1e-4, atol=1e-3``
(float32 sums in another order), as for the float32 kernels; decode as in
``tests/test_torch_attention_cuda.py``: float32 ``2e-4``, bf16 ``1e-2``.
Each GEMM launch is counted on its store too: 2056 x 2568 x 1408 takes the
TMA loader and the TMA store (its rows multiples of 8, its edge tiles 8
wide, so the store is clipped); the ragged shapes and a bf16 panel of
width 45 store directly.
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm as kernels
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

LAYOUT_CONFIGS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]
GEMM_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2),
            torch.float32: dict(rtol=1e-4, atol=1e-3)}
DECODE_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.set_float32_matmul_precision(prev)


def _buffers(majors, m, n, k, device, *, nb=1, c_dtype=torch.bfloat16, seed=0):
    c_major, a_major, b_major = majors.split("/")
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((k, m) if a_major == "K" else (m, k), device=device, generator=g)
    b = torch.randn((n, k) if b_major == "J" else (k, n), device=device, generator=g)
    c = torch.randn((nb * n, m) if c_major == "J" else (m, nb * n), device=device, generator=g)
    return a.to(torch.bfloat16), b.to(torch.bfloat16), c.to(c_dtype)


@pytest.mark.parametrize("acc_dtype,out_dtype", [(None, None), (None, torch.float32),
                                                 (torch.bfloat16, None),
                                                 (torch.float32, torch.float32)])
@pytest.mark.parametrize("shape,path,store", [((256, 384, 192), "tma", "tma"),
                                              ((67, 131, 45), "plain", "direct"),
                                              ((200, 136, 1000), "tma", "tma"),
                                              ((2056, 2568, 1408), "tma", "tma")])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_bf16_cuda_matches_plain_version(cuda, majors, shape, path, store, acc_dtype,
                                              out_dtype):
    """Every majors, each loader and store, with and without acc, both
    outputs; the launch is counted on the loader and the store expected
    (200 x 136 x 1000: TMA with edge tiles in every dimension)."""
    a, b, acc = _buffers(majors, *shape, cuda, c_dtype=acc_dtype or torch.bfloat16)
    acc = acc if acc_dtype is not None else None
    kernels.reset_launches()
    got = ops.gemm(a, b, acc, majors=majors, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.gemm_bf16_cuda.launches_by_path[path] == 1
    assert kernels.gemm_bf16_cuda.launches_by_store[store] == 1
    assert kernels.gemm_cuda.launches == 0
    want = ops.gemm(a, b, acc, majors=majors, out_dtype=out_dtype, impl="ref")
    assert got.dtype == want.dtype == (out_dtype or torch.bfloat16)
    torch.testing.assert_close(got, want, **GEMM_TOL[got.dtype])


@pytest.mark.parametrize("panel_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_panel_bf16_cuda_matches_plain_version(cuda, majors, panel_dtype):
    """Every block, jb as an int and as a device tensor, bf16 and float32
    panels; the other blocks stay bitwise unchanged.  Blocks of 45 columns
    (and 67 rows) store directly."""
    n, nb = 45, 4
    a, b, panel = _buffers(majors, 67, n, 33, cuda, nb=nb, c_dtype=panel_dtype)
    kernels.reset_launches()
    for jb in range(nb):
        for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32, device=cuda)):
            got = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
            want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
            torch.testing.assert_close(got, want, **GEMM_TOL[panel_dtype])
            keep = torch.ones_like(panel, dtype=torch.bool)
            if majors.startswith("J"):
                keep[jb * n:(jb + 1) * n, :] = False
            else:
                keep[:, jb * n:(jb + 1) * n] = False
            assert torch.equal(got[keep], panel[keep])
    assert kernels.gemm_panel_bf16_cuda.launches_by_store == {"direct": 2 * nb, "tma": 0}


@pytest.mark.parametrize("panel_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_panel_bf16_cuda_tma_store_clipped_at_its_block(cuda, majors, panel_dtype):
    """Two blocks of 2056 x 2568 (K 1408), jb by value and from the device:
    the TMA store's edge tiles, 8 columns (or rows) wide, are clipped at
    their own block, the other block stays bitwise unchanged, and a rerun
    is bitwise equal."""
    m, n, k, nb = 2056, 2568, 1408, 2
    a, b, panel = _buffers(majors, m, n, k, cuda, nb=nb, c_dtype=panel_dtype)
    kernels.reset_launches()
    for jb in range(nb):
        want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
        keep = torch.ones_like(panel, dtype=torch.bool)
        if majors.startswith("J"):
            keep[jb * n:(jb + 1) * n, :] = False
        else:
            keep[:, jb * n:(jb + 1) * n] = False
        for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32, device=cuda)):
            got = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
            torch.testing.assert_close(got, want, **GEMM_TOL[panel_dtype])
            assert torch.equal(got[keep], panel[keep])
            assert torch.equal(got, ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors))
    assert kernels.gemm_panel_bf16_cuda.launches_by_path == {"plain": 0, "tma": 4 * nb}
    assert kernels.gemm_panel_bf16_cuda.launches_by_store == {"direct": 0, "tma": 4 * nb}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("majors", ["I/I/K", "J/K/J"])
@pytest.mark.parametrize("shape,store", [((2056, 2568, 1408), "tma"),
                                         ((2049, 2561, 1409), "direct")])
def test_gemm_bf16_cuda_acc_may_be_the_output(cuda, shape, store, majors, dtype):
    """acc passed as the output buffer itself (the entry point allows it:
    each tile is read before it is written, by one block) gives the bits
    of the same sum into a new buffer, on either store."""
    a, b, c = _buffers(majors, *shape, cuda, c_dtype=dtype)
    m, n, k = shape
    a_trans, b_trans, c_trans = kernels.parse_majors(majors)
    want = ops.gemm(a, b, c, majors=majors, out_dtype=dtype)
    loader = kernels.loader_path_bf16(m, n, k, majors, a.data_ptr(), b.data_ptr())
    assert kernels.store_path_bf16(m, n, majors, c.data_ptr(), c.element_size(), c.data_ptr(),
                                   c.element_size(), loader=loader) == store
    lib = kernels.load_bf16_library()
    bf16 = dtype == torch.bfloat16
    code = lib.layout_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), c.data_ptr(), m, n, k,
                                a_trans, b_trans, c_trans, bf16, bf16,
                                kernels.BF16_LOADERS[loader], kernels.BF16_STORES[store],
                                torch.cuda.current_stream().cuda_stream)
    assert code == 0
    torch.cuda.synchronize()
    assert torch.equal(c, want)


@pytest.mark.parametrize("majors", ["I/I/K", "J/K/J"])
def test_gemm_panel_bf16_cuda_tma_block_offset(cuda, majors):
    """A panel at the TMA loader's shapes (the block's columns start
    jb * N into the panel's rows)."""
    n, nb = 256, 3
    a, b, panel = _buffers(majors, 256, n, 192, cuda, nb=nb)
    kernels.reset_launches()
    for jb in range(nb):
        got = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors)
        want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
        torch.testing.assert_close(got, want, **GEMM_TOL[torch.bfloat16])
    assert kernels.gemm_panel_bf16_cuda.launches_by_path == {"plain": 0, "tma": nb}


@pytest.mark.parametrize("operand", ["a", "b"])
def test_gemm_bf16_cuda_unaligned_base_takes_plain_loads(cuda, operand):
    """A view one element into its storage: not 16-byte aligned, so the
    plain loader; the result is the plain version's."""
    a, b, _ = _buffers("I/I/K", 128, 256, 128, cuda)
    if operand == "a":
        a = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)[1:].view(a.shape).copy_(a)
    else:
        b = torch.empty(b.numel() + 1, dtype=b.dtype, device=cuda)[1:].view(b.shape).copy_(b)
    kernels.reset_launches()
    got = ops.gemm(a, b)
    assert kernels.gemm_bf16_cuda.launches_by_path == {"plain": 1, "tma": 0}
    torch.testing.assert_close(got, ops.gemm(a, b, impl="ref"), **GEMM_TOL[torch.bfloat16])


@pytest.mark.parametrize("k", [0, 1, 8])
def test_gemm_bf16_cuda_short_k(cuda, k):
    """K below one k-tile (and K = 0: the output is acc, or zeros)."""
    a, b, acc = _buffers("I/I/K", 67, 131, k, cuda, c_dtype=torch.float32)
    for c in (None, acc):
        got = ops.gemm(a, b, c, out_dtype=torch.float32)
        torch.testing.assert_close(got, ops.gemm(a, b, c, out_dtype=torch.float32, impl="ref"),
                                   **GEMM_TOL[torch.float32])


@pytest.mark.parametrize("shape", [(2048, 2560, 1408), (2049, 2561, 1409), (2056, 2568, 1408)])
@pytest.mark.parametrize("majors", ["I/I/K", "J/K/J"])
def test_gemm_bf16_cuda_is_deterministic(cuda, shape, majors):
    a, b, _ = _buffers(majors, *shape, cuda)
    for out_dtype in (None, torch.float32):
        first = ops.gemm(a, b, majors=majors, out_dtype=out_dtype)
        assert torch.equal(first, ops.gemm(a, b, majors=majors, out_dtype=out_dtype))


def test_gemm_bf16_cuda_refuses_float16_and_mixed_operands(cuda):
    a, b, acc = _buffers("I/I/K", 64, 64, 64, cuda)
    kernels.reset_launches()
    with pytest.raises(TypeError, match="float16"):
        ops.gemm(a.half(), b.half())
    with pytest.raises(TypeError, match="one dtype"):
        ops.gemm(a, b.float())
    with pytest.raises(TypeError, match="float16"):
        ops.gemm_panel(a, b, acc.half(), 0)
    assert kernels.gemm_bf16_cuda.launches == 0 and kernels.gemm_panel_bf16_cuda.launches == 0


def _decode_inputs(B, Hq, G, S, T, dtype, device, lens, start=None, seed=20):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Hq, S, 96), device=device, generator=g).to(dtype)
    kc = torch.randn((B, G, T, 96), device=device, generator=g).to(dtype)
    vc = torch.randn((B, G, T, 64), device=device, generator=g).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    pos = None
    if start is not None:
        start = torch.tensor(start, dtype=torch.int32, device=device)
        pos = start[:, None] + torch.arange(S, dtype=torch.int32, device=device)[None, :]
    return q, kc, vc, lens, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["step", "chunk", "T_not_divided"])
def test_flash_decode_cuda_at_96_64_matches_plain_version(cuda, case, dtype):
    """MLA's widths, q/k of 96 and v of 64 (MHA, 8 heads): a decode step
    with an idle slot (every split merged by the kernel), a prefill chunk
    (one split, 64-row tiles, an idle slot), and a cache that 128-key blocks
    do not divide; the output is (B, Hq, S, 64)."""
    dims, lens, start, block = {
        "step": ((4, 8, 8, 1, 1024), (1, 700, 1024, 0), None, 128),
        "chunk": ((4, 8, 8, 96, 1024), (95, 400, 300, 0), (0, 304, 204, 0), 512),
        "T_not_divided": ((3, 8, 8, 1, 1000), (1000, 999, 130), None, 128),
    }[case]
    q, kc, vc, lens, pos = _decode_inputs(*dims, dtype, cuda, lens, start)
    before = fd.flash_decode_cuda.launches
    got = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=block)
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches == before + 1
    assert got.shape == (dims[0], dims[1], dims[3], 64)
    want = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=block, impl="ref")
    torch.testing.assert_close(got, want, rtol=DECODE_TOL[dtype], atol=DECODE_TOL[dtype])
    assert torch.equal(got, ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=block))


def test_flash_decode_cuda_refuses_a_pair_without_an_instance(cuda):
    q, kc, vc, lens, _ = _decode_inputs(2, 4, 4, 1, 256, torch.bfloat16, cuda, (10, 20))
    with pytest.raises(ValueError, match=r"\(D, Dv\)"):
        ops.flash_decode(q[..., :64], kc[..., :64].contiguous(), vc[..., :32].contiguous(), lens)


def test_flash_decode_smem_bytes_at_96_64(cuda):
    """The library's plan at (96, 64) is the wrapper's formula (q and K of
    two 64-column boxes, a ring stage as large as a K tile, V's float32
    tile one 64-column box, the float32 K/V tile 96 wide), above the
    (64, 64) plan and below the (128, 128) one; its largest plans launch
    and agree with the plain version."""
    lib = fd.load_library()
    for tr in (1, 4):
        for bk in (32, 128, 300, 512, 1024):
            assert lib.flash_decode_smem_bytes(96, tr, bk, 64) == fd.smem_bytes(96, tr, bk, 64)
            assert (lib.flash_decode_smem_bytes(64, tr, bk, 64)
                    < lib.flash_decode_smem_bytes(96, tr, bk, 64)
                    <= lib.flash_decode_smem_bytes(128, tr, bk, 128))
    assert lib.flash_decode_smem_bytes(64, 1, 512, 96) == -1
    for dtype in (torch.float32, torch.bfloat16):
        # GQA 4 x 16 queries: 64 rows, the 64-row tile at 512-key blocks
        q, kc, vc, lens, pos = _decode_inputs(2, 8, 2, 16, 2048, dtype, cuda, (2048, 1500),
                                              start=(2032, 1484), seed=6)
        got = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=512)
        torch.cuda.synchronize()
        want = ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=512, impl="ref")
        torch.testing.assert_close(got, want, rtol=DECODE_TOL[dtype], atol=DECODE_TOL[dtype])
