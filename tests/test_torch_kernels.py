"""The port's GEMM kernels: plain versions against the reference, and the
kernels' contracts.

On the CPU the port's ops run their plain PyTorch versions; they are held
against the reference's Pallas kernels in interpret mode on the same numpy
inputs, in all 8 majors, with ``acc`` and every panel block.  Tolerance
``rtol=atol=1e-5``: both sides take float32 products, summed in different
orders.  The CUDA kernels themselves are tested in
``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops

LAYOUT_CONFIGS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]
M, N, K, NB = 16, 24, 8, 3


def _buffers(majors, m, n, k, *, seed=0, nb=1):
    """Random A, B and a C-orientation accumulator/panel as numpy buffers."""
    c_major, a_major, b_major = majors.split("/")
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, m) if a_major == "K" else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if b_major == "J" else (k, n)).astype(np.float32)
    c = rng.standard_normal((nb * n, m) if c_major == "J" else (m, nb * n)).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_ref_matches_reference_kernel(majors, with_acc):
    a, b, acc = _buffers(majors, M, N, K)
    acc = acc if with_acc else None
    want = jops.gemm(jnp.asarray(a), jnp.asarray(b), None if acc is None else jnp.asarray(acc),
                     majors=majors, impl="interpret")
    got = tops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                    None if acc is None else torch.from_numpy(acc), majors=majors)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jb", range(NB))
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_gemm_panel_ref_matches_reference_kernel(majors, jb):
    """panel[j-block jb] += A @ B in place; the other blocks are untouched
    bitwise, and a device-tensor jb gives the same result as an int."""
    a, b, panel = _buffers(majors, M, N, K, nb=NB)
    want = np.asarray(jops.gemm_panel(jnp.asarray(a), jnp.asarray(b), jnp.asarray(panel), jb,
                                      majors=majors, impl="interpret"))
    for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32)):
        p = torch.from_numpy(panel.copy())
        got = tops.gemm_panel(torch.from_numpy(a), torch.from_numpy(b), p, jb_arg, majors=majors)
        assert got is p  # updated in place
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        c_trans = majors.startswith("J")
        keep = np.ones(panel.shape, bool)
        if c_trans:
            keep[jb * N:(jb + 1) * N, :] = False
        else:
            keep[:, jb * N:(jb + 1) * N] = False
        np.testing.assert_array_equal(got.numpy()[keep], panel[keep])


@pytest.mark.parametrize("majors", ["I/I/K", "J/K/J"])
def test_gemm_takes_edge_tiles_the_reference_kernel_refuses(majors):
    """The reference kernel needs dims that divide its 256 blocks (so the
    ragged SUMMA's capacity tiles, e.g. 1025 rows, cannot reach it); the port
    takes any M, N, K."""
    m, n, k = 300, 24, 8
    a, b, _ = _buffers(majors, m, n, k)
    with pytest.raises(ValueError, match="must divide block"):
        jops.gemm(jnp.asarray(a), jnp.asarray(b), majors=majors, impl="interpret")
    got = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), majors=majors)
    al = a.T if majors.split("/")[1] == "K" else a
    bl = b.T if majors.split("/")[2] == "J" else b
    want = (al.astype(np.float64) @ bl.astype(np.float64))
    want = want.T if majors.startswith("J") else want
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


CONTRACT_CASES = {
    "contraction": lambda mod, x: mod.gemm(x(np.zeros((4, 5))), x(np.zeros((6, 3)))),
    "acc_shape": lambda mod, x: mod.gemm(x(np.zeros((4, 5))), x(np.zeros((5, 3))),
                                         x(np.zeros((3, 4)))),
    "panel_rows": lambda mod, x: mod.gemm_panel(x(np.zeros((4, 5))), x(np.zeros((5, 3))),
                                                x(np.zeros((5, 6))), 0),
    "panel_blocks": lambda mod, x: mod.gemm_panel(x(np.zeros((4, 5))), x(np.zeros((5, 3))),
                                                  x(np.zeros((4, 7))), 0),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_value_error_contracts_match_reference(case):
    f32 = np.float32
    with pytest.raises(ValueError):
        CONTRACT_CASES[case](_Interpret(jops), lambda z: jnp.asarray(z, f32))
    with pytest.raises(ValueError):
        CONTRACT_CASES[case](tops, lambda z: torch.as_tensor(z, dtype=torch.float32))


class _Interpret:
    """The reference ops with the interpreted Pallas kernels."""

    def __init__(self, mod):
        self._mod = mod

    def gemm(self, *args, **kw):
        return self._mod.gemm(*args, impl="interpret", **kw)

    def gemm_panel(self, *args, **kw):
        return self._mod.gemm_panel(*args, impl="interpret", **kw)


def test_cuda_impl_refuses_cpu_tensors_without_fallback():
    """A kernel launch on CPU tensors raises instead of computing the plain
    version."""
    a = torch.zeros(4, 5)
    b = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.gemm(a, b, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.gemm_panel(a, b, torch.zeros(4, 6), 1, impl="cuda")
    assert tgemm.gemm_cuda.launches == 0 and tgemm.gemm_panel_cuda.launches == 0


def test_ops_refuse_strided_buffers():
    """A buffer is its layout's physical order: a transposed view is refused
    by both implementations rather than read in the wrong order."""
    a = torch.zeros(5, 4).T
    b = torch.zeros(5, 3)
    for impl in ("ref", "cuda"):
        with pytest.raises(ValueError, match="contiguous"):
            tops.gemm(a, b, impl=impl)
        with pytest.raises(ValueError, match="contiguous"):
            tops.gemm_panel(a, b, torch.zeros(4, 6), 0, impl=impl)
