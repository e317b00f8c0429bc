"""The port's tiled transpose against the reference's, on the CPU.

``ops.transpose_tiled`` takes the plain version on CPU tensors; the
reference runs its Pallas kernel in interpret mode with 16 x 16 tiles.  The
transpose only moves data, so the results are compared bitwise, and both
packages refuse the same shapes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import ref

RNG_SEED = 0
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX/numpy array, as integers."""
    a = x.view(torch.int16) if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("shape", [(64, 32), (3, 64, 32), (2, 2, 32, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_transpose_tiled_matches_reference_bitwise(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(RNG_SEED)
    if dtype == "int32":
        x = rng.integers(0, 100, shape).astype(np.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    want = jops.transpose_tiled(jnp.asarray(x, jdt), impl="interpret", bm=16, bn=16)
    got = ops.transpose_tiled(torch.from_numpy(x).to(tdt), bm=16, bn=16)
    assert got.shape == want.shape and got.dtype == tdt and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape,tile", [((48, 32), (32, 32)), ((32, 40), (16, 16)),
                                        ((2, 300, 256), (256, 256)), ((512, 260), (256, 256))])
def test_transpose_tiled_refuses_what_the_reference_refuses(shape, tile):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="must divide tile"):
        jops.transpose_tiled(jnp.asarray(x), impl="interpret", bm=tile[0], bn=tile[1])
    with pytest.raises(ValueError, match="must divide tile"):
        ops.transpose_tiled(torch.from_numpy(x), bm=tile[0], bn=tile[1])


@pytest.mark.parametrize("shape", [(100, 50), (7, 256, 512), (1, 3)])
def test_transpose_tiled_takes_tiles_clipped_to_the_shape(shape):
    """Axes shorter than the tile clip it (``min(bm, M)``), as in the
    reference; every element size moves bit for bit."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jops.transpose_tiled(jnp.asarray(x), impl="interpret"))
    for t in (torch.from_numpy(x), torch.from_numpy(x).double(), torch.from_numpy(x).half(),
              torch.from_numpy(x > 0), torch.from_numpy(x).to(torch.int8)):
        got = ops.transpose_tiled(t)
        assert torch.equal(got, t.transpose(-1, -2))
    np.testing.assert_array_equal(_bits(ops.transpose_tiled(torch.from_numpy(x))), _bits(want))


def test_transpose_ref_is_contiguous():
    x = torch.arange(24).reshape(2, 3, 4)
    y = ref.transpose_ref(x)
    assert y.is_contiguous() and torch.equal(y, x.transpose(1, 2))
    with pytest.raises(ValueError, match="impl"):
        ops.transpose_tiled(x, impl="pallas")
