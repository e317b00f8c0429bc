"""The distributed GEMM slice: the port on 4 gloo processes against the
reference package on 4 fake JAX devices, on identical seeded inputs.

Each side runs as one batch: the reference in one subprocess of the
``distributed`` fixture, the port as one spawn of 4 gloo ranks.  Per
configuration:

* scattered input tiles are bitwise equal (pure data movement);
* C agrees within ``rtol=atol=1e-5`` (float32 products summed in another
  order);
* the port's double-buffered ring equals its blocking ring bitwise;
* every rank ends with the same C (the gathered root is replicated).
"""
import pickle

import numpy as np
import pytest

from _torch_dist import LAYOUT_CONFIGS, run_gloo
from repro_torch.examples.distributed_gemm import comm_volume_model

DIMS_1D = (16, 12, 8)
DIMS_SUMMA = (16, 12, 8)
DIMS_RAGGED = (35, 35, 35)
GRID = (2, 2)
WORLD = 4

COMM_CASES = {
    "panel1d": dict(algo="panel1d", ni=16, nj=12, nk=8, ranks=4),
    "summa_2x2": dict(algo="summa2d", ni=16, nj=12, nk=8, grid=(2, 2)),
    "ragged_2x2": dict(algo="summa2d", ni=35, nj=35, nk=35, grid=(2, 2), ragged=True),
    "ragged_extralarge_2x4": dict(algo="summa2d", ni=2049, nj=2561, nk=1409, grid=(2, 4),
                                  ragged=True),
}

_REFERENCE = """
import pickle
import numpy as np
from examples.distributed_gemm import (
    _mat_layout, comm_volume_model, ragged_summa_program, run_distributed_gemm,
    run_ragged_summa_gemm, run_summa_gemm, summa_ring_program)
from repro.core import bag, make_mesh, mpi_traverser, scatter, scatterv_bag, traverser
from repro.core.layout import into_blocks

CONFIGS, D1, DS, DR, GRID, OUT, COMM = {args!r}
R, Cc = GRID
world = R * Cc
mesh1 = make_mesh((world,), ("r",))
out = {{"comm": {{name: comm_volume_model(**kw) for name, kw in COMM.items()}}}}
coords = [(r, c) for r in range(R) for c in range(Cc)]

def glob(meta, seed, ni, nj, nk):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((ni, nk)).astype(np.float32)
    B = rng.standard_normal((nk, nj)).astype(np.float32)
    A_g = bag(meta["A_layout"], A if meta["A_layout"].axis_names == ("i", "k") else A.T)
    B_g = bag(meta["B_layout"], B if meta["B_layout"].axis_names == ("k", "j") else B.T)
    return A_g, B_g

for m in CONFIGS:
    ni, nj, nk = D1
    out[("panel1d", m)] = run_distributed_gemm(ni=ni, nj=nj, nk=nk, majors=m, ranks=world,
                                               mesh=mesh1)[0]
    a_major = m.split("/")[1]
    A = np.random.default_rng(7).standard_normal((ni, nk)).astype(np.float32)
    A_l = _mat_layout("i", "k", ni, nk, "i" if a_major == "I" else "k")
    A_root = bag(A_l ^ into_blocks("i", "R", num_blocks=world), A if a_major == "I" else A.T)
    dt = mpi_traverser("R", traverser(A_root), mesh1)
    A_tile = _mat_layout("i", "k", ni // world, nk, "i" if a_major == "I" else "k")
    d = scatter(A_root, A_tile, dt)
    out[("tile_a", "panel1d", m)] = [np.asarray(d.tile(r).data) for r in range(world)]

    ni, nj, nk = DS
    for db in (True, False):
        out[("summa", m, db)] = run_summa_gemm(ni=ni, nj=nj, nk=nk, grid=GRID, majors=m,
                                               double_buffer=db)[0]
    _, meta = summa_ring_program(ni=ni, nj=nj, nk=nk, grid=GRID, majors=m)
    A_g, B_g = glob(meta, 11, ni, nj, nk)
    a = scatter(bag(meta["A_root_l"], A_g.data), meta["A_tile"], meta["dtA"])
    b = scatter(bag(meta["B_root_l"], B_g.data), meta["B_tile"], meta["dtB"])
    out[("tile_a", "summa", m)] = [np.asarray(a.data[rc]) for rc in coords]
    out[("tile_b", "summa", m)] = [np.asarray(b.data[rc]) for rc in coords]

    ni, nj, nk = DR
    for db in (True, False):
        out[("ragged", m, db)] = run_ragged_summa_gemm(ni=ni, nj=nj, nk=nk, grid=GRID, majors=m,
                                                       double_buffer=db)[0]
    _, meta = ragged_summa_program(ni=ni, nj=nj, nk=nk, grid=GRID, majors=m)
    A_g, B_g = glob(meta, 13, ni, nj, nk)
    a = scatterv_bag(A_g, meta["A_tile"], meta["dtA"], meta["A_ragged"])
    b = scatterv_bag(B_g, meta["B_tile"], meta["dtB"], meta["B_ragged"])
    out[("tile_a", "ragged", m)] = [np.asarray(a.data[rc]) for rc in coords]
    out[("valid_a", "ragged", m)] = [np.asarray(a.tile(rc).data) for rc in coords]
    out[("tile_b", "ragged", m)] = [np.asarray(b.data[rc]) for rc in coords]

with open(OUT, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_gemm") / "reference.pkl")
    args = (LAYOUT_CONFIGS, DIMS_1D, DIMS_SUMMA, DIMS_RAGGED, GRID, path, COMM_CASES)
    assert "OK" in distributed(_REFERENCE.format(args=args), devices=WORLD, timeout=600)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_gloo("gemm_family", WORLD, tmp_path_factory.mktemp("gloo_gemm"),
                    dims_1d=DIMS_1D, dims_summa=DIMS_SUMMA, dims_ragged=DIMS_RAGGED, grid=GRID)


def _check_c(port, key, want):
    for rank in range(WORLD):
        np.testing.assert_allclose(port[rank][key], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(port[rank][key], port[0][key])


@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_panel1d_gemm_matches_reference(reference, port, majors):
    _check_c(port, ("panel1d", majors), reference[("panel1d", majors)])
    for rank in range(WORLD):
        np.testing.assert_array_equal(port[rank][("tile_a", "panel1d", majors)],
                                      reference[("tile_a", "panel1d", majors)][rank])


@pytest.mark.parametrize("algo", ["summa", "ragged"])
@pytest.mark.parametrize("majors", LAYOUT_CONFIGS)
def test_summa_gemm_matches_reference(reference, port, algo, majors):
    """Dense SUMMA at dims dividing the 2x2 grid, ragged SUMMA at 35 (no dim
    divides it): tiles bitwise, C to 1e-5, double-buffered == blocking."""
    for db in (True, False):
        _check_c(port, (algo, majors, db), reference[(algo, majors, db)])
    for rank in range(WORLD):
        assert port[rank]["coords"] == divmod(rank, GRID[1])  # row-major grid
        np.testing.assert_array_equal(port[rank][(algo, majors, True)],
                                      port[rank][(algo, majors, False)])
        for operand in ("tile_a", "tile_b") + (("valid_a",) if algo == "ragged" else ()):
            np.testing.assert_array_equal(port[rank][(operand, algo, majors)],
                                          reference[(operand, algo, majors)][rank])


@pytest.mark.parametrize("case", sorted(COMM_CASES))
def test_comm_volume_model_matches_reference(reference, case):
    assert comm_volume_model(**COMM_CASES[case]) == reference["comm"][case]
