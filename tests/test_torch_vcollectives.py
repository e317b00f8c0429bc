"""The port's all-to-all, ragged all-gather and ragged all-to-all against
the reference package: ``MPI_Alltoall`` as the reshard, ``MPI_Allgatherv``
on a line and over a 2x2 grid (full, and partial along one grid dim),
``MPI_Alltoallv`` on a line and along one grid dim, each with an empty
block in the split extents, and the round trips back.

Both sides run :func:`_torch_dist.vcollective_cases` on the same inputs:
the reference once on 4 fake JAX devices, the port as 4 gloo processes.
Every case is pure data movement, so results are compared bitwise, and the
extents tables must be equal.
"""
import pickle

import numpy as np
import pytest

from _torch_dist import TESTS, run_gloo

_REFERENCE = """
import importlib, pickle, sys
import numpy as np
sys.path.insert(0, {tests!r})
import repro.core as C
from _torch_dist import vcollective_cases

def tile_of(d):
    lead = d.data.shape[:len(d.rank_dims)]
    return [np.asarray(d.data[idx]) for idx in np.ndindex(*lead)]

out = vcollective_cases(np, importlib.import_module("repro.core.layout"), C,
                        C.make_mesh((4,), ("r",)), C.make_mesh((2, 2), ("rows", "cols")),
                        np.asarray, tile_of)
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

CASES = ["all_to_all", ("all_to_all", "start")] + [
    (kind, name) for kind in ("all_gatherv_bag", "all_gatherv_dist") for name in ("col", "row")
] + [(kind, name) for kind in ("all_to_allv", "all_to_allv_back")
     for name in ("balanced", "zeros")] + [
    ("all_gatherv_grid", "ik"), ("all_gatherv_grid", "ki"), "all_gatherv_grid_partial"] + [
    (kind, name) for kind in ("all_to_allv_grid", "all_to_allv_grid_back")
    for name in ("balanced", "zeros")]


def _extents_key(case):
    if isinstance(case, tuple):
        return (case[0] + "_extents",) + case[1:]
    return case + "_extents"


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_vcollectives") / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_gloo("vcollectives_family", 4, tmp_path_factory.mktemp("gloo_vcollectives"))


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else c)
def test_vcollective_matches_reference(reference, port, case):
    want = reference[case]
    for rank in range(4):
        # bags the collective replicates (all_gatherv_bag) are one array
        expected = want if isinstance(want, np.ndarray) else want[rank]
        np.testing.assert_array_equal(port[rank][case], expected)
        key = _extents_key(case)
        if key in reference:
            assert port[rank][key] == reference[key]


def test_zero_split_extents_leave_empty_tiles(port):
    """Ranks whose split extent is 0 receive nothing: a tile of zeros."""
    for rank in (1, 3):
        assert not port[rank][("all_to_allv", "zeros")].any()


def test_ill_typed_calls_are_refused(port):
    for rank in range(4):
        assert port[rank]["refused"] == [True, True, True]
