"""The port's collectives beyond the GEMM's own use of them, against the
reference package: reduce-scatter in every op, the ragged reduce-scatter in
add/max/min (padding re-zeroed), permute with a rank that receives nothing,
a ragged ring shift, gatherv and a relayouting broadcast.

Both sides run :func:`_torch_dist.collective_cases` on the same seeded
inputs: the reference once on 4 fake JAX devices, the port as 4 gloo
processes.  Results are compared bitwise: every case is pure data movement
or a reduction over two ranks, whose sum does not depend on the order.
Extents tables must be equal.
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
from _torch_dist import collective_cases

def tile_of(d):
    lead = d.data.shape[:len(d.rank_dims)]
    return [np.asarray(d.data[idx]) for idx in np.ndindex(*lead)]

out = collective_cases(np, importlib.import_module("repro.core.layout"), C,
                       C.make_mesh((4,), ("r",)), C.make_mesh((2, 2), ("rows", "cols")),
                       np.asarray, tile_of)
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

CASES = [("reduce_scatter", op) for op in ("add", "mean", "max", "min")] + [
    ("reduce_scatterv", op) for op in ("add", "max", "min")
] + ["permute", "ring_shift", "gatherv", "broadcast"]
EXTENTS = {("reduce_scatterv", op): ("reduce_scatterv_extents", op) for op in ("add", "max", "min")}
EXTENTS.update(permute="permute_extents", ring_shift="ring_shift_extents")


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_collectives") / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_gloo("collectives_family", 4, tmp_path_factory.mktemp("gloo_collectives"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c) if isinstance(c, tuple) else c)
def test_collective_matches_reference(reference, port, case):
    want = reference[case]
    for rank in range(4):
        # bags the collective replicates (gatherv, broadcast) are one array
        expected = want if isinstance(want, np.ndarray) else want[rank]
        np.testing.assert_array_equal(port[rank][case], expected)
        if case in EXTENTS:
            assert port[rank][EXTENTS[case]] == reference[EXTENTS[case]]
