"""The port's collectives beyond the GEMM's own use of them, against the
reference package: reduce-scatter in every op, the ragged reduce-scatter in
add/max/min (padding re-zeroed), permute with a rank that receives nothing,
a ragged ring shift, gatherv, a relayouting broadcast, all-gather into
another receive layout (per rank too, and along one grid dim), all-reduce
into another tile layout, and the shard-level all-reduce on tuples and on
an axis of one rank (the reference's inside ``shard_map``).

Both sides run :func:`_torch_dist.collective_cases` on the same seeded
inputs: the reference once on 4 fake JAX devices, the port as 4 gloo
processes.  Results are compared bitwise: every case is pure data movement
or a reduction over two ranks, whose sum does not depend on the order, or
a sum of integer values, exact in any order.
Extents tables must be equal.
"""
import pickle

import numpy as np
import pytest

from _torch_dist import TESTS, run_gloo

_REFERENCE = """
import importlib, pickle, sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import repro.core as C
from repro.core.compat import shard_map
from repro.core.p2p import shard_all_reduce_start
from _torch_dist import SHARD_REDUCE_AXES, collective_cases, shard_reduce_inputs

def tile_of(d):
    lead = d.data.shape[:len(d.rank_dims)]
    return [np.asarray(d.data[idx]) for idx in np.ndindex(*lead)]

grid = C.make_mesh((2, 2), ("rows", "cols"))
out = collective_cases(np, importlib.import_module("repro.core.layout"), C,
                       C.make_mesh((4,), ("r",)), grid, np.asarray, tile_of)
meshes = {{"grid": grid, "line": C.make_mesh((4, 1), ("r", "one"))}}
for case, arrays in shard_reduce_inputs(np).items():
    mesh, axis = SHARD_REDUCE_AXES[case]
    spec = P(meshes[mesh].axis_names)  # the 4 ranks row-major over the mesh
    leaves = arrays if isinstance(arrays, tuple) else (arrays,)
    fn = shard_map(lambda *xs: shard_all_reduce_start(xs, axis).wait(), mesh=meshes[mesh],
                   in_specs=(spec,) * len(leaves), out_specs=(spec,) * len(leaves))
    for i, leaf in enumerate(fn(*leaves)):
        out[("shard_all_reduce", case, i)] = list(np.asarray(leaf))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

CASES = [("reduce_scatter", op) for op in ("add", "mean", "max", "min")] + [
    ("reduce_scatterv", op) for op in ("add", "max", "min")
] + ["permute", "ring_shift", "gatherv", "broadcast", "all_gather_bag",
      ("all_gather_dist", "per_rank"), ("all_gather_dist", "Ri")] + [
    ("all_reduce", "Ck", op) for op in ("add", "max", "mean")] + [("all_reduce", "R", "add")] + [
    ("shard_all_reduce", case, i) for case, n in (("tuple_cols", 2), ("r", 1), ("one", 2))
    for i in range(n)]
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


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else c)
def test_collective_matches_reference(reference, port, case):
    want = reference[case]
    for rank in range(4):
        # bags the collective replicates (gatherv, broadcast) are one array
        expected = want if isinstance(want, np.ndarray) else want[rank]
        np.testing.assert_array_equal(port[rank][case], expected)
        if case in EXTENTS:
            assert port[rank][EXTENTS[case]] == reference[EXTENTS[case]]
