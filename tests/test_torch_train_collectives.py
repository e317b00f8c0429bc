"""The training collectives on 2 and 4 gloo ranks against a numpy
sum-and-slice oracle: ``shard_reduce_scatterv_start`` (``MPI_Ireduce_scatter``
of flat padded buckets, ragged and zero extents, a tensor and a tuple),
``shard_all_gatherv_start`` (``MPI_Iallgatherv`` of capacity shards) and
``shard_reduce_scatter_start`` along either axis.  The values are
integer-valued floats, so every sum is exact in any order and the results
are held bitwise; ill-fitting tables raise ``LayoutError`` before any data
moves.  On one rank each is the identity, handing back its input."""
import numpy as np
import pytest
import torch

import repro_torch.core as C
from _torch_dist import run_gloo, train_collective_inputs


@pytest.mark.parametrize("world", [2, 4])
def test_training_collectives_match_numpy_oracle(world, tmp_path):
    ranks = run_gloo("train_collectives_family", world, tmp_path)
    ins = train_collective_inputs(np, world)
    cap = ins["flat"].shape[1] // world
    total, total2 = ins["flat"].sum(0), ins["flat2"].sum(0)
    gathered = ins["shards"].reshape(-1)
    dense = ins["dense"].sum(0)  # (3, world * 2, 4)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rsv"], total[r * cap:(r + 1) * cap])
        assert got["rsv_input_kept"]
        np.testing.assert_array_equal(got["rsv_tuple"][0], total[r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(got["rsv_tuple"][1], total2[r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(got["agv"], gathered)
        np.testing.assert_array_equal(got[("rs", 1)], dense[:, r * 2:(r + 1) * 2])
        np.testing.assert_array_equal(got[("rs", 0)],
                                      dense.transpose(1, 0, 2)[r * 2:(r + 1) * 2])
        assert got["refused"] == [True, True, True, True]
        # a zero extent: that rank's slice of the sum is the zero pad
        for e, start in zip(ins["extents"], range(0, world * cap, cap)):
            if e == 0:
                assert not total[start:start + cap].any()


def test_one_rank_collectives_hand_back_their_input():
    class _Mesh:  # what the shard-level forms read of a mesh of one rank
        shape, axis_names = {"data": 1}, ("data",)

        def create_groups(self, axes):
            pass

        def coords(self):
            return {"data": 0}

        def group(self, axes):
            return None

        def members(self, axes):
            return (0,)

    x = torch.arange(6.0)
    mesh = _Mesh()
    assert C.shard_reduce_scatterv_start(x, "data", extents=(5,), mesh=mesh).wait() is x
    assert C.shard_all_gatherv_start(x, "data", extents=(6,), mesh=mesh).wait() is x
    assert C.shard_reduce_scatter_start(x, "data", mesh=mesh).wait() is x
