"""The ragged v-collective laws of ``tests/test_vcollective_properties.py``
on the port, held bitwise against the reference package.

Both sides run :func:`_torch_dist.vcollective_properties` on the same seeded
case lists (:func:`_torch_dist.vcollective_property_cases`): the reference
once on 4 fake JAX devices, the port as one job of 4 gloo processes; the
all-to-all laws run in
``tests/test_torch_vcollective_properties_a2av.py``, so that the two
files' reference runs spread over the workers.  The
reference draws its cases from a property search over communicators of 2,
4 and 8 ranks; here every case runs on 4 ranks.  The laws, checked in both
packages:

* pad/mask invariance: scatterv -> gatherv is a bitwise round trip for a
  random counts table and any root, tile and gather-back layout, every
  slot's padding is exactly zero, ``all_gatherv`` equals the gatherv root
  and its start form the blocking one (``tests/test_vcollective_properties.py:68``);
* the ragged all-to-all j-ragged -> i-ragged -> j-ragged is the identity,
  tiles and extents, and its start form the blocking one (``:121``);
* the ragged max/min reduce-scatter equals the numpy oracle over
  sign-mixed data with its output padding re-zeroed, the reduce identity
  table, and the dense max/min reduce-scatter (``:161``);
* adversarial counts through the ragged all-to-all (all rows to one
  destination, zero-count holes, exact capacity): the padding never enters
  a valid tile, and the round trip holds (``:247``);
* a dense all-reduce, a ragged all-gather, a ragged all-to-all and a
  ragged ring shift in flight together complete to the same buffers in
  any order and through ``wait_all`` (``:315``).

Each result (valid tiles and layout signatures, replicated roots, extents
tables) is also held against the reference's, rank by rank, bitwise.
"""
import pickle

import numpy as np
import pytest

from _torch_dist import TESTS, run_gloo, vcollective_property_cases

_REFERENCE = """
import importlib, pickle, sys
import numpy as np
import jax
sys.path.insert(0, {tests!r})
import repro.core as C
from _torch_dist import vcollective_properties, vcollective_property_cases

L = importlib.import_module("repro.core.layout")
dt = C.mpi_traverser("R", C.traverser(L.scalar(np.float32) ^ L.vector("R", 4)),
                     C.make_mesh((4,), ("r",)))

def views(d):
    out = {{}}
    for (r,) in np.ndindex(*d.grid_shape):
        t = d.tile(r)
        out[d.flat_rank((r,))] = (np.asarray(t.data),
                                  (tuple((a.name, a.size) for a in t.layout.axes),
                                   tuple(t.layout.dim_map)))
    return out

def raw(d):
    return {{r: np.asarray(d.data[r]) for r in range(d.comm_size)}}

def make_dist(buf, layout):
    return C.DistBag(jax.device_put(buf, C.dist_sharding(dt, layout)), layout, dt, ("R",))

cases = {{k: v for k, v in vcollective_property_cases().items() if k in {kinds!r}}}
out = vcollective_properties(np, L, C, dt, views, raw, lambda b: np.asarray(b.data), make_dist,
                             cases)
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

CASES = vcollective_property_cases()
KINDS = ("pad_mask", "rs_max_min", "wait_all")  # the all-to-all laws: the _a2av file


def run_reference(distributed, tmp_path_factory, kinds) -> dict:
    """The reference's results of the ``kinds`` cases on 4 fake JAX devices."""
    path = str(tmp_path_factory.mktemp("jax_vcollective_properties") / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, path=path, kinds=tuple(kinds)),
                               devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


def run_port(tmp_path_factory, kinds) -> list:
    """Every gloo rank's results of the ``kinds`` cases (one job of 4)."""
    return run_gloo("vcollective_properties_family", 4,
                    tmp_path_factory.mktemp("gloo_vcollective_properties"), timeout=240,
                    cases={k: CASES[k] for k in kinds})


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    return run_reference(distributed, tmp_path_factory, KINDS)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port(tmp_path_factory, KINDS)


def _same_views(got: dict, want: dict, what) -> None:
    for r, (data, sig) in got.items():
        want_data, want_sig = want[r]
        assert sig == want_sig, (what, r)
        assert data.dtype == want_data.dtype and data.shape == want_data.shape, (what, r)
        np.testing.assert_array_equal(data, want_data, err_msg=str((what, r)))


def _laws_hold(port, reference, key) -> None:
    assert reference[key + ("law",)] is True, key
    for rank, out in enumerate(port):
        assert out[key + ("law",)] is True, (key, rank)


@pytest.mark.parametrize("case", CASES["pad_mask"], ids=str)
def test_scatterv_gatherv_pad_mask_invariance_matches_reference(reference, port, case):
    key = ("pad_mask", case)
    _laws_hold(port, reference, key)
    for rank, out in enumerate(port):
        _same_views(out[key], reference[key], (key, rank))
        assert out[key + ("extents",)] == reference[key + ("extents",)]
        np.testing.assert_array_equal(out[key + ("root",)], reference[key + ("root",)])


@pytest.mark.parametrize("case", CASES["rs_max_min"], ids=str)
def test_reduce_scatterv_max_min_identity_matches_reference(reference, port, case):
    key = ("rs_max_min", case)
    _laws_hold(port, reference, key)
    for rank, out in enumerate(port):
        _same_views(out[key], reference[key], (key, rank))


@pytest.mark.parametrize("op", ["max", "min"])
def test_dense_reduce_scatter_max_min_matches_reference(reference, port, op):
    key = ("rs_dense", op)
    _laws_hold(port, reference, key)
    for rank, out in enumerate(port):
        _same_views(out[key], reference[key], (key, rank))


def test_reduce_identity_table_matches_reference(reference, port):
    want = reference["reduce_identity"]
    assert want == [0.0, 0, -np.inf, np.inf, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    assert reference["reduce_identity_bool_refused"] is True
    for rank, out in enumerate(port):
        assert out["reduce_identity"] == want, rank
        assert out["reduce_identity_bool_refused"] is True, rank


@pytest.mark.parametrize("case", CASES["wait_all"], ids=str)
def test_wait_all_with_v_collectives_matches_reference(reference, port, case):
    key = ("wait_all", case)
    _laws_hold(port, reference, key)
    for rank, out in enumerate(port):
        for i, (got, want) in enumerate(zip(out[key], reference[key], strict=True)):
            _same_views(got, want, (key, i, rank))
