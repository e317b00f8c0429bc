"""The non-blocking collective laws of ``tests/test_collective_properties.py``
on the port, held bitwise against the reference package.

Both sides run :func:`_torch_dist.collective_properties` on the same seeded
case lists (:func:`_torch_dist.collective_property_cases`): the reference
once on 4 fake JAX devices, the port as one job of 4 gloo processes.  The
reference draws its cases from a property search over communicators of 2,
4 and 8 ranks; here every case runs on 4 ranks.  The laws, checked in both
packages:

* ``*_start(...).wait()`` is bitwise the blocking collective for the
  all-reduce (every op) and the all-gather, and the all-gather equals the
  root gather (``tests/test_collective_properties.py:57``);
* likewise for the reduce-scatter (every op) and the all-to-all (``:93``);
* three in-flight requests of different kinds (all-reduce, reduce-scatter,
  ring shift) complete to the same buffers in any order, and through
  ``wait_all`` (``:127``).

Each blocking result is also held against the reference's, rank by rank,
bitwise: the values are integers, so a sum over the ranks is exact in any
order.
"""
import pickle

import numpy as np
import pytest

from _torch_dist import TESTS, collective_property_cases, run_gloo

_REFERENCE = """
import importlib, pickle, sys
import numpy as np
sys.path.insert(0, {tests!r})
import repro.core as C
from _torch_dist import collective_properties, collective_property_cases

def views(d):
    out = {{}}
    for (r,) in np.ndindex(*d.grid_shape):
        t = d.tile(r)
        out[d.flat_rank((r,))] = (np.asarray(t.data),
                                  (tuple((a.name, a.size) for a in t.layout.axes),
                                   tuple(t.layout.dim_map)))
    return out

out = collective_properties(np, importlib.import_module("repro.core.layout"), C,
                            C.make_mesh((4,), ("r",)), views, collective_property_cases())
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

CASES = collective_property_cases()


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_collective_properties") / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_gloo("collective_properties_family", 4,
                    tmp_path_factory.mktemp("gloo_collective_properties"), timeout=240,
                    cases=CASES)


def _same_as_reference(port, reference, key) -> None:
    for rank, out in enumerate(port):
        got = out[key]
        for r, (data, sig) in got.items():
            want_data, want_sig = reference[key][r]
            assert sig == want_sig, (key, rank)
            np.testing.assert_array_equal(data, want_data, err_msg=str((key, rank)))


@pytest.mark.parametrize("case", CASES["start_wait"], ids=str)
def test_start_wait_bit_identical_to_blocking(reference, port, case):
    assert reference[("start_wait", case, "law")]
    assert all(out[("start_wait", case, "law")] for out in port)
    for kind in ("all_reduce", "all_gather"):
        _same_as_reference(port, reference, (kind, case))


@pytest.mark.parametrize("case", CASES["rs_a2a"], ids=str)
def test_reduce_scatter_and_all_to_all_start_wait(reference, port, case):
    assert reference[("rs_a2a", case, "law")]
    assert all(out[("rs_a2a", case, "law")] for out in port)
    for kind in ("reduce_scatter", "all_to_all"):
        _same_as_reference(port, reference, (kind, case))


@pytest.mark.parametrize("case", CASES["wait_all"], ids=str)
def test_wait_all_order_independence(reference, port, case):
    assert reference[("wait_all", case, "law")]
    assert all(out[("wait_all", case, "law")] for out in port)
    for rank, out in enumerate(port):
        for got, want in zip(out[("wait_all", case)], reference[("wait_all", case)]):
            for r, (data, sig) in got.items():
                assert sig == want[r][1], (case, rank)
                np.testing.assert_array_equal(data, want[r][0], err_msg=str((case, rank)))
