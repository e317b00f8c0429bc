"""The ragged all-to-all laws of ``tests/test_vcollective_properties.py``
on the port, held bitwise against
the reference package (the file's other laws:
``tests/test_torch_vcollective_properties.py``, whose helpers this file
shares).  Every case runs on 4 ranks, the reference's on 4 fake JAX
devices, the port's as one job of 4 gloo processes:

* the ragged all-to-all j-ragged -> i-ragged -> j-ragged is the identity,
  tiles and extents, and its start form the blocking one
  (``tests/test_vcollective_properties.py:121``);
* adversarial counts (all rows to one destination, zero-count holes,
  exact capacity): the padding never enters a valid tile, and the round
  trip holds (``:247``).
"""
import pytest

from test_torch_vcollective_properties import (CASES, _laws_hold, _same_views, run_port,
                                               run_reference)

KINDS = ("a2av", "imbalance")


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    return run_reference(distributed, tmp_path_factory, KINDS)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port(tmp_path_factory, KINDS)


@pytest.mark.parametrize("case", CASES["a2av"], ids=str)
def test_all_to_allv_round_trip_matches_reference(reference, port, case):
    key = ("a2av", case)
    _laws_hold(port, reference, key)
    for rank, out in enumerate(port):
        _same_views(out[key], reference[key], (key, rank))
        assert out[key + ("extents",)] == reference[key + ("extents",)], (key, rank)


@pytest.mark.parametrize("case", CASES["imbalance"], ids=str)
def test_all_to_allv_adversarial_imbalance_matches_reference(reference, port, case):
    key = ("imbalance", case)
    _laws_hold(port, reference, key)
    for rank, out in enumerate(port):
        _same_views(out[key], reference[key], (key, rank))
        assert out[key + ("extents",)] == reference[key + ("extents",)], (key, rank)
