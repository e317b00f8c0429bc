"""The port's ``send_recv`` and the p2p ring laws against the reference
package, and the refusal of collectives on heterogeneous bags.

Both sides run :func:`_torch_dist.p2p_cases` on the same inputs: the
reference once on 4 fake JAX devices, the port as 4 gloo processes.  Every
case is pure data movement, so results are compared bitwise: each rank's
tile in the layout it keeps, that layout's axes, the per-rank
``tile_layouts`` table and the extents table.  The cases:

* ``send_recv`` with a receiver layout that differs from the sender's
  (``tests/test_p2p.py:5``), with untouched bystanders (``:46``), to itself,
  with no declared layout, along one dim of a 2x2 grid, and on a ragged bag
  (the receiver adopts the sender's extents, bystanders keep theirs);
* the refusals of ``tests/test_p2p.py:219``/``:231`` and of a bag that
  already carries ``tile_layouts``;
* the ring laws of ``tests/test_p2p_properties.py`` (inverse identity,
  endpoint relayout commutes with the transfer, for ring shifts and a
  partial permute) over a fixed list of seeded cases, in one gloo job;
* ``tests/test_p2p.py``'s ring and permute tests over seeded shifts and
  pair lists (:func:`_torch_dist.p2p_twin_cases`), in the same job:
  ``ring_shift_start`` against the blocking shift with a relayout and
  ``wait`` over two requests (``:86``), the ring shift with a relayout
  delivering rank ``r - shift``'s relaid tile (``:121``), the partial
  permute's zero fill (``:148``) and the ring along one dim of the 2x2
  grid (``:173``).

Port only: every bag collective issued on a heterogeneous bag raises
``LayoutError`` on every rank before any transfer (the gloo job's timeout
catches a rank left waiting), and the per-rank all-gather records its
table as the reference's does.
"""
import pickle

import numpy as np
import pytest

from _torch_dist import TESTS, p2p_property_cases, p2p_twin_cases, run_gloo

_REFERENCE = """
import importlib, pickle, sys
import numpy as np
sys.path.insert(0, {tests!r})
import repro.core as C
from _torch_dist import p2p_cases, p2p_twin_cases, p2p_twins

def views(d):
    out = {{}}
    for coords in np.ndindex(*d.grid_shape):
        t = d.tile(coords if len(coords) > 1 else coords[0])
        out[d.flat_rank(coords)] = (np.asarray(t.data),
                                    (tuple((a.name, a.size) for a in t.layout.axes),
                                     tuple(t.layout.dim_map)))
    return out

L = importlib.import_module("repro.core.layout")
mesh1, mesh2 = C.make_mesh((4,), ("r",)), C.make_mesh((2, 2), ("rows", "cols"))
out = p2p_cases(np, L, C, mesh1, mesh2, views, lambda r: True)
out.update(p2p_twins(np, L, C, mesh1, mesh2, views, lambda r: True, p2p_twin_cases()))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

SEND_RECV = [("send_recv", 2, 1), ("send_recv", 1, 3), ("send_recv", 2, 2), ("send_recv", 0, 3),
             ("send_recv", "same"), ("send_recv", "grid"), ("send_recv", "ragged"),
             ("send_recv", "ragged_back")]
TABLES = [c + ("table",) for c in SEND_RECV[:6]] + [c + ("kept",) for c in SEND_RECV[:4]] + [
    ("send_recv", "ragged", "extents"), ("send_recv", "ragged_back", "extents")]
REFUSALS = ["index_space", "duplicate_dst", "out_of_range", "hetero_send_recv"]
LAWS = p2p_property_cases()
TWINS = p2p_twin_cases()
HETERO = ["gather", "all_gather", "all_reduce", "reduce_scatter", "all_to_all", "permute",
          "ring_shift", "send_recv"]


@pytest.fixture(scope="module")
def reference(distributed, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_p2p") / "reference.pkl")
    assert "OK" in distributed(_REFERENCE.format(tests=TESTS, path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_gloo("p2p_family", 4, tmp_path_factory.mktemp("gloo_p2p"), timeout=240)


def _same_views(got: dict, want: dict, what) -> None:
    for r, (data, sig) in got.items():
        w_data, w_sig = want[r]
        assert sig == w_sig, (what, r)
        assert data.dtype == w_data.dtype and data.shape == w_data.shape, (what, r)
        np.testing.assert_array_equal(data, w_data, err_msg=f"{what} rank {r}")


@pytest.mark.parametrize("case", SEND_RECV, ids=lambda c: "-".join(map(str, c)))
def test_send_recv_matches_reference_bitwise(reference, port, case):
    for rank in range(4):
        assert port[rank]["me"] == [rank]
        _same_views(port[rank][case], reference[case], case)


@pytest.mark.parametrize("case", TABLES, ids=lambda c: "-".join(map(str, c)))
def test_send_recv_tables_match_reference(reference, port, case):
    for rank in range(4):
        assert port[rank][case] == reference[case], (case, rank)


def test_send_recv_keeps_the_receivers_layout_and_bystanders(port, reference):
    """Rank 1 holds rank 2's tile packed into its declared layout (the
    transpose of the source's); every other rank's buffer is the one it
    had, bit for bit, in the source layout."""
    got = {r: port[r][("send_recv", 2, 1)][r] for r in range(4)}
    before = port[2][("send_recv", 1, 3)][2]  # a bystander there too
    assert got[1][1][0] == (("i", 8), ("j", 2))
    for r in (0, 2, 3):
        assert got[r][1][0] == (("j", 2), ("i", 8))
    np.testing.assert_array_equal(got[1][0], got[2][0].T)
    np.testing.assert_array_equal(got[2][0], before[0])
    assert reference[("send_recv", 2, 1, "table")][1] != reference[("send_recv", 2, 1, "table")][0]


@pytest.mark.parametrize("name", REFUSALS)
def test_p2p_refusals_match_reference(reference, port, name):
    assert reference[("refuse", name)] is True
    for rank in range(4):
        assert port[rank][("refuse", name)] is True, rank


@pytest.mark.parametrize("case", LAWS, ids=lambda c: "-".join(map(str, c)))
def test_ring_laws_hold_and_match_reference(reference, port, case):
    assert reference[("ring_law", case, "holds")]
    for rank in range(4):
        assert port[rank][("ring_law", case, "holds")], rank
        _same_views(port[rank][("ring_law", case)], reference[("ring_law", case)], case)
        _same_views(port[rank][("ring_law", case, "permute")],
                    reference[("ring_law", case, "permute")], case)


@pytest.mark.parametrize("name", HETERO)
def test_collective_on_heterogeneous_bag_raises_on_every_rank(port, name):
    for rank in range(4):
        assert port[rank][("hetero_refused", name)] is True, rank


def test_per_rank_all_gather_records_its_layout_table(port):
    for rank in range(4):
        assert port[rank]["all_gather_table"] == (True, True, True), rank


@pytest.mark.parametrize("shift", TWINS["start"])
def test_ring_shift_start_wait_matches_blocking_and_reference(reference, port, shift):
    assert reference[("start", shift, "law")] is True
    for rank in range(4):
        assert port[rank][("start", shift, "law")] is True, rank
        _same_views(port[rank][("start", shift)], reference[("start", shift)], shift)


@pytest.mark.parametrize("shift", TWINS["relayout"])
def test_ring_shift_with_relayout_delivers_the_rotated_tiles(reference, port, shift):
    """Rank r holds rank (r - shift)'s tile in the destination layout: in
    the reference (every rank's view) and on every gloo rank."""
    want_src = reference[("relayout", "src")]
    for rank in range(4):
        src = (rank - shift) % 4
        got = port[rank][("relayout", shift)][rank]
        assert got[1][0] == (("i", 4), ("j", 4))  # the destination layout: j-major
        np.testing.assert_array_equal(reference[("relayout", shift)][rank][0], want_src[src])
        np.testing.assert_array_equal(got[0], port[src][("relayout", "src")][src])
        _same_views(port[rank][("relayout", shift)], reference[("relayout", shift)], shift)


@pytest.mark.parametrize("pairs", TWINS["partial"], ids=str)
def test_partial_permute_zero_fills_unsent_ranks(reference, port, pairs):
    senders = {d: s for s, d in pairs}
    for rank in range(4):
        got = port[rank][("partial", pairs)][rank][0]
        if rank in senders:
            s = senders[rank]
            np.testing.assert_array_equal(got, port[s][("partial", "src")][s][0])
        else:
            assert not got.any(), (pairs, rank)
        _same_views(port[rank][("partial", pairs)], reference[("partial", pairs)], pairs)


@pytest.mark.parametrize("shift,dim", TWINS["grid"], ids=str)
def test_grid_ring_along_one_axis_matches_reference(reference, port, shift, dim):
    """On the 2x2 grid (flat rank = 2 row + col) a shift along one dim
    moves tiles inside that dim's sub-communicators alone."""
    for rank in range(4):
        r, c = divmod(rank, 2)
        src = 2 * ((r - shift) % 2) + c if dim == "Ri" else 2 * r + (c - shift) % 2
        got = port[rank][("grid", shift, dim)][rank][0]
        np.testing.assert_array_equal(got, port[src][("grid", "src")][src][0])
        _same_views(port[rank][("grid", shift, dim)], reference[("grid", shift, dim)],
                    (shift, dim))
        assert port[rank][("grid", "sub")] == reference[("grid", "sub")] == (("Cj",), 2)
