"""The port's layout algebra against the reference package, in one process.

The same layouts are built in both packages: their axes, index spaces and
offsets must agree, relayout plans must have equal fields and
``transfer_kind``, and relayout output must be bitwise equal (pure data
movement, so no tolerance).  Cases follow ``test_layout.py`` and
``test_relayout.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hyp import given, settings, st  # real hypothesis when installed, shim otherwise

# the packages re-export functions named like their modules (``bag``,
# ``relayout``), so take the modules themselves from the import system
jbag, jdims, jlayout, jrelayout = (importlib.import_module(f"repro.core.{m}")
                                   for m in ("bag", "dims", "layout", "relayout"))
tbag, tdims, tlayout, trelayout = (importlib.import_module(f"repro_torch.core.{m}")
                                   for m in ("bag", "dims", "layout", "relayout"))


def col(L, n, m):
    return L.scalar(np.float32) ^ L.vector("i", n) ^ L.vector("j", m)


def row(L, n, m):
    return L.scalar(np.float32) ^ L.vector("j", m) ^ L.vector("i", n)


def _sig(layout):
    return (
        np.dtype(layout.dtype),
        tuple((a.name, a.size) for a in layout.axes),
        layout.dim_map,
    )


def _states(space):
    dims = list(space)
    for flat in range(int(np.prod(list(space.values())))):
        state, rem = {}, flat
        for d in dims:
            state[d] = rem % space[d]
            rem //= space[d]
        yield state


LAYOUT_CASES = {
    "col_major": lambda L: col(L, 6, 4),
    "row_major": lambda L: row(L, 6, 4),
    "vectors": lambda L: L.scalar(np.int32) ^ L.vectors("i", "j")(6, 4),
    "into_blocks": lambda L: col(L, 6, 4) ^ L.into_blocks("i", "I", block_size=3),
    "merge_blocks": lambda L: col(L, 6, 4) ^ L.into_blocks("i", "I", block_size=3)
    ^ L.merge_blocks("I", "j", "r"),
    "blocked": lambda L: col(L, 6, 4) ^ L.blocked("i", "It", block_size=3),
    "hoist": lambda L: col(L, 6, 4) ^ L.hoist("i"),
    "reorder_rename": lambda L: col(L, 6, 4) ^ L.reorder("i", "j") ^ L.rename("i", "row"),
    "set_length": lambda L: L.scalar(np.float32) ^ L.vector("i", 6) ^ L.vector("r", None)
    ^ L.set_length("r", 8),
    "three_dims": lambda L: L.scalar(np.int8) ^ L.vector("i", 3) ^ L.vector("j", 4)
    ^ L.vector("k", 2),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_construction_matches_reference(case):
    """Same axes, dim map, index space and offset of every state."""
    j, t = LAYOUT_CASES[case](jlayout), LAYOUT_CASES[case](tlayout)
    assert _sig(t) == _sig(j)
    assert t.index_space() == j.index_space()
    assert t.default_order() == j.default_order()
    for state in _states(j.index_space()):
        assert t.offset(state) == j.offset(state)


LAYOUT_ERRORS = {
    "into_blocks_divisibility": lambda L: col(L, 6, 4) ^ L.into_blocks("i", "I", block_size=4),
    "duplicate_dim": lambda L: col(L, 6, 4) ^ L.vector("i", 3),
    "rename_collision": lambda L: col(L, 6, 4) ^ L.reorder("i", "j") ^ L.rename("i", "j"),
    "open_shape": lambda L: (L.scalar(np.float32) ^ L.vector("r", None)).shape,
}


@pytest.mark.parametrize("case", sorted(LAYOUT_ERRORS))
def test_layout_errors_match_reference(case):
    with pytest.raises(jdims.LayoutError):
        LAYOUT_ERRORS[case](jlayout)
    with pytest.raises(tdims.LayoutError):
        LAYOUT_ERRORS[case](tlayout)


@pytest.mark.parametrize("total,parts", [(35, 2), (35, 4), (2049, 2), (1409, 4), (8, 8)])
def test_ragged_split_matches_reference(total, parts):
    assert tdims.ragged_split(total, parts) == jdims.ragged_split(total, parts)


@pytest.mark.parametrize("a,b", [([64], [8, 8]), ([4, 16], [8, 8]), ([6, 4], [3, 8])])
def test_common_refinement_matches_reference(a, b):
    try:
        want = jdims.common_refinement(a, b)
    except jdims.LayoutError:
        with pytest.raises(tdims.LayoutError):
            tdims.common_refinement(a, b)
        return
    assert tdims.common_refinement(a, b) == want


RELAYOUT_PAIRS = {
    "contiguous": (lambda L: col(L, 6, 4), lambda L: col(L, 6, 4)),
    "hvector": (lambda L: col(L, 6, 4), lambda L: row(L, 6, 4)),
    "hindexed": (lambda L: col(L, 6, 4) ^ L.blocked("i", "I", 3), lambda L: row(L, 6, 4)),
    "hindexed_gather": (lambda L: col(L, 6, 4) ^ L.blocked("i", "I", 3),
                        lambda L: col(L, 6, 4) ^ L.blocked("i", "I", 2)),
    "blocked_both": (lambda L: col(L, 6, 4) ^ L.blocked("i", "I", 3),
                     lambda L: row(L, 6, 4) ^ L.blocked("j", "J", 2)),
    "gather_renamed": (lambda L: col(L, 6, 4) ^ L.blocked("i", "I", 3),
                       lambda L: col(L, 6, 4) ^ L.blocked("i", "I2", 2)),
    "roundtrip_hoisted": (lambda L: col(L, 8, 4) ^ L.blocked("i", "I", 2),
                          lambda L: row(L, 8, 4) ^ L.blocked("j", "J", 2) ^ L.hoist("i")),
    **{
        f"gather_{s}_{d}": (lambda L, s=s: col(L, 12, 4) ^ L.blocked("i", "I", s),
                            lambda L, d=d: col(L, 12, 4) ^ L.blocked("i", "I", d))
        for s, d in [(3, 2), (2, 3), (4, 3), (3, 4)]
    },
}


def _check_relayout_parity(src_j, dst_j, src_t, dst_t):
    pj = jrelayout.relayout_plan(src_j, dst_j)
    pt = trelayout.relayout_plan(src_t, dst_t)
    for field in ("src_shape", "refined_shape", "perm", "dst_shape", "kind"):
        assert getattr(pt, field) == getattr(pj, field), field
    assert (pt.gather_perm is None) == (pj.gather_perm is None)
    if pj.gather_perm is not None:
        np.testing.assert_array_equal(pt.gather_perm, pj.gather_perm)
    assert trelayout.transfer_kind(src_t, dst_t) == jrelayout.transfer_kind(src_j, dst_j)
    n = int(np.prod(src_j.shape))
    data = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    out_j = jbag.bag(src_j, jnp.asarray(data)).to_layout(dst_j).data
    out_t = tbag.bag(src_t, torch.from_numpy(data)).to_layout(dst_t).data
    assert out_t.is_contiguous()
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))  # bitwise


@pytest.mark.parametrize("case", sorted(RELAYOUT_PAIRS))
def test_relayout_plan_and_output_match_reference(case):
    src_fn, dst_fn = RELAYOUT_PAIRS[case]
    _check_relayout_parity(src_fn(jlayout), dst_fn(jlayout), src_fn(tlayout), dst_fn(tlayout))


@pytest.mark.parametrize("case", ["extents", "dims", "dtype"])
def test_relayout_type_safety_matches_reference(case):
    def bad_dst(L):
        if case == "extents":
            return col(L, 4, 6)
        if case == "dims":
            return L.scalar(np.float32) ^ L.vector("i", 6) ^ L.vector("k", 4)
        return L.scalar(np.float64) ^ L.vector("i", 6) ^ L.vector("j", 4)

    with pytest.raises(jdims.LayoutError):
        jrelayout.relayout_plan(col(jlayout, 6, 4), bad_dst(jlayout))
    with pytest.raises(tdims.LayoutError):
        trelayout.relayout_plan(col(tlayout, 6, 4), bad_dst(tlayout))


@st.composite
def layout_pairs(draw):
    """Random (orientation, blocking, hoist) pairs, as in test_relayout.py,
    drawn once and built in both packages."""
    n = draw(st.sampled_from([4, 6, 8, 12]))
    m = draw(st.sampled_from([2, 4, 6]))

    def recipe():
        return (draw(st.booleans()),
                draw(st.sampled_from([None] + [d for d in (2, 3, 4) if n % d == 0])),
                draw(st.booleans()))

    return n, m, recipe(), recipe()


def _build(L, n, m, recipe):
    is_col, bs, hoisted = recipe
    layout = col(L, n, m) if is_col else row(L, n, m)
    if bs is not None:
        layout = layout ^ L.blocked("i", "I", bs)
    if hoisted:
        layout = layout ^ L.hoist("j")
    return layout


@given(layout_pairs())
@settings(max_examples=40, deadline=None)
def test_relayout_property_matches_reference(pair):
    n, m, rs, rd = pair
    _check_relayout_parity(_build(jlayout, n, m, rs), _build(jlayout, n, m, rd),
                           _build(tlayout, n, m, rs), _build(tlayout, n, m, rd))


def test_bag_access_and_valid_view_match_reference():
    """Logical element access through a blocked, hoisted layout and the
    ragged valid view agree with the reference bag."""
    data = np.arange(48, dtype=np.float32)
    lj = col(jlayout, 8, 6) ^ jlayout.hoist("i")
    lt = col(tlayout, 8, 6) ^ tlayout.hoist("i")
    bj, bt = jbag.bag(lj, jnp.asarray(data)), tbag.bag(lt, torch.from_numpy(data))
    for state in _states(lj.index_space()):
        assert float(bt[state]) == float(bj[state])
    vj, vt = bj.valid_view({"i": 5, "j": 3}), bt.valid_view({"i": 5, "j": 3})
    assert _sig(vt.layout) == _sig(vj.layout)
    np.testing.assert_array_equal(vt.data.numpy(), np.asarray(vj.data))
    set_t = bt.at({"i": 2, "j": 1}).set(-1.0)
    set_j = bj.at({"i": 2, "j": 1}).set(-1.0)
    np.testing.assert_array_equal(set_t.data.numpy(), np.asarray(set_j.data))
    np.testing.assert_array_equal(bt.data.numpy(), data.reshape(lt.shape))  # functional


def test_bag_from_numpy_reads_physical_order():
    """A reference bag's numpy buffer becomes the same port bag."""
    lj = row(jlayout, 5, 3) ^ jlayout.hoist("j")
    lt = row(tlayout, 5, 3) ^ tlayout.hoist("j")
    bj = jbag.bag(lj, jnp.arange(15, dtype=jnp.float32))
    bt = tbag.bag_from_numpy(lt, np.asarray(bj.data), "cpu")
    assert bt.data.dtype == tlayout.torch_dtype(lt.dtype) == torch.float32
    for state in _states(lj.index_space()):
        assert float(bt[state]) == float(bj[state])
    # a transposed host view is copied into the layout's physical order
    A = np.arange(15, dtype=np.float32).reshape(5, 3)
    bt = tbag.bag_from_numpy(col(tlayout, 5, 3), A.T, "cpu")
    assert bt.data.is_contiguous()
    np.testing.assert_array_equal(bt.data.numpy(), A.T)
