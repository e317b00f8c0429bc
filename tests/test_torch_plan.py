"""The port's comm plans (``repro_torch.core.plan``), the twin of
``tests/test_plan.py``: the intent table and the constructors' checks, and
each plan kind's executor (where it issues and where it waits each transfer,
and that its blocking interpretation folds the same values).

The reference's ``test_plan_vs_hlo_agreement`` proves overlap from XLA's
compiled program and has no twin: the port runs eagerly.  Its agreement
helper does: the port's plans run with every issue, wait and compute
recorded, each transfer counts as overlapped when a compute runs inside its
issue/wait window, and the reference's own ``plan_agreement`` must find the
port's declared intent in those verdicts.  Nothing here needs ranks: the
transfers are :class:`Pending` objects over local values.
"""
import dataclasses

import pytest

from repro_torch.core import Pending
from repro_torch.core import plan as tplan

KINDS = ["ring", "halo", "pipeline", "stagger", "dispatch", "bucket"]


def _done(value) -> Pending:
    """A transfer that has already landed ``value``."""
    return Pending(lambda: value)


def test_intent_table_and_constructor_validation():
    """The reference's table, kind by kind, and its constructors' refusals."""
    from repro.core import plan as jplan

    for kind in KINDS:
        assert tplan.intent_of(kind) == jplan.intent_of(kind), kind
    assert tplan.intent_of("ring") == "overlapped"
    assert tplan.intent_of("halo") == "overlapped"
    assert tplan.intent_of("pipeline") == "serialized"
    with pytest.raises(ValueError):
        tplan.intent_of("tree")

    xfer = lambda s, k: None  # noqa: E731
    comp = lambda c, s, k: c  # noqa: E731
    assert tplan.ring(3, transfer=xfer, compute=comp).intent == "overlapped"
    assert tplan.halo(transfer=xfer, compute=comp).intent == "overlapped"
    assert tplan.pipeline(2, transfer=xfer, compute=comp).intent == "serialized"
    assert tplan.halo(transfer=xfer, compute=comp).steps == 1
    with pytest.raises(ValueError):
        tplan.CommPlan("tree", 2, xfer, comp)  # unknown kind
    with pytest.raises(ValueError):
        tplan.ring(0, transfer=xfer, compute=comp)  # needs >= 1 step


def test_ring_executor_issue_wait_placement_and_identity():
    """Double-buffered issues step k's transfer BEFORE its compute, blocking
    starts and waits back to back at the completion point, and both fold
    the same values (every compute sees the pre-transfer state)."""
    trace: list = []

    def transfer(state, s):
        trace.append(("xfer", s))
        return _done(state + 1.0)

    def compute(carry, state, s):
        trace.append(("comp", s))
        return carry + state

    plan = tplan.ring(4, transfer=transfer, compute=compute,
                      epilogue=lambda carry, state: (carry, state))
    carry_db, state_db = plan.run(0.0, 0.0)
    order_db = list(trace)
    trace.clear()
    carry_bl, state_bl = plan.run(0.0, 0.0, double_buffer=False)
    order_bl = list(trace)

    # state visits 0, 1, 2, 3 -> carry = 6; the final state is 3 (both modes)
    assert carry_db == 6.0 == carry_bl
    assert state_db == 3.0 == state_bl
    assert order_db == [("xfer", 0), ("comp", 0), ("xfer", 1), ("comp", 1),
                        ("xfer", 2), ("comp", 2), ("comp", 3)]
    assert order_bl == [("comp", 0), ("xfer", 0), ("comp", 1), ("xfer", 1),
                        ("comp", 2), ("xfer", 2), ("comp", 3)]


def test_pipeline_and_halo_executor_semantics():
    """A pipeline ships the freshly computed carry (compute -> transfer ->
    compute); a halo makes one exchange, overlapped with the interior
    compute when double-buffered, and waited first when blocking."""
    shipped: list = []

    def transfer(carry, s):
        shipped.append(carry)
        return _done(carry * 2.0)

    plan = tplan.pipeline(3, transfer=transfer, compute=lambda c, state, s: c + state)
    # s0: c = 0 + 1 = 1, state = 2; s1: c = 1 + 2 = 3, state = 6; s2: c = 3 + 6 = 9
    assert plan.run(1.0, 0.0) == 9.0
    assert shipped == [1.0, 3.0]

    h = tplan.halo(transfer=lambda s, k: _done(s * 10.0), compute=lambda c, s, k: c + s,
                   epilogue=lambda c, s: (c, s))
    assert h.run(2.0, 1.0) == (3.0, 20.0)
    # blocking waits first, so the compute sees the exchanged state
    assert h.run(2.0, 1.0, double_buffer=False) == (21.0, 20.0)


def test_transfer_must_return_pending():
    bad = tplan.ring(2, transfer=lambda s, k: s,  # the blocking form, not *_start
                     compute=lambda c, s, k: c)
    with pytest.raises(TypeError, match="Pending"):
        bad.run(0.0, 0.0)


def _verdicts(plan, state, carry, *, double_buffer=True) -> list[str]:
    """Run ``plan`` with every issue, wait and compute recorded; each
    transfer's verdict is ``"overlapped"`` when a compute ran inside its
    issue/wait window, else ``"serialized"``."""
    events: list = []

    def transfer(value, s):
        n = sum(1 for e in events if e[0] == "issue")
        events.append(("issue", n))
        inner = plan.transfer(value, s)

        class Recorded(Pending):
            def wait(self2):
                events.append(("wait", n))
                return inner.wait()

        return Recorded(lambda: None)

    def compute(*args):
        events.append(("compute",))
        return plan.compute(*args)

    dataclasses.replace(plan, transfer=transfer, compute=compute).run(
        state, carry, double_buffer=double_buffer)
    out = []
    for n in range(sum(1 for e in events if e[0] == "issue")):
        window = events[events.index(("issue", n)):events.index(("wait", n))]
        out.append("overlapped" if ("compute",) in window else "serialized")
    return out


def _agreement(verdicts, declared, kind="collective-permute"):
    """The reference's ``plan_agreement`` on the recorded verdicts."""
    from repro.launch.hlo_walk import CollectiveClass, HloStats, plan_agreement

    st = HloStats()
    for n, verdict in enumerate(verdicts):
        st.collectives.append(CollectiveClass(computation="%e", var=f"%t{n}", bytes=4, mult=1.0,
                                              classification=verdict, kind=kind))
    return plan_agreement(st, declared)


def test_plan_agreement_helper():
    """The double-buffered ring and halo prove the overlap they declare, the
    pipeline (the negative control) proves serialized, and a wrongly
    declared intent is caught: the blocking ring's transfers sit on the
    compute chain."""
    shift = lambda s, k: _done(s + 1.0)  # noqa: E731
    fold = lambda c, s, k: c + s  # noqa: E731
    ring = tplan.ring(4, transfer=shift, compute=fold)
    row = _agreement(_verdicts(ring, 0.0, 0.0), ring.intent)
    assert row == {"declared": "overlapped", "proven": "overlapped", "agree": True,
                   "serialized": 0, "overlapped": 3}
    blocking = _agreement(_verdicts(ring, 0.0, 0.0, double_buffer=False), ring.intent)
    assert blocking["proven"] == "serialized" and not blocking["agree"]

    halo = tplan.halo(transfer=shift, compute=fold)
    assert _agreement(_verdicts(halo, 0.0, 0.0), halo.intent)["agree"]
    pipe = tplan.pipeline(4, transfer=lambda c, k: _done(c * 2.0), compute=fold)
    row = _agreement(_verdicts(pipe, 1.0, 0.0), pipe.intent)
    assert row["agree"] and row["proven"] == "serialized" and row["serialized"] == 3
    assert not _agreement(_verdicts(pipe, 1.0, 0.0), "overlapped")["agree"]
    with pytest.raises(ValueError):
        _agreement([], "maybe")


def test_stagger_executor_round_robin_issue_wait_placement():
    """Double-buffered issues EVERY step's transfer before any wait (the
    whole wave in flight) and hands back the requests for the caller to
    wait; blocking completes each step before the next begins, and its
    requests come back completed.  The results are identical: the steps
    share no state.  A stagger plan takes no epilogue."""
    assert tplan.intent_of("stagger") == "overlapped"
    trace: list = []

    def transfer(v, s):
        trace.append(("xfer", s))

        class Traced(Pending):
            def wait(self2):
                if not self2._done:
                    trace.append(("wait", s))
                return Pending.wait(self2)

        return Traced(lambda: v * 10)

    def compute(carry, state, s):
        trace.append(("comp", s))
        return s + 1

    plan = tplan.stagger(3, transfer=transfer, compute=compute)
    pends = plan.run(None, None)
    assert not any(p._done for p in pends)
    done_db = [p.wait() for p in pends]
    order_db = list(trace)
    trace.clear()
    pends = plan.run(None, None, double_buffer=False)
    assert all(p._done for p in pends)
    done_bl = [p.wait() for p in pends]
    order_bl = list(trace)

    assert done_db == [10, 20, 30] == done_bl
    assert order_db == [("comp", 0), ("xfer", 0), ("comp", 1), ("xfer", 1),
                        ("comp", 2), ("xfer", 2),
                        ("wait", 0), ("wait", 1), ("wait", 2)]
    assert order_bl == [("comp", 0), ("xfer", 0), ("wait", 0),
                        ("comp", 1), ("xfer", 1), ("wait", 1),
                        ("comp", 2), ("xfer", 2), ("wait", 2)]
    with pytest.raises(ValueError, match="stagger plan has no epilogue"):
        tplan.CommPlan("stagger", 2, transfer, compute, epilogue=lambda d, s: d)


def test_bucket_plan_intent_and_validation():
    assert tplan.intent_of("bucket") == "overlapped"
    xfer = lambda s, k: None  # noqa: E731
    comp = lambda g, a, k: a  # noqa: E731
    comb = lambda r, k: None  # noqa: E731
    red = lambda arrived: None  # noqa: E731
    assert tplan.bucket(3, transfer=xfer, reduce=red, compute=comp,
                        combine=comb).intent == "overlapped"
    # a bucket plan without its all-gather return leg is a declaration bug
    with pytest.raises(ValueError, match="bucket plan needs a combine stage"):
        tplan.CommPlan("bucket", 2, xfer, comp, reduce=red)
    # the cross-step reduce barrier only exists in the bucket schedule
    with pytest.raises(ValueError, match="reduce stage is bucket-plan only"):
        tplan.CommPlan("stagger", 2, xfer, comp, reduce=red)


def test_bucket_executor_issue_wait_placement_and_identity():
    """The ZeRO bucket schedule: double-buffered puts EVERY bucket's
    reduce-scatter in flight before any wait, runs the one cross-bucket
    reduce (which waits each bucket, once, where it first reads it), then
    each bucket's compute, then issues every all-gather before
    waiting; blocking starts and waits each leg back to back through the
    same issue path.  The folded values are identical."""
    trace: list = []

    def traced(value, tag, s):
        class Traced(Pending):
            def wait(self2):
                trace.append((tag, s))
                return Pending.wait(self2)

        return Traced(lambda: value)

    def transfer(state, s):
        trace.append(("xfer", s))
        return traced(s + 1, "xwait", s)

    def reduce(arrived):
        trace.append(("reduce",))
        return sum(arrived)  # sees every bucket's shard

    def compute(gval, arrived_s, s):
        trace.append(("comp", s))
        return 100 * gval + arrived_s

    def combine(result, s):
        trace.append(("cissue", s))
        return traced(result, "cwait", s)

    plan = tplan.bucket(3, transfer=transfer, reduce=reduce, compute=compute, combine=combine)
    done_db = plan.run(None, None)
    order_db = list(trace)
    trace.clear()
    done_bl = plan.run(None, None, double_buffer=False)
    order_bl = list(trace)

    # arrived = [1, 2, 3] -> gval = 6 -> results [601, 602, 603], both modes
    assert done_db == [601, 602, 603] == done_bl
    # the reduce stage waits each bucket where it first reads it, in order
    assert order_db == [
        ("xfer", 0), ("xfer", 1), ("xfer", 2),
        ("reduce",),
        ("xwait", 0), ("xwait", 1), ("xwait", 2),
        ("comp", 0), ("comp", 1), ("comp", 2),
        ("cissue", 0), ("cissue", 1), ("cissue", 2),
        ("cwait", 0), ("cwait", 1), ("cwait", 2),
    ]
    assert order_bl == [
        ("xfer", 0), ("xwait", 0), ("xfer", 1), ("xwait", 1),
        ("xfer", 2), ("xwait", 2),
        ("reduce",),
        ("comp", 0), ("cissue", 0), ("cwait", 0),
        ("comp", 1), ("cissue", 1), ("cwait", 1),
        ("comp", 2), ("cissue", 2), ("cwait", 2),
    ]
