"""The generic non-blocking request object (``MPI_Request`` analogue).

Every collective of the comm layer has a ``*_start`` twin that issues the
relayout-fused data movement with ``torch.distributed``'s ``async_op=True``
form and hands back a :class:`Pending`, whose :meth:`~Pending.wait` is the
completion point.  The blocking collectives are literally
``*_start(...).wait()`` — one issue/complete code path, so the two forms are
bit-identical by construction.

A :class:`Pending` holds the :class:`torch.distributed.Work` handles of the
issued operations and a *finisher*: the receive-side step that turns the
landed buffers into the result (the unpack relayout, the extents table of a
ragged bag, a division for a mean).  ``wait`` completes the handles — on a
CUDA backend that orders the current stream after the transfer, without a
host sync — then runs the finisher once.

Correspondence table:

=========================  ====================================================
MPI                        repro_torch.core
=========================  ====================================================
``MPI_Request``            :class:`Pending`
``MPI_Wait``               :meth:`Pending.wait`
``MPI_Waitall``            :func:`wait_all`
``MPI_Isend``/``Irecv``    ``p2p.ring_shift_start`` / ``p2p.permute_start``
``MPI_Ireduce_scatter``    ``collectives.reduce_scatter_start``
``Ireduce_scatter`` (v)    ``collectives.reduce_scatterv_start``
``MPI_Send_init`` /        ``plan.ring`` and the other plan kinds
``MPI_Recv_init``          (declare a whole schedule once, no data moves)
``MPI_Start``/``MPI_Wait`` ``plan.CommPlan.run`` — the planner places the
                           issue (before each step's compute) and the wait
                           (after it); ``double_buffer=False`` degenerates
                           to start+wait back-to-back, bit-identically
=========================  ====================================================
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

__all__ = ["Pending", "wait_all", "set_observer"]

# The walk observing this process's requests (``repro_torch.launch.op_walk``),
# ``None`` unless one runs: each :class:`Pending` reports its issue
# (``observer.issued(pending, works)``) and its completion
# (``observer.waited(pending)``).  A process that runs no walk pays one
# ``is None`` test per request.
_OBSERVER = None


def set_observer(observer):
    """Make ``observer`` (or ``None``) the one that sees every request's
    issue and completion; returns the one it replaces."""
    global _OBSERVER
    previous, _OBSERVER = _OBSERVER, observer
    return previous


class Pending:
    """An in-flight operation: the request-object analogue of ``MPI_Request``.

    ``works`` are the ``torch.distributed.Work`` handles the issue returned
    (empty when nothing had to cross a process boundary); ``finish`` builds
    the result from the landed buffers.  :meth:`wait` may be called more than
    once and returns the same result each time.
    """

    def __init__(self, finish: Callable[[], Any], works: Sequence[Any] = (), *,
                 op: str = "collective"):
        self.op = op
        self._works = tuple(works)
        self._finish = finish
        self._result: Any = None
        self._done = False
        if _OBSERVER is not None:
            _OBSERVER.issued(self, self._works)

    def wait(self):
        """Complete the operation (``MPI_Wait``) and hand back its result
        (a ``DistBag`` or ``Bag``, as issued)."""
        if not self._done:
            if _OBSERVER is not None:
                _OBSERVER.waited(self)
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._done = True
            self._works = ()
        return self._result


def wait_all(*pending: Pending):
    """Complete one or more pending operations (``MPI_Wait``/``MPI_Waitall``).

    Returns the completed result for a single request, a tuple of them for
    several.  Completion order is irrelevant: each request owns its own
    buffers, so ``wait_all(p1, p2)`` and ``(p1.wait(), p2.wait())`` are
    bit-identical.
    """
    from .dims import LayoutError

    if not pending:
        raise LayoutError("wait_all() needs at least one Pending request")
    done = tuple(p.wait() for p in pending)
    return done[0] if len(done) == 1 else done
