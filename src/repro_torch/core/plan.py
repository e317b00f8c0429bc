"""Comm plans: declarative communication schedules over :class:`Pending`.

Three algorithms in this repo (SUMMA, ragged SUMMA, sp_ring attention) used
to hand-write the same double-buffered rotation — issue the transfer for
step ``k+1`` before step ``k``'s compute, wait for it after.  A
:class:`CommPlan` declares that schedule *once*: the algorithm provides the
stage callbacks (``transfer``/``compute``/``epilogue``) and the planner
emits the double-buffered program.  The blocking interpretation
(``double_buffer=False``) runs ``transfer(...).wait()`` at the completion
point — the same issue path as the overlapped form, so the two are
bit-identical by construction (the repo-wide ``*_start(...).wait()``
invariant of :mod:`repro_torch.core.request` lifted to whole schedules).

Each plan also carries its *declared overlap intent*
(:attr:`CommPlan.intent`): ring, halo, and stagger schedules leave an
issue/complete window with independent compute inside it, so they declare
``"overlapped"``; a pipeline chains compute -> transfer -> compute through
data dependence, so it declares ``"serialized"``.  The reference package
checks the declared intent against its compiled programs;
:mod:`repro_torch.launch.dryrun` checks it against the eager op stream the
planner emits.

MPI correspondence
------------------
A comm plan is the layout-agnostic analogue of MPI *persistent requests*:
the schedule is declared once (``MPI_Send_init``/``MPI_Recv_init`` fix the
envelope), each step starts the pre-declared transfer
(``MPI_Start``) and completes it after the overlapped compute
(``MPI_Wait``).

=============================  =============================================
MPI persistent pattern         comm plan
=============================  =============================================
``MPI_Send_init/Recv_init``    :func:`ring`/:func:`halo`/:func:`pipeline`
                               (declare the schedule, no data moves)
``MPI_Start`` (step k)         planner issues ``transfer(state, k)``
                               before step k's ``compute``
``MPI_Wait`` (step k)          planner waits the :class:`Pending` after
                               ``compute``, yielding step k+1's state
``MPI_Startall`` degenerate    ``double_buffer=False`` — start+wait
                               back-to-back (blocking), bit-identical
=============================  =============================================

Migration note: ``summa_ring_program`` before/after
---------------------------------------------------
Before (hand-written rotation, repeated in every algorithm)::

    for s in range(R):
        pend = None
        if double_buffer and s < R - 1:
            pend = ring_shift_start(B_cur, -1, rank_dim="Rj")
        P = rank_map(step, dtA, P, A_dist, B_cur, out_tile_layout=P_l)
        if s < R - 1:
            B_cur = pend.wait() if double_buffer else ring_shift(B_cur, -1)
    return reduce_scatter_bag(P, C_tile, scatter_dim="j", rank_dim="Ck").data

After (schedule declared once; the planner owns issue/wait placement)::

    plan = ring(
        R,
        transfer=lambda b, s: ring_shift_start(b, -1, rank_dim="Rj"),
        compute=lambda p, b, s: rank_map(step(s), dtA, p, A_dist, b,
                                         out_tile_layout=P_l),
        epilogue=lambda p, b: reduce_scatter_bag(
            p, C_tile, scatter_dim="j", rank_dim="Ck").data,
    )
    return plan.run(B_cur, P, double_buffer=double_buffer)

Stage signatures
----------------
``transfer(state, step) -> Pending``
    Issue the non-blocking transfer of ``state`` for the next step and
    return the :class:`Pending` (ring/halo).  In a pipeline the planner
    passes the *carry* — the freshly computed value is what flows.
``compute(carry, state, step) -> carry``
    The overlapped per-step compute.  Must not depend on the in-flight
    transfer's result (the planner hands it the pre-transfer ``state``).
``epilogue(carry, state) -> result``
    Optional final stage (e.g. the SUMMA reduce-scatter); receives the
    final carry and the final state.  Defaults to returning ``carry``.
``combine(result, step) -> Pending`` (``dispatch``/``bucket`` plans only)
    Issue the *return* leg for step ``step``'s compute result.  A
    ``dispatch`` plan's compute consumes the completed transfer (the
    arrived tiles), so the overlap comes from pipelining across steps
    rather than within one step — see :func:`dispatch`.
``reduce(arrived) -> Any`` (``bucket`` plans only)
    Cross-step barrier between the transfers' completion and the per-step
    computes: receives the list of arrived results in step order and
    returns a global value every compute sees (e.g. the global grad-norm
    clip scale of a ZeRO train step) — see :func:`bucket`.

The ``bucket`` kind (ZeRO-style training comm)
----------------------------------------------
:func:`bucket` declares the ZeRO-2 gradient schedule the explicit train
step of the reference trainer runs: step *s* is
one dtype-homogeneous gradient bucket, ``transfer`` issues its
``MPI_Ireduce_scatter`` (every bucket's reduction in flight at once — the
backward's products drain into the wire as they appear), ``reduce`` is the
one global stage (the grad-norm clip scale, a cross-bucket barrier),
``compute`` is the shard-local AdamW update of bucket *s*'s 1/R param
shard, and ``combine`` issues the updated shard's ``MPI_Iallgatherv``
prefetch.  Each bucket's reduction completes behind the *sibling* buckets'
norm/update math, so with two or more buckets no reduce-scatter sits on
the compute chain (one bucket = the serialized negative control).  Declared intent: ``"overlapped"``; the
blocking interpretation starts+waits each leg back-to-back through the
same issue path, so it is bit-identical by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .request import Pending

__all__ = ["CommPlan", "ring", "halo", "pipeline", "stagger", "dispatch",
           "bucket", "intent_of"]

_INTENTS = {
    "ring": "overlapped",
    "halo": "overlapped",
    "pipeline": "serialized",
    "stagger": "overlapped",
    "dispatch": "overlapped",
    "bucket": "overlapped",
}


def intent_of(kind: str) -> str:
    """Declared overlap intent of a plan kind: whether the emitted schedule
    leaves compute inside each transfer's issue/wait window
    (``"overlapped"`` / ``"serialized"``)."""
    if kind not in _INTENTS:
        raise ValueError(f"unknown plan kind {kind!r} (have {sorted(_INTENTS)})")
    return _INTENTS[kind]


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A declared communication schedule (see module docstring).

    Build with :func:`ring`, :func:`halo`, :func:`pipeline`, or
    :func:`stagger`; execute with :meth:`run`.  The planner — not the algorithm — places the
    issue/wait points, so every consumer gets the double-buffered form and
    its bit-identical blocking interpretation for free.
    """

    kind: str
    steps: int
    transfer: Callable[[Any, int], Pending]
    compute: Callable[[Any, Any, int], Any]
    epilogue: Callable[[Any, Any], Any] | None = None
    # dispatch/bucket plans only: issue the return leg for one step's result
    combine: Callable[[Any, int], Pending] | None = None
    # bucket plans only: cross-step barrier between arrivals and computes
    reduce: Callable[[list], Any] | None = None

    def __post_init__(self):
        intent_of(self.kind)  # validates the kind
        if self.steps < 1:
            raise ValueError(f"plan needs at least one step, got {self.steps}")
        if self.kind == "dispatch" and self.combine is None:
            raise ValueError("dispatch plan needs a combine stage (the return leg)")
        if self.kind == "bucket" and self.combine is None:
            raise ValueError("bucket plan needs a combine stage (the param all-gather)")
        if self.reduce is not None and self.kind != "bucket":
            raise ValueError(f"reduce stage is bucket-plan only, not {self.kind!r}")
        if self.epilogue is not None and self.kind == "stagger":
            raise ValueError("a stagger plan has no epilogue: its caller waits each step")

    @property
    def intent(self) -> str:
        """Declared overlap intent of this plan's kind."""
        return intent_of(self.kind)

    def _issue(self, value, step: int) -> Pending:
        pend = self.transfer(value, step)
        if not isinstance(pend, Pending):
            raise TypeError(
                f"plan transfer must return a Pending (got {type(pend).__name__}); "
                "use the *_start form of the collective"
            )
        return pend

    def _issue_combine(self, value, step: int) -> Pending:
        pend = self.combine(value, step)
        if not isinstance(pend, Pending):
            raise TypeError(
                f"plan combine must return a Pending (got {type(pend).__name__}); "
                "use the *_start form of the collective"
            )
        return pend

    def _finish(self, carry, state):
        if self.epilogue is None:
            return carry
        return self.epilogue(carry, state)

    def run(self, state, carry, *, double_buffer: bool = True):
        """Emit the program: rotate ``state`` through ``steps`` transfers
        while folding ``compute`` over ``carry``.

        ``double_buffer=True`` issues step ``k+1``'s transfer before step
        ``k``'s compute and waits after it (the overlap window);
        ``double_buffer=False`` starts and waits back-to-back at the
        completion point — same issue path, bit-identical results.  A
        stagger plan returns its steps' requests (see :func:`stagger`).
        """
        if self.kind == "stagger":
            # round-robin over independent steps (microbatches): every step
            # computes its own partial and issues its own collective; no step
            # consumes another's result, so each transfer's completion hides
            # behind the *other* steps' compute — the continuous-batching
            # decode schedule (microbatch i's reduction behind microbatch
            # i+1's math).  The caller waits each request where it reads the
            # result.  The blocking form completes each transfer before the
            # next issue (its requests come back completed); the waits are
            # pure completion points, so both forms are bit-identical.
            pends = []
            for s in range(self.steps):
                pends.append(self._issue(self.compute(carry, state, s), s))
                if not double_buffer:
                    pends[-1].wait()
            return pends
        if self.kind == "bucket":
            # ZeRO gradient schedule (see module docstring): issue EVERY
            # bucket's reduce-scatter up front (the whole backward's grads in
            # flight at once), complete them, run the one cross-bucket
            # ``reduce`` stage (the global clip scale — the only barrier),
            # then fold each bucket's shard-local update and issue its
            # all-gather return leg; every wait is a pure completion point
            # so the blocking form — start+wait
            # back-to-back per leg, same issue path — is bit-identical.
            # Overlap shape: bucket s's reduce-scatter completes behind the
            # SIBLING buckets' reduce-stage math (its own norm term is
            # downstream); its all-gather has no downstream compute at all.
            if double_buffer:
                pends = [self._issue(state, s) for s in range(self.steps)]
                # each arrival is waited where the reduce stage first reads
                # it: the earlier buckets' reduce math runs while the later
                # ones are still in flight
                arrived = _Arrivals(pends)
                gval = self.reduce(arrived) if self.reduce else None
                results = [self.compute(gval, arrived[s], s)
                           for s in range(self.steps)]
                combines = [self._issue_combine(results[s], s)
                            for s in range(self.steps)]
                done = [c.wait() for c in combines]
            else:
                arrived = [self._issue(state, s).wait() for s in range(self.steps)]
                gval = self.reduce(arrived) if self.reduce else None
                done = [
                    self._issue_combine(self.compute(gval, arrived[s], s), s).wait()
                    for s in range(self.steps)
                ]
            return self._finish(done, state)
        if self.kind == "dispatch":
            # two-legged exchange per step (MPI_Ialltoallv out and back): the
            # transfer ships step s's routed payload to its owners, compute
            # runs on the arrived tiles, and the combine leg returns the
            # results.  Double-buffered over steps (expert groups): step
            # s+1's dispatch is issued before step s's compute, so it
            # completes behind it, and step s's combine completes behind
            # step s+1's compute — with two or more steps neither leg sits
            # on the compute chain.  With one step there is no sibling
            # compute and both legs chain (the negative control).  The waits
            # are pure completion points, so the blocking form (issue+wait
            # back-to-back) is bit-identical by construction.
            if double_buffer:
                pend = self._issue(state, 0)
                combines = []
                for s in range(self.steps):
                    nxt = self._issue(state, s + 1) if s + 1 < self.steps else None
                    arrived = pend.wait()
                    res = self.compute(carry, arrived, s)
                    combines.append(self._issue_combine(res, s))
                    pend = nxt
                done = [c.wait() for c in combines]
            else:
                done = []
                for s in range(self.steps):
                    arrived = self._issue(state, s).wait()
                    res = self.compute(carry, arrived, s)
                    done.append(self._issue_combine(res, s).wait())
            return self._finish(done, state)
        if self.kind == "pipeline":
            # compute -> transfer -> compute chained through data
            # dependence: the transfer ships the value that was just
            # computed, so no overlap window exists by construction (the
            # serialized negative control).
            for s in range(self.steps):
                carry = self.compute(carry, state, s)
                if s < self.steps - 1:
                    state = self._issue(carry, s).wait()
            return self._finish(carry, state)
        if self.kind == "halo":
            # one exchange overlapped with the interior compute; the
            # epilogue combines interior result and received halos.
            if double_buffer:
                pend = self._issue(state, 0)
                carry = self.compute(carry, state, 0)
                state = pend.wait()
            else:
                state = self._issue(state, 0).wait()
                carry = self.compute(carry, state, 0)
            return self._finish(carry, state)
        # ring: issue-before / wait-after rotation.
        for s in range(self.steps):
            pend = None
            if double_buffer and s < self.steps - 1:
                pend = self._issue(state, s)
            carry = self.compute(carry, state, s)
            if s < self.steps - 1:
                state = pend.wait() if double_buffer else self._issue(state, s).wait()
        return self._finish(carry, state)


class _Arrivals:
    """A bucket plan's arrivals in step order, each request waited once,
    where its result is first read (``len``, indexing and iteration, as a
    list)."""

    def __init__(self, pends):
        self._pends = pends
        self._done: dict = {}

    def __len__(self) -> int:
        return len(self._pends)

    def __getitem__(self, s: int):
        s = range(len(self._pends))[s]
        if s not in self._done:
            self._done[s] = self._pends[s].wait()
        return self._done[s]

    def __iter__(self):
        return (self[s] for s in range(len(self._pends)))


def ring(
    steps: int,
    *,
    transfer: Callable[[Any, int], Pending],
    compute: Callable[[Any, Any, int], Any],
    epilogue: Callable[[Any, Any], Any] | None = None,
) -> CommPlan:
    """Declare an R-step ring rotation (SUMMA panels, ring attention KV):
    each step computes on the current state while the next state is in
    flight.  Declared intent: ``"overlapped"``."""
    return CommPlan("ring", steps, transfer, compute, epilogue)


def halo(
    *,
    transfer: Callable[[Any, int], Pending],
    compute: Callable[[Any, Any, int], Any],
    epilogue: Callable[[Any, Any], Any] | None = None,
) -> CommPlan:
    """Declare a halo exchange overlapped with the interior compute; the
    epilogue combines both.  Declared intent: ``"overlapped"``."""
    return CommPlan("halo", 1, transfer, compute, epilogue)


def pipeline(
    steps: int,
    *,
    transfer: Callable[[Any, int], Pending],
    compute: Callable[[Any, Any, int], Any],
    epilogue: Callable[[Any, Any], Any] | None = None,
) -> CommPlan:
    """Declare a stage pipeline whose transfers ship each stage's output to
    the next compute — serialized by data dependence.  Declared intent:
    ``"serialized"`` (the negative control)."""
    return CommPlan("pipeline", steps, transfer, compute, epilogue)


def stagger(
    steps: int,
    *,
    transfer: Callable[[Any, int], Pending],
    compute: Callable[[Any, Any, int], Any],
) -> CommPlan:
    """Declare a round-robin schedule over *independent* steps: each step's
    ``compute`` produces a fresh partial and ``transfer`` issues its
    collective (e.g. the tensor-parallel ``Iallreduce`` of a decode
    microbatch); no step consumes another step's transferred result, so
    every collective completes behind the sibling steps' compute.  This is
    the continuous-batching decode schedule — with one step (one
    microbatch) the collective sits alone on the compute chain and
    serializes; with two or more, each reduction hides behind the other
    microbatch's math.  :meth:`CommPlan.run` returns the steps' requests
    in step order, and the caller waits each where it first reads the
    result, so a chain of staggered stages waits microbatch ``s``'s
    transfer behind the next stage's compute of the microbatches before
    it.  Declared intent: ``"overlapped"``."""
    return CommPlan("stagger", steps, transfer, compute)


def dispatch(
    steps: int,
    *,
    transfer: Callable[[Any, int], Pending],
    compute: Callable[[Any, Any, int], Any],
    combine: Callable[[Any, int], Pending],
    epilogue: Callable[[Any, Any], Any] | None = None,
) -> CommPlan:
    """Declare a double-buffered two-legged exchange schedule — the
    expert-parallel MoE shape (``MPI_Ialltoallv`` out, expert compute,
    ``MPI_Ialltoallv`` back, pipelined over expert groups):

    * ``transfer(state, s)`` issues step ``s``'s dispatch leg (ships the
      routed payload to its owner ranks) and returns the :class:`Pending`;
    * ``compute(carry, arrived, s)`` runs on the *arrived* tiles — unlike
      ring/halo, the compute stage consumes the completed transfer, so the
      planner hides step ``s``'s dispatch behind step ``s-1``'s compute;
    * ``combine(result, s)`` issues the return leg for step ``s``'s result;
      its completion hides behind step ``s+1``'s compute;
    * ``epilogue(done, state)`` receives the completed combine results in
      step order.

    With ``steps >= 2`` both legs of every step have independent sibling
    compute (the other steps' math); with one step both chain — the
    serialized negative control.  Declared intent: ``"overlapped"``."""
    return CommPlan("dispatch", steps, transfer, compute, epilogue, combine)


def bucket(
    steps: int,
    *,
    transfer: Callable[[Any, int], Pending],
    reduce: Callable[[list], Any],
    compute: Callable[[Any, Any, int], Any],
    combine: Callable[[Any, int], Pending],
    epilogue: Callable[[Any, Any], Any] | None = None,
) -> CommPlan:
    """Declare the ZeRO-2 bucketed gradient schedule — one step per
    gradient bucket (``MPI_Ireduce_scatter`` out, shard-local optimizer
    math, ``MPI_Iallgatherv`` back):

    * ``transfer(state, s)`` issues bucket ``s``'s gradient reduce-scatter
      and returns the :class:`Pending` — all buckets go into flight before
      any wait, so the reductions drain behind each other's downstream math;
    * ``reduce(arrived)`` is the one cross-bucket barrier: it sees every
      bucket's reduced shard (in step order) and returns the global value
      the updates share (the grad-norm clip scale);
    * ``compute(gval, arrived_s, s)`` runs bucket ``s``'s shard-local
      update (AdamW on the 1/R optimizer shard) and returns the updated
      param shard;
    * ``combine(result, s)`` issues the updated shard's all-gather
      (the next forward's param prefetch); completion hides behind the
      sibling buckets' update math and the epilogue's unpacking;
    * ``epilogue(done, state)`` receives the gathered full params in step
      order.

    With ``steps >= 2`` every reduce-scatter has sibling reduce-stage
    compute independent of it; with one bucket its own norm term is the
    only downstream compute and the reduction chains — the serialized
    negative control.  Declared intent:
    ``"overlapped"``."""
    return CommPlan("bucket", steps, transfer, compute, epilogue, combine, reduce)
