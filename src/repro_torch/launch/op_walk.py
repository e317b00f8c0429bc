"""Accounting over one rank's eager op stream: the port's counterpart of the
reference's ``src/repro/launch/hlo_walk.py``.

The reference lowers a program to optimized HLO and walks its text.  The
port runs eagerly, so the program *is* its op stream: :class:`OpWalk`, a
``TorchDispatchMode``, records every ATen op one rank issues (under
``FakeTensorMode`` nothing is allocated and every shape is the real one),
the port's kernels report their launches from their wrappers
(:func:`repro_torch.kernels.fake.set_observer`), and the comm layer's
requests report their issue and completion
(:func:`repro_torch.core.request.set_observer`).  The walk
sees every iteration of every loop as it runs, so, unlike the HLO walker,
it needs no loop trip counts and multiplies nothing.  From the stream it gives:

  * ``flops`` — every op's operations: ``torch.utils.flop_counter``'s
    registry for ATen ops (the products; elementwise work counts none, as
    the reference counts only dots), the kernel's own formula for the
    port's kernels (:mod:`repro_torch.launch.roofline`); and
    ``compute_seconds``, the same operations at the card's peak for their
    operand dtype;
  * ``bytes`` — each op's tensor inputs read and outputs written once (a
    view, an allocation: none);
  * ``collective_bytes`` — per kind, each collective's result bytes once,
    an all-reduce's twice, with ``valid_fractions`` discounting ragged
    padding (the reference's ``analyze``);
  * ``collectives`` — every collective's overlap verdict, the eager form of
    the reference's def-use classifier (``hlo_walk._OverlapAnalyzer``), on
    storage def-use and issue order.  A collective is **overlapped** when
    no compute op produced its input (it could have been issued at any
    earlier point), when no compute op after its wait reads its result
    (nothing waits on it), or when at least one compute op was issued
    between its issue and its wait (the window hid it); otherwise it is
    **serialized**: a blocking collective between two dependent computes
    is.  *Compute* is every op that launches arithmetic on the device: the
    port's kernels and every ATen op but views, allocations, fills, copies
    and casts (``copy_``, ``clone``, ``_to_copy``).  Def-use follows storages, not views: an op reads the
    storages of its tensor arguments and writes those of its fresh or
    mutated outputs; producers and consumers are followed transitively,
    through copies and other collectives, as the reference's reach does;
  * ``peak_live_bytes`` — the peak of the bytes of the storages allocated
    during the walk and still alive (each rounded up to the CUDA caching
    allocator's 512-byte block), above what was live at its entry, and
    ``largest_storage_bytes``, the largest of those storages;
  * ``kernel_launches`` — the port's kernels launched, by name.

Kinds of collective (``c10d`` ops): ``allreduce_`` is an all-reduce;
``_allgather_base_``/``allgather_`` an all-gather; ``_reduce_scatter_base_``
a reduce-scatter; ``alltoall_base_`` an all-to-all; ``broadcast_`` a
broadcast; the sends and receives of one request (one batch of
``isend``/``irecv``) are one collective-permute per received buffer (per
sent buffer when the rank receives nothing).  A collective that no request
owns is blocking: it completes where it is issued.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import request
from repro_torch.kernels import fake
from repro_torch.kernels.work import peak_seconds

from . import roofline

__all__ = ["OpWalk", "OpStats", "Op", "Collective", "OpStream", "analyze", "plan_agreement",
           "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
          "empty_permuted"}
_FILL = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
         "new_ones", "new_full", "fill", "fill_", "zero_", "scalar_tensor", "arange",
         "randn", "rand", "randint", "normal_", "uniform_", "random_", "bernoulli_"}
# copies and casts (``_to_copy`` is both)
_COPY = {"copy_", "_copy_from", "_to_copy", "clone", "lift_fresh", "lift_fresh_copy",
         "_copy_from_and_resize", "detach_copy", "alias_copy", "expand_copy", "view_copy",
         "_unsafe_view"}
BLOCK = 512  # the CUDA caching allocator rounds every block up to this many bytes


def _block_bytes(n: int) -> int:
    return -(-n // BLOCK) * BLOCK if n else 0


@dataclasses.dataclass
class Op:
    """One op of the stream: its storages read and written, its
    operations, bytes and time at the card's peak."""

    name: str
    kind: str  # compute | kernel | view | alloc | fill | copy | collective
    reads: tuple = ()
    writes: tuple = ()
    flops: float = 0.0
    bytes: float = 0.0
    seconds: float = 0.0
    coll: tuple | None = None  # a c10d op's (kind, result bytes, group ranks)

    @property
    def is_compute(self) -> bool:
        return self.kind in ("compute", "kernel")


@dataclasses.dataclass
class Collective:
    """One collective: its kind, wire bytes (its result, padding included),
    the stream positions of its ops, its issue and its wait (the position
    of the first op after its completion), the global ranks of its group,
    and its verdict."""

    kind: str
    bytes: int
    ops: tuple
    issue: int
    wait: int
    ranks: tuple = ()
    factor: int = 1
    valid_bytes: float | None = None
    classification: str = ""

    @property
    def payload_bytes(self) -> float:
        """Valid (non-padding) bytes: equal to the wire bytes for dense
        transfers."""
        return self.bytes if self.valid_bytes is None else self.valid_bytes

    @property
    def exposed_bytes(self) -> float:
        """Valid bytes this collective leaves on the critical path."""
        if self.classification != "serialized":
            return 0.0
        return self.payload_bytes * self.factor

    @property
    def link_rate(self) -> float:
        return roofline.link_rate(self.ranks or (0,))


@dataclasses.dataclass
class OpStream:
    """A recorded (or hand-built) op stream and its collectives."""

    ops: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    peak_live_bytes: int = 0
    largest_storage_bytes: int = 0
    kernel_launches: dict = dataclasses.field(default_factory=dict)

    def add(self, op: Op) -> int:
        self.ops.append(op)
        return len(self.ops) - 1


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    compute_seconds: float = 0.0
    collective_bytes: float = 0.0  # wire bytes (includes ragged padding)
    valid_collective_bytes: float = 0.0  # payload bytes (valid_fractions applied)
    coll_by_op: dict = dataclasses.field(default_factory=dict)  # wire, per kind
    coll_by_op_valid: dict = dataclasses.field(default_factory=dict)  # payload, per kind
    collectives: list = dataclasses.field(default_factory=list)  # list[Collective]
    peak_live_bytes: int = 0
    largest_storage_bytes: int = 0
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    def of_kind(self, kind: str | None = None) -> list:
        return self.collectives if kind is None else [c for c in self.collectives
                                                      if c.kind == kind]

    def collectives_overlapped(self, kind: str | None = None) -> int:
        return sum(1 for c in self.of_kind(kind) if c.classification == "overlapped")

    def collectives_serialized(self, kind: str | None = None) -> int:
        return sum(1 for c in self.of_kind(kind) if c.classification == "serialized")

    def exposed_collective_bytes(self, kind: str | None = None) -> float:
        """Factor-weighted valid bytes of the serialized collectives."""
        return sum(c.exposed_bytes for c in self.of_kind(kind))

    def overlap_fraction(self, kind: str | None = None) -> float | None:
        """Payload-byte-weighted share of ``kind``'s traffic (every kind when
        None) that is overlapped; None without such collectives."""
        cs = self.of_kind(kind)
        total = sum(c.payload_bytes * c.factor for c in cs)
        if not total:
            return None
        good = sum(c.payload_bytes * c.factor for c in cs if c.classification == "overlapped")
        return good / total

    def overlap_by_kind(self) -> dict:
        """``{kind: {overlapped, serialized, total_bytes (wire), valid_bytes,
        exposed_bytes, overlap_fraction}}``."""
        out: dict = {}
        for kind in sorted({c.kind for c in self.collectives}):
            cs = self.of_kind(kind)
            out[kind] = {
                "overlapped": self.collectives_overlapped(kind),
                "serialized": self.collectives_serialized(kind),
                "total_bytes": sum(c.bytes * c.factor for c in cs),
                "valid_bytes": sum(c.payload_bytes * c.factor for c in cs),
                "exposed_bytes": self.exposed_collective_bytes(kind),
                "overlap_fraction": self.overlap_fraction(kind),
            }
        return out


def _check_fractions(valid_fractions) -> dict:
    fractions = dict(valid_fractions or {})
    for kind, f in fractions.items():
        if kind not in COLLECTIVES:
            raise ValueError(f"valid_fractions: unknown collective kind {kind!r}")
        if not 0.0 < f <= 1.0:
            raise ValueError(f"valid_fractions[{kind!r}] = {f} not in (0, 1]")
    return fractions


def _classify(stream: OpStream) -> None:
    """Sets every collective's verdict (see the module docstring)."""
    ops = stream.ops
    n = len(ops)
    producers: list = [()] * n
    consumers: list = [[] for _ in range(n)]
    last_writer: dict = {}
    for i, op in enumerate(ops):
        ps = {last_writer[s] for s in op.reads if s in last_writer}
        producers[i] = tuple(ps)
        for p in ps:
            consumers[p].append(i)
        for s in op.writes:
            last_writer[s] = i
    compute = [op.is_compute for op in ops]
    above = [False] * n  # a compute op among the strict ancestors
    for i in range(n):
        above[i] = any(compute[p] or above[p] for p in producers[i])
    below = [False] * n  # a compute op among the strict descendants
    for i in range(n - 1, -1, -1):
        below[i] = any(compute[u] or below[u] for u in consumers[i])
    before = [0] * (n + 1)  # compute ops among ops[:i]
    for i in range(n):
        before[i + 1] = before[i] + compute[i]
    for c in stream.collectives:
        up = any(above[o] for o in c.ops)
        down = any(below[o] for o in c.ops)
        window = before[min(max(c.wait, c.issue + 1), n)] - before[min(c.issue + 1, n)]
        c.classification = "overlapped" if (not up or not down or window > 0) else "serialized"


def analyze(stream: OpStream, *, valid_fractions: Mapping[str, float] | None = None) -> OpStats:
    """:class:`OpStats` of a recorded or hand-built stream.
    ``valid_fractions`` maps a collective kind to the valid/padded ratio of
    its transfers (known from the extents tables of a ragged program);
    kinds absent from it count fully valid."""
    fractions = _check_fractions(valid_fractions)
    _classify(stream)
    st = OpStats(peak_live_bytes=stream.peak_live_bytes,
                 largest_storage_bytes=stream.largest_storage_bytes,
                 kernel_launches=dict(stream.kernel_launches), n_ops=len(stream.ops))
    for op in stream.ops:
        st.flops += op.flops
        st.bytes += op.bytes
        st.compute_seconds += op.seconds
    for c in stream.collectives:
        c.factor = 2 if c.kind == "all-reduce" else 1
        c.valid_bytes = c.bytes * fractions[c.kind] if c.kind in fractions else None
        wire = c.bytes * c.factor
        st.collective_bytes += wire
        st.coll_by_op[c.kind] = st.coll_by_op.get(c.kind, 0.0) + wire
        st.valid_collective_bytes += c.payload_bytes * c.factor
        st.coll_by_op_valid[c.kind] = (st.coll_by_op_valid.get(c.kind, 0.0)
                                       + c.payload_bytes * c.factor)
        st.collectives.append(c)
    return st


def plan_agreement(stats: OpStats, declared: str, *, kind: str | None = None) -> dict:
    """A comm plan's *declared* overlap intent against the walk's proven
    verdict (``"serialized"`` iff a collective of ``kind``, every kind when
    None, is serialized): ``{"declared", "proven", "agree", "serialized",
    "overlapped"}``, the reference's row."""
    if declared not in ("overlapped", "serialized"):
        raise ValueError(f"unknown declared intent {declared!r}")
    serialized = stats.collectives_serialized(kind)
    overlapped = stats.collectives_overlapped(kind)
    proven = "serialized" if serialized else "overlapped"
    return {"declared": declared, "proven": proven, "agree": declared == proven,
            "serialized": serialized, "overlapped": overlapped}


# ------------------------------------------------------------ recording ----

def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpWalk(TorchDispatchMode):
    """Record one rank's op stream while the block runs (see the module
    docstring); :meth:`stats` analyzes it.  Enter it inside
    ``FakeTensorMode`` to trace a program that allocates nothing."""

    def __init__(self):
        super().__init__()
        self.stream = OpStream()
        self._sid: dict = {}  # storage address -> stream storage id
        self._next = 0
        self._finalizers: list = []
        self._live = 0
        # id(Work) -> (Work, op index); the Work is kept until a request claims
        # it, so that the request's Work is the same Python object
        self._work_op: dict = {}
        self._p2p: list = []  # sends and receives issued since the last request
        self._requests: list = []  # [op indices, wait position or None] per request
        self._request_of = weakref.WeakKeyDictionary()  # Pending -> its index in _requests
        self._previous = None

    # -- storages ---------------------------------------------------------------
    def _storage(self, t: torch.Tensor, fresh: bool) -> int:
        st = t.untyped_storage()
        key = st._cdata
        sid = self._sid.get(key)
        if sid is not None:
            return sid
        sid = self._next
        self._next += 1
        self._sid[key] = sid
        size = _block_bytes(st.nbytes()) if fresh else 0
        if size:
            self._live += size
            self.stream.peak_live_bytes = max(self.stream.peak_live_bytes, self._live)
            self.stream.largest_storage_bytes = max(self.stream.largest_storage_bytes, size)
        self._finalizers.append(weakref.finalize(st, self._dead, key, size))
        return sid

    def _dead(self, key: int, size: int) -> None:
        self._sid.pop(key, None)
        self._live -= size

    def _ids(self, tensors, fresh: bool = False) -> tuple:
        return tuple(dict.fromkeys(self._storage(t, fresh) for t in tensors))

    # -- the mode ---------------------------------------------------------------
    def __enter__(self):
        self._previous = request.set_observer(self), fake.set_observer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        request.set_observer(self._previous[0])
        fake.set_observer(self._previous[1])
        self._finish()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":  # metadata queries (``prim.device``): no device work
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        in_keys = {t.untyped_storage()._cdata for t in ins}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective_op(func, args, kwargs, out)
            return out
        name = func.overloadpacket.__name__
        mutated = [t for a, arg in zip(args, func._schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write
                   for t in _tensors(a)]
        mutated += [t for k, v in kwargs.items() if k == "out" for t in _tensors(v)]
        outs = _tensors(out)
        fresh = [t for t in outs if t.untyped_storage()._cdata not in in_keys]
        if not mutated and not fresh:
            kind = "view"
        elif name in _ALLOC:
            kind = "alloc"
        elif name in _FILL:
            kind = "fill"
        elif name in _COPY:
            kind = "copy"
        else:
            kind = "compute"
        if kind == "view":
            self.stream.add(Op(f"aten.{name}", kind))
            return out
        reads = () if kind in ("alloc", "fill") else self._ids(ins)
        writes = self._ids(mutated) + self._ids(fresh, fresh=True)
        nbytes = 0
        if kind != "alloc":
            nbytes = sum(_nbytes(t) for t in (mutated + fresh))
            if kind != "fill":
                nbytes += sum(_nbytes(t) for t in ins)
        flops = seconds = 0.0
        counter = _FLOPS.get(func.overloadpacket)
        if counter is not None:
            flops = float(counter(*args, **kwargs, out_val=out))
            dtype = next((t.dtype for t in ins if t.is_floating_point()), torch.float32)
            seconds = peak_seconds(flops, dtype)
        self.stream.add(Op(f"aten.{name}", kind, reads, writes, flops, float(nbytes), seconds))
        return out

    def launched(self, name, reads, writes, flops, nbytes, seconds) -> None:
        """A kernel wrapper's report of one launch it stands for (its
        operands fake): the tensors it reads and writes, its operations,
        bytes and time at the card's peak."""
        self.stream.add(Op(name, "kernel", self._ids(reads), self._ids(writes), float(flops),
                           float(nbytes), float(seconds)))
        self.stream.kernel_launches[name] = self.stream.kernel_launches.get(name, 0) + 1

    def _collective_op(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        kind = _C10D_KINDS.get(name)
        if kind is None:  # barrier, monitored_barrier: no data
            self.stream.add(Op(f"c10d.{name}", "view"))
            return
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        ranks = ()
        pg = named.get("process_group")
        if pg is not None:
            import torch.distributed as dist

            group = torch._C._distributed_c10d.ProcessGroup.unbox(pg)
            ranks = tuple(dist.get_process_group_ranks(group))
        if kind in ("send",):
            sent, landed = _tensors(named.get("tensors")), []
        elif kind in ("recv",):
            sent, landed = [], _tensors(named.get("tensors"))
        elif kind in ("all-reduce", "broadcast"):
            sent = landed = _tensors(named.get("tensors"))
        else:
            landed = _tensors(named.get("output_tensors", named.get("output_tensor",
                                                                    named.get("output"))))
            sent = _tensors(named.get("input_tensors", named.get("input_tensor",
                                                                 named.get("input"))))
        nbytes = sum(_nbytes(t) for t in sent) + sum(_nbytes(t) for t in landed)
        idx = self.stream.add(Op(f"c10d.{name}", "collective", self._ids(sent),
                                 self._ids(landed), 0.0, float(nbytes),
                                 coll=(kind, sum(_nbytes(t) for t in (landed or sent)), ranks)))
        if kind in ("send", "recv"):
            self._p2p.append(idx)
        for obj in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(obj, torch.ScriptObject) and "Work" in str(obj._type()):
                work = torch._C._distributed_c10d.Work.unbox(obj)
                self._work_op[id(work)] = (work, idx)

    # -- the request hook -------------------------------------------------------
    def issued(self, pending, works) -> None:
        idxs = [self._work_op.pop(id(w))[1] for w in works if id(w) in self._work_op]
        if works and len(idxs) < len(works):
            # a coalesced batch of sends and receives hands back the batch's
            # own Work: the request owns the p2p ops issued since the last one
            idxs += self._p2p
        self._p2p = []
        if idxs:
            self._request_of[pending] = len(self._requests)
            self._requests.append([sorted(set(idxs)), None])

    def waited(self, pending) -> None:
        i = self._request_of.get(pending)
        if i is not None and self._requests[i][1] is None:
            self._requests[i][1] = len(self.stream.ops)

    # -- the collectives ----------------------------------------------------------
    def _finish(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()
        ops, end = self.stream.ops, len(self.stream.ops)
        groups: list = []
        done: set = set()
        for idxs, wait in self._requests:
            wait = end if wait is None else wait
            groups.append((idxs, wait))
            done.update(idxs)
        loose = [i for i, op in enumerate(ops) if op.coll is not None and i not in done]
        batch: list = []
        for i in loose:  # blocking: each completes where it is issued
            if ops[i].coll[0] in ("send", "recv"):
                if batch and batch[-1] == i - 1:
                    batch.append(i)
                    continue
                if batch:
                    groups.append((batch, batch[-1] + 1))
                batch = [i]
            else:
                groups.append(([i], i + 1))
        if batch:
            groups.append((batch, batch[-1] + 1))
        out = []
        for idxs, wait in groups:
            p2p = [i for i in idxs if ops[i].coll[0] in ("send", "recv")]
            for i in idxs:
                if i not in p2p:
                    kind, nbytes, ranks = ops[i].coll
                    out.append(Collective(kind, nbytes, (i,), i, wait, ranks))
            if p2p:
                # what lands depends on what was sent: the receives read the sends
                sent = tuple(s for i in p2p if ops[i].coll[0] == "send" for s in ops[i].reads)
                for i in p2p:
                    if ops[i].coll[0] == "recv":
                        ops[i].reads = ops[i].reads + sent
                recvs = [i for i in p2p if ops[i].coll[0] == "recv"] or p2p
                for i in recvs:
                    _, nbytes, ranks = ops[i].coll
                    out.append(Collective("collective-permute", nbytes, tuple(p2p), min(p2p),
                                          wait, ranks))
        out.sort(key=lambda c: c.issue)
        self.stream.collectives = out
        self._work_op.clear()
        self._requests.clear()

    def stats(self, *, valid_fractions: Mapping[str, float] | None = None) -> OpStats:
        """The walk's :class:`OpStats` (after the block)."""
        return analyze(self.stream, valid_fractions=valid_fractions)


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return dict(flop_registry)


_FLOPS = _flop_registry()
