"""What one rank holds at its predicted peak: the dry run's cell traced
twice on the CPU, the second walk listing the storages live when the live
bytes first reach the first walk's peak, grouped by the op that made them.

    PYTHONPATH=src python tools/peak_holders.py --arch qwen2.5-32b --shape train_4k
    PYTHONPATH=src python tools/peak_holders.py --arch qwen2.5-32b --shape train_4k \
        --attn-mode sp_ring --set n_layers=8

Prints the cell's memory record, then one line per (op, shape, dtype)
group, largest first: the storages' count and GB.  The storages are those
:class:`repro_torch.launch.op_walk.OpWalk` counts (made during the walk,
each rounded up to 512 bytes); what was live at the walk's entry (the
shards, the optimizer state, the batch) is in the record, not the list.
"""
from __future__ import annotations

import argparse
import collections

from repro_torch.launch import dryrun, op_walk


class PeakWalk(op_walk.OpWalk):
    """An :class:`OpWalk` that keeps each live storage's producer and, the
    first time the live bytes reach ``target``, a copy of them; ``last`` is
    the latest walk made."""

    target: int | None = None
    last: "PeakWalk | None" = None

    def __init__(self):
        super().__init__()
        self.holders: dict = {}
        self.snapshot: list | None = None
        self._op = None
        PeakWalk.last = self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func.overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _storage(self, t, fresh):
        key = t.untyped_storage()._cdata
        new = key not in self._sid
        sid = super()._storage(t, fresh)
        if new and fresh:
            size = op_walk._block_bytes(t.untyped_storage().nbytes())
            self.holders[key] = (size, self._op, tuple(t.shape), str(t.dtype))
            if self.snapshot is None and self.target is not None and self._live >= self.target:
                self.snapshot = list(self.holders.values())
        return sid

    def _dead(self, key, size):
        self.holders.pop(key, None)
        super()._dead(key, size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--attn-mode", default="auto", choices=["auto", "tp", "sp", "sp_ring"])
    ap.add_argument("--set", action="append", default=[], help="cfg override k=v")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cell = dict(attn_mode=args.attn_mode, sets=args.set, verbose=False)
    op_walk.OpWalk, plain = PeakWalk, op_walk.OpWalk
    try:
        first = dryrun.lower_cell(args.arch, args.shape, **cell)
        PeakWalk.target = first["memory"]["peak_live_bytes"]
        dryrun.lower_cell(args.arch, args.shape, **cell)
    finally:
        op_walk.OpWalk = plain
    print(first["memory"])
    snap = PeakWalk.last.snapshot or []
    groups = collections.defaultdict(lambda: [0, 0])
    for size, op, shape, dtype in snap:
        groups[(op, shape, dtype)][0] += 1
        groups[(op, shape, dtype)][1] += size
    print(f"live at the peak: {sum(s for s, *_ in snap) / 1e9:.3f} GB in {len(snap)} storages")
    for (op, shape, dtype), (n, size) in sorted(groups.items(), key=lambda kv: -kv[1][1])[
            :args.top]:
        print(f"  {size / 1e9:9.3f} GB  {n:4d} x {op} {shape} {dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
