"""KV-cache ledger: the serving engine's per-request lengths as a ragged
DistBag extents table.

The engine's shared KV cache is one padded capacity allocation — ``slots``
rows of ``max_len`` positions — of which each resident request occupies only
its own leading ``length`` positions.  That is *exactly* the shape of a
ragged :class:`repro_torch.core.collectives.DistBag`: uniform capacity
tiles on the wire/in memory, a per-rank (here per-slot) valid-extents table saying
how much of each tile is payload, and valid-vs-padded byte accounting that
never charges the padding to the model.  The ledger keeps that extents
table for the engine — admission control is a capacity check against it,
and the occupancy numbers it reports are the same valid/padded split the
ragged collectives report for their transfers (MPI's ``recvcounts``
picture, applied to cache residency).

The ledger is bookkeeping only: the cache buffers themselves advance their
per-row ``length`` inside the decode step (see
``repro_torch.models.attention._cache_update``); the ledger mirrors those
lengths on the host, where admission decisions are made.
"""
from __future__ import annotations

import dataclasses

__all__ = ["KVLedger"]


@dataclasses.dataclass
class KVLedger:
    """Per-slot valid lengths over a shared padded KV allocation.

    ``slots`` tiles of capacity ``max_len`` sequence positions each;
    ``bytes_per_pos`` is the cache cost of one sequence position across all
    layers (model-family dependent — pass 0 for pure-state families whose
    cache does not grow with length).
    """

    slots: int
    max_len: int
    bytes_per_pos: int
    lengths: list[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.lengths:
            self.lengths = [0] * self.slots
        if len(self.lengths) != self.slots:
            raise ValueError(f"{len(self.lengths)} lengths for {self.slots} slots")

    # ------------------------------------------------------------ admission ----
    def admit(self, slot: int, prompt_len: int, max_new: int) -> bool:
        """Admission control: a request fits slot ``slot`` iff its worst-case
        length (prompt + all new tokens) fits the slot's capacity.  Admitting
        resets the slot's extent to 0 (the prefill writes will advance it)."""
        if self.lengths[slot] != 0 and self.occupied(slot):
            return False
        if prompt_len + max_new > self.max_len:
            return False
        self.lengths[slot] = 0
        return True

    def occupied(self, slot: int) -> bool:
        return self.lengths[slot] > 0

    def advance(self, slot: int, n: int) -> None:
        self.lengths[slot] = min(self.lengths[slot] + n, self.max_len)

    def release(self, slot: int) -> None:
        self.lengths[slot] = 0

    # ------------------------------------------------- ragged-bag accounting ----
    def extents(self) -> tuple[tuple[tuple[str, int], ...], ...]:
        """The per-slot extents table in the ragged ``DistBag`` format: one
        ``(("seq", valid_len),)`` entry per slot tile."""
        return tuple((("seq", n),) for n in self.lengths)

    def valid_bytes(self) -> int:
        """Payload bytes actually holding K/V state (the v-collective count
        sum) — what a ragged cache transfer would charge the cost model."""
        return sum(self.lengths) * self.bytes_per_pos

    def padded_bytes(self) -> int:
        """Allocated bytes (capacity x slots) — what the wire/HBM holds."""
        return self.slots * self.max_len * self.bytes_per_pos

    def valid_fraction(self) -> float:
        """Occupancy: valid/padded — 1.0 when every slot is full (or when the
        family's cache does not grow with sequence length)."""
        pad = self.padded_bytes()
        return 1.0 if pad == 0 else self.valid_bytes() / pad
