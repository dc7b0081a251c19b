"""Host-side slot bookkeeping for the continuous scheduler.

A ``Slot`` mirrors one row of the device-resident ``SchedState``: the
host copy of the stream position and retirement budget is authoritative
(the device never reports positions back), so advancing or retiring a
slot is host arithmetic and the hot loop makes no device round trips.

``SlotTable`` is lock-free: every access happens under the owning
``ContinuousScheduler._lock``, keeping the subsystem at one lock.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Slot", "SlotTable"]


@dataclasses.dataclass
class Slot:
    """One slot's lifecycle state.  ``req is None`` means free; a set
    ``retire_reason`` means finished but not yet finalized."""

    idx: int                          # fixed row in the SchedState tensors
    req: object | None = None         # admission.Request while occupied
    qid: int = 0                      # arrival index -> stage-2 noise key
    pred_class: int = 0               # cascade class at admission
    width: int = 0                    # predicted param (rho or k)
    depth: int = 0                    # predicted reranking depth (the
    #                                 static pool width when the depth
    #                                 knob is off: a no-op mask)
    depth_class: int = -1             # depth-cascade class (-1: knob off)
    version: int = 0                  # predictor version at admission
    end: int = 0                      # postings to execute (<= stream len)
    pos: int = 0                      # postings executed so far
    lend: int = 0                     # sharded: worst-shard local stream end
    lpos: int = 0                     # sharded: local chunk cursor
    chunks: int = 0                   # chunk dispatches while active
    predict_ms: float = 0.0           # admission-side cascade span
    t_admit: float = 0.0
    t_retire: float = 0.0
    retire_reason: str | None = None  # rho_exhausted | stream_exhausted
    #                                   | pool_complete
    occupancy: float = 0.0            # table occupancy at retirement

    @property
    def active(self) -> bool:
        return self.req is not None and self.retire_reason is None

    def reset(self) -> None:
        self.req = None
        self.qid = self.pred_class = self.width = 0
        self.depth = 0
        self.depth_class = -1
        self.version = self.end = self.pos = self.chunks = 0
        self.lend = self.lpos = 0
        self.predict_ms = self.t_admit = self.t_retire = 0.0
        self.retire_reason = None
        self.occupancy = 0.0


class SlotTable:
    """Fixed-capacity slot pool; indices are stable device rows."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.slots = [Slot(i) for i in range(self.capacity)]
        # pop() hands out low indices first (deterministic order)
        self._free = list(range(self.capacity - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_occupied(self) -> int:
        return self.capacity - len(self._free)

    def acquire(self) -> Slot:
        return self.slots[self._free.pop()]

    def release(self, slot: Slot) -> None:
        slot.reset()
        self._free.append(slot.idx)

    def occupied(self) -> list[Slot]:
        free = set(self._free)
        return [s for s in self.slots if s.idx not in free]

    def active(self) -> list[Slot]:
        return [s for s in self.occupied() if s.retire_reason is None]
