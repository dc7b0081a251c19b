"""Continuous-batching scheduler (slot-based in-flight scheduling), the
port of ``repro.serving.sched``.

Replaces batch-once formation with a slot table: requests occupy slots,
stage 1 advances every active slot one posting chunk per dispatch, a
query whose predicted rho is spent (or whose k-pool scan is complete)
retires mid-flight, and freed slots refill from the admission queue at
the next stage boundary.

* ``engine.SchedPrograms`` -- the four stage functions (sgather /
  refill / chunk / finalize) and the device-resident ``SchedState``;
  ``engine.ShardedSchedPrograms`` runs them over a model-only mesh's
  partitioned streams (``SchedPrograms.for_engine`` picks).
* ``slots.SlotTable`` -- host-side slot bookkeeping (the only truth for
  stream positions; no per-chunk device readback).
* ``scheduler.ContinuousScheduler`` -- the tick loop: finalize retiring
  groups, refill free slots (deadline-first, class co-grouped), chunk
  the table.

``service.ContinuousBackend`` plugs the scheduler into
``RetrievalService``; the batch-once path stays as the bit-identity
oracle.
"""

from repro_torch.serving.sched.scheduler import ContinuousScheduler
from repro_torch.serving.sched.slots import Slot, SlotTable

__all__ = ["ContinuousScheduler", "Slot", "SlotTable"]
