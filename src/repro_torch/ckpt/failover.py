"""Fault-tolerant training driver, copied from the JAX package's
``ckpt/failover.py``: checkpoint/restart, preemption handling, straggler
telemetry.

``run_resilient`` owns the outer loop a cluster controller runs:

  1. restore the newest checkpoint if one exists,
  2. step; periodically checkpoint asynchronously,
  3. on preemption (simulated here by an injected ``FaultPlan``),
     checkpoint synchronously and restart,
  4. repeat until the step budget completes; the tests kill training
     mid-run and require a bit-exact continuation.

A step-time EWMA watchdog flags steps slower than ``straggler_factor``
times the running mean.  ``DriverResult.ckpt_writes`` records the step,
bytes, seconds and kind ("async", "preempt" or "final") of every
checkpoint written.  The elastic restore onto another mesh is
``distrib.elastic.restore_elastic`` (``checkpoint.restore(...,
shardings=)``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.ckpt import checkpoint as ckpt

__all__ = ["FaultPlan", "DriverResult", "run_resilient"]


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for tests/demos."""

    preempt_at_steps: tuple[int, ...] = ()
    max_restarts: int = 10


@dataclasses.dataclass
class DriverResult:
    state: Any
    step: int
    restarts: int
    straggler_steps: list[int]
    metrics: list[dict]
    ckpt_writes: list[dict]


class _Preemption(Exception):
    pass


def run_resilient(
    *,
    init_state: Callable[[], Any],
    train_step: Callable[[Any, int], tuple[Any, dict]],
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 20,
    fault_plan: FaultPlan = FaultPlan(),
    straggler_factor: float = 3.0,
) -> DriverResult:
    restarts = 0
    stragglers: list[int] = []
    metrics: list[dict] = []
    writes: list[dict] = []

    def sync_save(state, step, kind):
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, state, step)
        writes.append({"step": step, "bytes": ckpt.tree_bytes(state),
                       "seconds": time.perf_counter() - t0, "kind": kind})

    while True:
        # ---- (re)start: restore or init -------------------------------
        state = init_state()
        start = 0
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state, _ = ckpt.restore(ckpt_dir, state, step=last)
            start = last
        writer = ckpt.AsyncCheckpointer(ckpt_dir)
        ewma = None
        try:
            for step in range(start, total_steps):
                if step in fault_plan.preempt_at_steps and restarts < \
                        fault_plan.max_restarts and step > start:
                    raise _Preemption(step)
                t0 = time.perf_counter()
                state, m = train_step(state, step)
                dt = time.perf_counter() - t0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if ewma and dt > straggler_factor * ewma and step > start + 3:
                    stragglers.append(step)
                m = dict(m)
                m["step"] = step
                m["step_time_s"] = dt
                metrics.append(m)
                if (step + 1) % ckpt_every == 0:
                    writer.save(state, step + 1)
            writer.wait()
            writes.extend(dict(w, kind="async") for w in writer.writes)
            sync_save(state, total_steps, "final")
            return DriverResult(state, total_steps, restarts, stragglers,
                                metrics, writes)
        except _Preemption as p:
            # emergency sync checkpoint, as a SIGTERM handler would
            writer.wait()
            writes.extend(dict(w, kind="async") for w in writer.writes)
            sync_save(state, int(str(p.args[0])), "preempt")
            restarts += 1
            fault_plan = dataclasses.replace(
                fault_plan,
                preempt_at_steps=tuple(
                    s for s in fault_plan.preempt_at_steps
                    if s != p.args[0]))
