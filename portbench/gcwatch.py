"""The interpreter's collector during a window: how many collections of
each generation ran and how long the process stood still for them.  The
service, its threads and the generator share one interpreter, so a
collection's pause delays every request in flight."""

from __future__ import annotations

import gc
import time


class GCWatch:
    def __init__(self):
        self.pauses: list = []      # (generation, start, seconds)
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"], self._t0,
                                time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self, t0: float, t1: float) -> dict:
        """Collections that started inside [t0, t1): count and seconds
        by generation, and the longest pause (ms)."""
        inside = [p for p in self.pauses if t0 <= p[1] < t1]
        out = {}
        for g in (0, 1, 2):
            ps = [p[2] for p in inside if p[0] == g]
            out[f"gen{g}"] = [len(ps), round(sum(ps), 6)]
        out["max_ms"] = round(max((p[2] for p in inside), default=0) * 1e3,
                              3)
        return out
