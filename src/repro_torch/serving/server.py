"""Shared serving stats surface (a copy of ``repro.serving.server``).

``ServerStats`` is what ``RetrievalService.stats()`` returns: request
latency percentiles with the queue-delay vs service-time breakdown the
admission path exposes.  Construct the service directly:

    from repro_torch.serving.service import EngineBackend, RetrievalService
    service = RetrievalService(EngineBackend(server))
    results = service.serve_all(query_terms)
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ServerStats"]


def _pct(xs, q: float) -> float:
    """Percentile that degrades to nan on an empty sample instead of
    raising — an idle server has no latency, not a crash."""
    xs = np.asarray(xs, np.float64)
    if xs.size == 0:
        return float("nan")
    return float(np.percentile(xs, q))


@dataclasses.dataclass
class ServerStats:
    n_queries: int
    latencies_ms: list
    mean_param: float
    class_histogram: np.ndarray
    pct_in_envelope: float | None
    stage_ms: dict | None = None        # per-stage wall-clock:
    #                                     {"mean","p99","n"} per stage
    n_compiles: int | None = None       # engine program-cache size
    queue_ms: list | None = None        # per-request admission delay
    service_ms: list | None = None      # per-batch backend execute time
    n_deadline_met: int | None = None   # resolved requests, on time
    n_deadline_missed: int | None = None  # resolved requests, late
    n_cancelled: int = 0                # stop()-cancelled, never served

    @property
    def deadline_met(self) -> float:
        """Fraction of *resolved* requests that met their deadline.

        Only requests that actually produced a result count: futures
        cancelled by ``stop()`` (or otherwise never served) are tracked
        in ``n_cancelled`` and excluded, so aborting a loaded service
        does not masquerade as a deadline-miss storm."""
        met = self.n_deadline_met or 0
        missed = self.n_deadline_missed or 0
        total = met + missed
        return float("nan") if total == 0 else met / total

    @property
    def p50_ms(self) -> float:
        return _pct(self.latencies_ms, 50)

    @property
    def p99_ms(self) -> float:
        return _pct(self.latencies_ms, 99)

    def summary(self) -> str:
        env = (f" in-envelope={self.pct_in_envelope:.1%}"
               if self.pct_in_envelope is not None else "")
        stages = ""
        if self.stage_ms:
            # the p99 and sample count ride along so a stage seen in few
            # (or slow-tail) batches isn't misread as its mean
            stages = " " + " ".join(
                f"{k.removesuffix('_ms')}={v['mean']:.1f}ms"
                f"(p99={v['p99']:.1f} n={v['n']})"
                for k, v in self.stage_ms.items())
        comp = (f" compiles={self.n_compiles}"
                if self.n_compiles is not None else "")
        dl = ""
        if (self.n_deadline_met is not None
                or self.n_deadline_missed is not None):
            dl = f" deadline_met={self.deadline_met:.1%}"
            if self.n_cancelled:
                dl += f" cancelled={self.n_cancelled}"
        queue = ""
        if self.queue_ms is not None:
            # where a request's latency goes: waiting for admission vs
            # being served — the breakdown deadline tuning reads
            queue = (f" queue_p50={_pct(self.queue_ms, 50):.1f}ms"
                     f" queue_p99={_pct(self.queue_ms, 99):.1f}ms"
                     f" service_p50={_pct(self.service_ms, 50):.1f}ms")
        return (f"q={self.n_queries} p50={self.p50_ms:.1f}ms "
                f"p99={self.p99_ms:.1f}ms mean_param={self.mean_param:.0f}"
                + env + dl + queue + stages + comp)
