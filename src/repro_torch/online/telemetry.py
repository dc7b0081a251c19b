"""Per-request serving telemetry: the bounded ring buffer that feeds the
online adaptation loop (a copy of ``repro.online.telemetry``).

``RetrievalService`` taps every resolved request into a
``TelemetryBuffer`` (``RetrievalService(..., telemetry=buf)``): the
record carries everything the shadow executor needs to re-run the query
at full fidelity later — the raw query payload, the predicted class and
parameter actually served, the served ranked list, per-request latency,
and the predictor version that made the call.  Nothing is derived on the
hot path: features, reference runs and MED labels are all recomputed on
idle capacity by ``online.shadow``.

The buffer is a fixed-capacity ring: ``record`` is O(1) (one slot write
under a lock — no allocation growth, no compaction), old records are
overwritten once the ring wraps, and ``n_seen``/``n_dropped`` account for
the overwrite pressure so the shadow sampler knows how representative its
window is.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

__all__ = ["TelemetryRecord", "TelemetryBuffer"]


@dataclasses.dataclass
class TelemetryRecord:
    """One served request, as logged on the serving path."""

    payload: object                # raw request payload (query-term row)
    pred_class: int                # cascade class served
    width: float                   # parameter (k or rho) actually used
    ranked: np.ndarray             # served final ranked list (doc ids)
    total_ms: float                # submit -> resolve latency
    predictor_version: int         # live predictor at serve time
    t_wall: float                  # perf_counter at resolution
    seq: int = 0                   # monotone arrival index
    # continuous-scheduler retirement trail (defaults on the batch path,
    # where a request is served whole and never retired early)
    retire_reason: str | None = None   # rho_exhausted | stream_exhausted
    #                                    | pool_complete
    chunks_executed: int = 0       # stage-1 chunk dispatches this request
    chunks_max: int = 0            # padded maximum (stream_cap / chunk_p)
    slot_occupancy: float = 0.0    # table occupancy at retirement
    # depth knob (nan/-1 when off): the reranking depth actually served
    # and the depth-cascade class behind it
    depth: float = float("nan")
    depth_class: int = -1
    # join key to the trace recorder's spans (the admission seq); -1
    # when the request was served outside the admission path
    trace_id: int = -1


class TelemetryBuffer:
    """Fixed-capacity ring of ``TelemetryRecord``s, thread-safe."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._ring: list[TelemetryRecord | None] = [None] * capacity
        self._lock = threading.Lock()
        self.n_seen = 0                # records ever appended
        self.n_dropped = 0             # evicted by ring wrap (whether or
        #                                not a consumer ever read them)

    def __len__(self) -> int:
        with self._lock:
            return min(self.n_seen, self.capacity)

    def record(self, payload, result: dict, predictor_version: int,
               t_wall: float) -> None:
        """The service tap: one O(1) slot write per resolved request."""
        cls = result.get("class")
        self.append(TelemetryRecord(
            payload=payload,
            pred_class=-1 if cls is None else int(cls),
            width=float(result.get("width", float("nan"))),
            ranked=result.get("ranked"),
            total_ms=float(result.get("total_ms", float("nan"))),
            predictor_version=int(predictor_version),
            t_wall=float(t_wall),
            retire_reason=result.get("retire_reason"),
            chunks_executed=int(result.get("chunks_executed", 0)),
            chunks_max=int(result.get("chunks_max", 0)),
            slot_occupancy=float(result.get("slot_occupancy", 0.0)),
            depth=(float("nan") if result.get("depth") is None
                   else float(result["depth"])),
            depth_class=(-1 if result.get("depth_class") is None
                         else int(result["depth_class"])),
            trace_id=int(result.get("trace_id", -1)),
        ))

    def append(self, rec: TelemetryRecord) -> None:
        """The one ring write (``record`` is the dict-unpacking front)."""
        with self._lock:
            rec.seq = self.n_seen
            if self.n_seen >= self.capacity:
                self.n_dropped += 1
            self._ring[self.n_seen % self.capacity] = rec
            self.n_seen += 1

    def snapshot(self) -> list[TelemetryRecord]:
        """Current window contents in arrival order (oldest first)."""
        with self._lock:
            n = min(self.n_seen, self.capacity)
            start = self.n_seen - n
            return [self._ring[i % self.capacity]
                    for i in range(start, self.n_seen)]

    def take_unread(self, n: int,
                    min_seq: int = 0) -> list[TelemetryRecord]:
        """Oldest-first read of records with seq >= ``min_seq``.

        The shadow executor's consumption order: when labeling keeps up
        with traffic it covers *every* request exactly once (advance
        ``min_seq`` past the newest returned seq); when it cannot, the
        ring overwrites the oldest records first and ``n_dropped``
        accounts for the loss."""
        window = [r for r in self.snapshot() if r.seq >= min_seq]
        return window[:n]

    def sample(self, n: int, rng: np.random.Generator,
               min_seq: int | None = None) -> list[TelemetryRecord]:
        """Uniform sample (without replacement) from the live window.

        ``min_seq`` restricts to records at least that recent — the
        shadow executor uses it to avoid re-labeling a window it has
        already consumed.  Returns fewer than ``n`` (possibly zero)
        records when the window is short."""
        window = self.snapshot()
        if min_seq is not None:
            window = [r for r in window if r.seq >= min_seq]
        if not window:
            return []
        n = min(n, len(window))
        idx = rng.choice(len(window), size=n, replace=False)
        return [window[i] for i in sorted(idx)]
