"""Versioned predictor store: the hot-swap boundary between training and
serving (the port of ``repro.online.store``).

``PredictorStore`` is constructed from the boot cascade (the *template*)
and accepts retrained cascades from ``online.trainer``.  ``publish``:

  1. checks that the retrain is swap-compatible with the template (same
     node kind, cutoff count, tree count, max depth);
  2. places the node params on the store's device and pads every forest
     node table to the shared depth-derived capacity
     (``core.cascade.place_node_params``), so all versions have
     identical parameter shapes whatever the trees grew (padding is
     inert: inference is bit-identical to the unpadded tables);
  3. waits for that device work on the publishing thread's stream
     (``device.fence``), stamps a monotone version and installs it as
     ``current`` -- so a predict on another stream (the service's
     admission thread) never reads a table still being written.

The serving side (``pipeline.RetrievalServer.swap_predictor``) swaps
the version in with one reference assignment.  Old versions are never
freed eagerly: the store keeps the last ``keep`` of them alive, so a
table a predict on another stream may still read does not go back to
the caching allocator under it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch.core import forest as forest_lib
from repro_torch.core.cascade import place_node_params
from repro_torch.device import fence, resolve_device

__all__ = ["PredictorVersion", "PredictorStore"]


@dataclasses.dataclass(frozen=True)
class PredictorVersion:
    version: int
    node_params: list              # padded, on the store's device
    thresholds: torch.Tensor       # (c,) per-node confidence thresholds
    trained_on: int                # labels in the training window
    t_publish: float


class PredictorStore:
    """Monotone versions of swap-compatible cascade parameters."""

    def __init__(self, cascade, thresholds, *, keep: int = 4, device=None):
        self.device = resolve_device(device)
        self.kind = cascade.kind
        self.n_cutoffs = cascade.n_cutoffs
        self.max_depth = cascade.max_depth
        if self.kind == "forest":
            self.capacity = forest_lib.node_capacity(self.max_depth)
            self.n_trees = int(cascade.node_params[0]["feature"].shape[0])
        else:
            self.capacity = None
            self.n_trees = None
        self.keep = keep
        self._lock = threading.Lock()
        self._versions: list[PredictorVersion] = []
        self._current: PredictorVersion | None = None
        self._next_version = 0
        self.publish(cascade, thresholds, trained_on=0)

    # -------------------------------------------------------- validation --
    def _check_compatible(self, cascade) -> None:
        if cascade.kind != self.kind:
            raise ValueError(
                f"retrained cascade kind {cascade.kind!r} != template "
                f"{self.kind!r}")
        if cascade.n_cutoffs != self.n_cutoffs:
            raise ValueError(
                f"retrained cascade has {cascade.n_cutoffs} cutoffs, "
                f"template has {self.n_cutoffs}")
        if self.kind == "forest":
            if cascade.max_depth != self.max_depth:
                raise ValueError(
                    f"retrained max_depth {cascade.max_depth} != template "
                    f"{self.max_depth} (node capacity would change)")
            t = int(cascade.node_params[0]["feature"].shape[0])
            if t != self.n_trees:
                raise ValueError(
                    f"retrained n_trees {t} != template {self.n_trees}")

    # ----------------------------------------------------------- publish --
    def publish(self, cascade, thresholds, *,
                trained_on: int = 0) -> PredictorVersion:
        """Pad and place a retrained cascade and make it current."""
        self._check_compatible(cascade)
        padded = place_node_params(self.kind, cascade.node_params,
                                   self.max_depth, self.device)
        thr = torch.as_tensor(thresholds, dtype=torch.float32).to(
            self.device)
        if tuple(thr.shape) != (self.n_cutoffs,):
            raise ValueError(
                f"thresholds shape {tuple(thr.shape)} != "
                f"({self.n_cutoffs},)")
        # the tables are complete before any thread can see them
        fence(self.device)
        with self._lock:
            v = PredictorVersion(
                version=self._next_version,
                node_params=padded, thresholds=thr,
                trained_on=int(trained_on), t_publish=time.perf_counter())
            self._next_version += 1
            self._versions.append(v)
            if len(self._versions) > self.keep:
                self._versions = self._versions[-self.keep:]
            self._current = v
        return v

    def current(self) -> PredictorVersion:
        with self._lock:
            return self._current

    @property
    def n_published(self) -> int:
        with self._lock:
            return self._next_version

    def install(self, server, *, knob: str | None = None) -> int:
        """Swap the current version into a server's live predict path
        (``knob`` names a registry entry, default the primary).  Returns
        the installed version number."""
        v = self.current()
        server.swap_predictor(v.node_params, v.thresholds,
                              version=v.version, knob=knob)
        return v.version
