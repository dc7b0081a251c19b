"""Incremental cascade retraining on sliding windows of shadow labels
(the port of ``repro.online.trainer``).

The offline pipeline (``core.experiment``) trains once from a frozen MED
table; the online trainer keeps a bounded window of the shadow executor's
label batches and refits the cascade (``core.cascade.train_cascade`` +
``tune_thresholds``) whenever enough *new* labels have accumulated.

Refits are window-sized, optionally *warm-started*: with
``warm_frac > 0`` each forest node carries that fraction of its trees
verbatim from the previous fit and regrows only the remainder on the
new window (``forest.train_forest(warm=...)``).  The carried trees damp
fit-to-fit variance between overlapping windows and cut refit cost by
``warm_frac``, while the regrown majority still forgets a stale
distribution at roughly the window rate.  ``warm_frac=0`` (the default)
is the previous behavior — a fully fresh fit each time.  Either way the
resulting parameters are pad-compatible with the hot-swap template as
long as ``forest_kwargs`` (n_trees, max_depth) stay fixed, which this
module enforces by construction: ``PredictorStore.publish`` re-checks
the shape contract before any swap, so a warm-started fit installs into
the live predict path bit-compatibly with a cold one.  Forests are
fitted on the host; their tables and the threshold tuning's forward
pass go to the trainer's device.

The labeling tau is passed per retrain (the drift monitor owns it), so
envelope tightening/widening takes effect on the next refit without
touching the window.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core import cascade as cascade_lib
from repro_torch.core import labeling
from repro_torch.device import resolve_device

__all__ = ["TrainerConfig", "CascadeTrainer"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    window: int = 2048             # max labeled queries retained
    min_labels: int = 128          # never refit below this many
    retrain_every: int = 256       # new labels between refits
    kind: str = "forest"
    forest_kwargs: dict | None = None   # MUST stay fixed across refits
    threshold_grid: tuple = (0.6, 0.7, 0.75, 0.8, 0.85, 0.9)
    min_compliance: float = 0.95
    seed: int = 0
    warm_frac: float = 0.0         # fraction of trees carried per refit


class CascadeTrainer:
    """Sliding-window refits of the full cascade from shadow labels."""

    def __init__(self, cfg: TrainerConfig, cutoffs, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cutoffs = tuple(cutoffs)
        self._batches: collections.deque = collections.deque()
        self._n_window = 0
        self._prev = None              # last fitted cascade (warm source)
        self.labels_since_fit = 0
        self.n_labels = 0
        self.n_retrains = 0

    # ------------------------------------------------------------ window --
    def add(self, batch) -> None:
        """Append one ``ShadowBatch``; evict oldest past the window."""
        n = batch.features.shape[0]
        self._batches.append(batch)
        self._n_window += n
        self.labels_since_fit += n
        self.n_labels += n
        while (self._n_window - len(self._batches[0].features)
               >= self.cfg.window):
            old = self._batches.popleft()
            self._n_window -= old.features.shape[0]

    @property
    def window_size(self) -> int:
        return self._n_window

    def window(self) -> tuple[np.ndarray, np.ndarray]:
        """(features, med_table) over the current window."""
        x = np.concatenate([b.features for b in self._batches])
        med = np.concatenate([b.med for b in self._batches])
        return x, med

    def should_retrain(self) -> bool:
        return (self._n_window >= self.cfg.min_labels
                and self.labels_since_fit >= self.cfg.retrain_every)

    # ------------------------------------------------------------- refit --
    def retrain(self, tau: float):
        """Refit cascade + per-node thresholds on the window at ``tau``.

        Returns ``(cascade, thresholds)``.  The seed advances with the
        retrain count so successive windows don't share bootstrap draws,
        while staying deterministic for a given retrain index."""
        x, med = self.window()
        labels = labeling.envelope_labels(med, tau).numpy()
        warm = (self._prev if self.cfg.warm_frac > 0.0
                and self.cfg.kind == "forest" else None)
        casc = cascade_lib.train_cascade(
            x, labels, n_cutoffs=len(self.cutoffs), kind=self.cfg.kind,
            seed=self.cfg.seed + 1000 * (self.n_retrains + 1),
            forest_kwargs=self.cfg.forest_kwargs,
            warm=warm, warm_frac=self.cfg.warm_frac, device=self.device)
        thresholds = cascade_lib.tune_thresholds(
            casc, x, med, self.cutoffs, tau,
            grid=self.cfg.threshold_grid,
            min_compliance=self.cfg.min_compliance)
        self.n_retrains += 1
        self.labels_since_fit = 0
        self._prev = casc
        return casc, thresholds
