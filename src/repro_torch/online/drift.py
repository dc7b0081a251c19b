"""Envelope drift monitoring: trust the *observed* effectiveness
envelope, not the training-time one (a copy of ``repro.online.drift``).

The cascade was tuned so realized MED stays under a target tau — but
that guarantee was estimated on the training window.  Under
distribution shift the live envelope drifts (the tail-latency lesson of
Mackenzie et al. applied to effectiveness: monitor the delivered
distribution, not the planned one).  The monitor consumes the shadow
executor's *observed* MED — the served list scored against the
full-fidelity reference, still judgment-free — and maintains:

* ``tau`` — the labeling tau handed to the next retrain.  When the
  observed envelope runs hot (EWMA above target) the labeling tau
  *narrows* so the refit becomes more conservative; when it runs well
  under target, tau *widens* back toward (and at most slightly past)
  the target to reclaim efficiency.  Bounded multiplicative steps give
  hysteresis-free smooth tracking.
* ``fallback`` — the circuit breaker.  If the observed EWMA exceeds
  ``fallback_factor`` x target, prediction is no longer trustworthy and
  the server falls back to the static global maximal parameter
  (``RetrievalServer.fallback``), i.e. the paper's fixed-cutoff
  baseline: correctness is pinned while the trainer catches up.
  Recovery requires ``recover_batches`` consecutive in-target shadow
  batches so the breaker doesn't chatter.  The observed MED the monitor
  consumes is the *predictor's decision* scored against the reference
  (``shadow.run_once`` reads the label table at the logged class), so
  during fallback the EWMA tracks the counterfactual quality of the
  still-live predictor — not the max-parameter output being served,
  which is the reference itself and would make recovery vacuous.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["DriftConfig", "DriftDecision", "EnvelopeMonitor"]


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    target: float                  # the operator's envelope target tau
    ema: float = 0.3               # EWMA weight of the newest batch
    step: float = 1.25             # max multiplicative tau move per batch
    tau_min_frac: float = 0.25     # tau never narrows below target/4
    tau_max_frac: float = 1.5      # ... nor widens past 1.5 x target
    fallback_factor: float = 3.0   # EWMA > factor*target trips fallback
    recover_batches: int = 2       # consecutive in-target batches to exit
    min_obs: int = 8               # don't act on fewer observations


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    tau: float                     # labeling tau for the next retrain
    fallback: bool                 # serve the static max-param baseline
    med_ema: float


class EnvelopeMonitor:
    """EWMA of observed MED -> (labeling tau, fallback) decisions."""

    def __init__(self, cfg: DriftConfig):
        if not (0.0 < cfg.ema <= 1.0) or cfg.step <= 1.0:
            raise ValueError("need 0 < ema <= 1 and step > 1")
        self.cfg = cfg
        self.tau = cfg.target
        self.med_ema = float("nan")
        self.fallback = False
        self.n_obs = 0
        self.n_fallbacks = 0           # breaker trips (for accounting)
        self._in_target_streak = 0

    def observe(self, observed_med: np.ndarray) -> DriftDecision:
        """Fold one shadow batch's observed MED in and decide."""
        observed_med = np.asarray(observed_med, np.float64)
        if observed_med.size:
            m = float(observed_med.mean())
            self.med_ema = (m if math.isnan(self.med_ema) else
                            (1 - self.cfg.ema) * self.med_ema
                            + self.cfg.ema * m)
            self.n_obs += observed_med.size
        return self.decide()

    def decide(self) -> DriftDecision:
        cfg = self.cfg
        if self.n_obs < cfg.min_obs or math.isnan(self.med_ema):
            return DriftDecision(self.tau, self.fallback, self.med_ema)
        # ---- circuit breaker -------------------------------------------
        if self.med_ema > cfg.fallback_factor * cfg.target:
            if not self.fallback:
                self.n_fallbacks += 1
            self.fallback = True
            self._in_target_streak = 0
        elif self.fallback:
            if self.med_ema <= cfg.target:
                self._in_target_streak += 1
                if self._in_target_streak >= cfg.recover_batches:
                    self.fallback = False
                    self._in_target_streak = 0
            else:
                self._in_target_streak = 0
        # ---- labeling tau tracking -------------------------------------
        # move tau toward target * (target / ema): hot envelope -> narrow,
        # cold envelope -> widen; each step bounded by cfg.step
        if self.med_ema > 0:
            ratio = min(max(cfg.target / self.med_ema, cfg.tau_min_frac),
                        cfg.tau_max_frac)
        else:
            ratio = cfg.tau_max_frac
        want = cfg.target * ratio
        lo, hi = self.tau / cfg.step, self.tau * cfg.step
        self.tau = float(np.clip(
            min(max(want, lo), hi),
            cfg.target * cfg.tau_min_frac, cfg.target * cfg.tau_max_frac))
        return DriftDecision(self.tau, self.fallback, self.med_ema)
