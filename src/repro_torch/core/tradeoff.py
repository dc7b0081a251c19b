"""Tradeoff-curve accounting (paper Tables 4-6, Figures 6-9); a copy of
``repro.core.tradeoff``.

Every method reduces to a point (mean cutoff value, mean MED).  The fixed-
cutoff baseline sweeps the 9 global settings, giving the tradeoff horizon;
a method's gain is read against the *interpolated* horizon in both
directions, exactly as the paper's tables do:

  * "Interpolated k" (efficiency view): at the method's achieved MED, how
    large a fixed cutoff would have been needed?  gain = (fixed - pred)/pred.
  * "Interpolated MED" (effectiveness view): at the method's mean cutoff,
    what MED would the fixed setting have suffered?
    gain = (fixed_med - pred_med)/pred_med.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MethodPoint", "horizon", "interp_gain", "method_point",
           "mean_cutoff_value", "pct_under_target"]


@dataclass
class MethodPoint:
    name: str
    mean_cutoff: float   # mean k (or rho) actually used
    mean_med: float


def mean_cutoff_value(pred_class: np.ndarray, cutoff_values: np.ndarray,
                      per_query_max: np.ndarray | None = None) -> float:
    """Mean parameter value implied by predicted classes.

    pred_class in [0, c]; class c (no envelope) uses the max cutoff.  If
    ``per_query_max`` is given (queries with fewer matching docs than the
    cutoff), the effective value is clipped per query.
    """
    c = len(cutoff_values)
    vals = np.asarray(cutoff_values, np.float64)[np.minimum(pred_class, c - 1)]
    if per_query_max is not None:
        vals = np.minimum(vals, per_query_max)
    return float(vals.mean())


def realized_med(med_table: np.ndarray, pred_class: np.ndarray) -> np.ndarray:
    """Per-query MED at the predicted cutoff.  med_table: (Q, c)."""
    c = med_table.shape[1]
    sel = np.minimum(np.asarray(pred_class), c - 1)
    return med_table[np.arange(len(sel)), sel]


def method_point(name: str, med_table: np.ndarray, pred_class: np.ndarray,
                 cutoff_values) -> MethodPoint:
    return MethodPoint(
        name=name,
        mean_cutoff=mean_cutoff_value(pred_class, np.asarray(cutoff_values)),
        mean_med=float(realized_med(med_table, pred_class).mean()),
    )


def horizon(med_table: np.ndarray, cutoff_values) -> list[MethodPoint]:
    """Fixed-cutoff tradeoff horizon: one point per global setting."""
    pts = []
    for i, v in enumerate(cutoff_values):
        pts.append(MethodPoint(f"fixed@{v}", float(v),
                               float(med_table[:, i].mean())))
    return pts


def _interp(xs: np.ndarray, ys: np.ndarray, x: float) -> float:
    """Piecewise-linear interpolation with end clamping (xs ascending)."""
    return float(np.interp(x, xs, ys))


def interp_gain(point: MethodPoint, hor: list[MethodPoint]) -> dict:
    """Both table views: gains vs the interpolated fixed horizon."""
    ks = np.array([p.mean_cutoff for p in hor])
    meds = np.array([p.mean_med for p in hor])
    order = np.argsort(meds)
    # efficiency view: fixed k needed to reach the method's MED
    fixed_k = _interp(meds[order], ks[order], point.mean_med)
    # effectiveness view: fixed MED at the method's mean cutoff
    order_k = np.argsort(ks)
    fixed_med = _interp(ks[order_k], meds[order_k], point.mean_cutoff)
    return {
        "method": point.name,
        "pred_med": point.mean_med,
        "pred_k": point.mean_cutoff,
        "fixed_k": fixed_k,
        "k_gain_pct": 100.0 * (fixed_k - point.mean_cutoff)
                      / max(point.mean_cutoff, 1e-9),
        "fixed_med": fixed_med,
        "med_gain_pct": 100.0 * (fixed_med - point.mean_med)
                        / max(point.mean_med, 1e-9),
    }


def pct_under_target(med_table: np.ndarray, pred_class: np.ndarray,
                     tau: float) -> float:
    """Figure 8: fraction of queries whose realized MED is in-envelope."""
    return float((realized_med(med_table, pred_class) <= tau).mean())
