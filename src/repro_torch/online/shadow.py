"""Idle-capacity shadow execution: judgment-free labels from live traffic
(the port of ``repro.online.shadow``).

The paper's twist is that cascade training needs *no relevance
judgments* — the reference is the system's own full-fidelity output
(Clarke, Culpepper & Moffat).  In production that reference is always
one re-run away: the shadow executor samples logged queries from the
telemetry ring, re-runs them through the *same* serving engine at full
fidelity (rho = P for the rho knob, k = max cutoff for the k knob), and
scores every cutoff's candidate run against that reference with MED
(``core/med``).  ``core.labeling.envelope_labels`` over the resulting
(Q, c) table is exactly the offline labeling pipeline — generated
continuously from live traffic instead of once from a frozen query log.

Because the reference and cutoff runs go through ``server.serve_fixed``,
they run the dynamic path's kernels (the parameter is data, never a
shape) on the server's device, and so do the MED scoring
(``core/med``) and the featurization (``core/features``).  Run it on
idle capacity (the controller gates on ``service.outstanding == 0``).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import features as feat_lib
from repro_torch.core import med as med_lib

__all__ = ["ShadowBatch", "ShadowExecutor", "reference_param",
           "serving_med_table"]


def reference_param(cfg) -> int:
    """The full-fidelity parameter for a serving config: exhaustive
    stream evaluation (rho knob) or the maximal candidate pool (k)."""
    return (cfg.stream_cap if cfg.knob == "rho"
            else int(max(cfg.cutoffs)))


def _med(a: np.ndarray, b: np.ndarray, metric: str, rbp_p: float,
         device: torch.device) -> np.ndarray:
    """MED of ranked lists ``a`` against ``b`` on ``device``."""
    fns = {"rbp": lambda x, y: med_lib.med_rbp(x, y, p=rbp_p),
           "dcg": med_lib.med_dcg, "err": med_lib.med_err}
    if metric not in fns:
        raise ValueError(f"unknown MED metric {metric!r}")
    ta = torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    tb = torch.from_numpy(np.ascontiguousarray(b, np.int32)).to(device)
    return fns[metric](ta, tb).cpu().numpy()


def _label_chunk(server, qt: np.ndarray, metric: str,
                 rbp_p: float) -> tuple[np.ndarray, np.ndarray]:
    """One batch of the judgment-free labeling: the full-fidelity
    reference run plus the (n, c) MED of every cutoff's run against it.
    The single definition both the offline-style table
    (``serving_med_table``) and the live shadow cycle consume — the two
    must never diverge."""
    ref_p = reference_param(server.cfg)
    ref = server.serve_fixed(qt, ref_p)["ranked"]
    med = np.zeros((qt.shape[0], len(server.cfg.cutoffs)), np.float32)
    for ci, cut in enumerate(server.cfg.cutoffs):
        if int(cut) == ref_p:
            continue                   # MED(A, A) = 0 identity, skip a run
        run = server.serve_fixed(qt, int(cut))["ranked"]
        med[:, ci] = _med(run, ref, metric, rbp_p, server.device)
    return ref, med


def _label_chunk_depth(server, qt: np.ndarray, ref: np.ndarray,
                       metric: str, rbp_p: float) -> np.ndarray:
    """Depth-knob analog of ``_label_chunk``: the (n, d) MED of every
    depth cutoff's run — the primary knob pinned at its reference, the
    rerank masked to the depth prefix — against the same full-fidelity
    reference.  This *is* the primary labeling code path with the knob
    swapped (the registry's MED-vs-own-reference contract): the depth
    reference is the full pool, where the mask is a no-op, so the
    already-computed ``ref`` run serves as that column's identity."""
    cfg = server.cfg
    ref_p = reference_param(cfg)
    full = cfg.depth_pool_width
    dmed = np.zeros((qt.shape[0], len(cfg.depth_cutoffs)), np.float32)
    for di, d in enumerate(cfg.depth_cutoffs):
        if int(d) == full:
            continue                   # no-op mask: MED(A, A) = 0
        run = server.serve_fixed(qt, ref_p, depth=int(d))["ranked"]
        dmed[:, di] = _med(run, ref, metric, rbp_p, server.device)
    return dmed


def serving_med_table(server, query_terms: np.ndarray, *,
                      batch: int = 128, metric: str = "rbp",
                      rbp_p: float = 0.95) -> np.ndarray:
    """(Q, c) MED of each cutoff's served run against the full-fidelity
    reference, through the live engine.

    This is the judgment-free label table of the paper computed with the
    *serving* semantics (candidate generation + rerank at depth) rather
    than the offline gold machinery — the two agree on trend, and only
    this one is computable from production traffic."""
    qt = np.asarray(query_terms, np.int32)
    out = np.zeros((qt.shape[0], len(server.cfg.cutoffs)), np.float32)
    for lo in range(0, qt.shape[0], batch):
        chunk = qt[lo:lo + batch]
        _, out[lo:lo + chunk.shape[0]] = _label_chunk(server, chunk,
                                                      metric, rbp_p)
    return out


@dataclasses.dataclass
class ShadowBatch:
    """One labeled sample of live traffic (the trainer's input unit)."""

    features: np.ndarray           # (n, F) static pre-retrieval features
    med: np.ndarray                # (n, c) judgment-free MED label table
    observed_med: np.ndarray       # (n,) MED of the *served* list vs ref
    served_class: np.ndarray       # (n,) class the live predictor chose
    predictor_version: np.ndarray  # (n,) version that served each query
    t_wall: float
    max_seq: int                   # newest telemetry seq consumed
    # secondary knobs (e.g. "depth"), labeled from the same reference
    # run: knob -> {"med": (n, c') table, "observed_med": (n,) MED at
    # the logged class, "served_class": (n,)}.  Empty when only the
    # primary knob is live.
    med_by_knob: dict = dataclasses.field(default_factory=dict)


class ShadowExecutor:
    """Re-runs sampled logged queries at full fidelity and labels them.

    ``run_once`` is one shadow cycle: sample unread records from the
    telemetry ring, compute the reference + per-cutoff runs and the MED
    table, featurize, and return a ``ShadowBatch`` (or None when there
    is nothing new to label).

    ``importance=True`` labels hard queries first: each cycle reads a
    ``pool_factor`` x oversized window of unread records, scores every
    query's cascade *margin* (``server.predict_margin`` — distance to
    the nearest exit threshold), and keeps the n smallest-margin
    queries.  Label budget concentrates where the predictor is least
    certain; the cursor advances past the whole window either way, so
    selection is deterministic for a given telemetry stream and the
    unselected remainder is skipped, not deferred."""

    def __init__(self, server, telemetry, *, sample: int = 64,
                 metric: str = "rbp", rbp_p: float = 0.95,
                 seed: int = 0, resample: bool = False,
                 importance: bool = False, pool_factor: int = 4):
        self.server = server
        self.telemetry = telemetry
        self.sample = sample
        self.metric = metric
        self.rbp_p = rbp_p
        self.resample = resample       # allow re-labeling old records
        self.importance = importance
        self.pool_factor = max(1, int(pool_factor))
        self._rng = np.random.default_rng(seed)
        self._cursor = 0               # telemetry seq consumed so far
        self.n_labeled = 0
        self.n_cycles = 0

    def _take(self, n: int):
        """Pick this cycle's records (handles all three sampling modes)."""
        if self.resample:
            return self.telemetry.sample(n, self._rng)
        if not self.importance:
            # oldest-unread-first: full coverage while labeling keeps up
            # with traffic; under overload the ring overwrites the tail
            # and n_dropped accounts for it
            return self.telemetry.take_unread(n, min_seq=self._cursor)
        pool = self.telemetry.take_unread(n * self.pool_factor,
                                          min_seq=self._cursor)
        if len(pool) <= n:
            return pool
        # consume the whole pool: unselected records are skipped for
        # good, keeping the cursor (and thus the selection) a pure
        # function of the telemetry stream
        self._cursor = max(self._cursor, max(r.seq for r in pool) + 1)
        qt = np.stack([np.asarray(r.payload, np.int32) for r in pool])
        margin = np.asarray(self.server.predict_margin(qt))
        # stable argsort: ties break by arrival order, deterministically
        keep = np.sort(np.argsort(margin, kind="stable")[:n])
        return [pool[i] for i in keep]

    def run_once(self, n: int | None = None) -> ShadowBatch | None:
        n = self.sample if n is None else n
        recs = self._take(n)
        if not recs:
            return None
        self._cursor = max(self._cursor, max(r.seq for r in recs) + 1)
        qt = np.stack([np.asarray(r.payload, np.int32) for r in recs])
        served = np.stack([np.asarray(r.ranked) for r in recs])

        srv = self.server
        ref, med = _label_chunk(srv, qt, self.metric, self.rbp_p)
        # observed MED of what the live predictor *decided*: read the
        # label table at the logged class (tradeoff.realized_med
        # semantics).  Scoring the prediction rather than the served
        # width matters twice: (a) it is position-consistent with the
        # reference — the synthetic stage-2 scorer keys its noise on
        # batch position, so directly scoring the logged ranked list
        # (served in a different batch layout) would inflate MED with
        # layout artifacts and false-trip the drift breaker; (b) during
        # breaker fallback the *served* width is the reference itself
        # (observed MED would be identically 0 and recovery would fire
        # regardless of predictor quality) — the class column is the
        # counterfactual the recovery decision actually needs.  Records
        # without a class (non-cascade traffic) fall back to the width
        # column, then to directly scoring the logged list — computed
        # lazily, since cascade traffic never reaches it.
        cuts_arr = np.asarray(srv.cfg.cutoffs)
        observed = np.zeros(qt.shape[0], np.float32)
        direct = None
        for i, r in enumerate(recs):
            if 0 <= r.pred_class:
                observed[i] = med[i, min(r.pred_class, len(cuts_arr) - 1)]
                continue
            hit = (np.flatnonzero(cuts_arr == int(r.width))
                   if math.isfinite(r.width) else np.array([], np.int64))
            if hit.size:
                observed[i] = med[i, hit[0]]
                continue
            if direct is None:
                direct = _med(served, ref, self.metric, self.rbp_p,
                              srv.device)
            observed[i] = direct[i]
        med_by_knob = {}
        if getattr(srv, "has_depth_knob", False):
            dmed = _label_chunk_depth(srv, qt, ref, self.metric,
                                      self.rbp_p)
            dcls = np.array([getattr(r, "depth_class", -1)
                             for r in recs], np.int64)
            d_obs = np.zeros(qt.shape[0], np.float32)
            nd = len(srv.cfg.depth_cutoffs)
            for i in range(qt.shape[0]):
                if 0 <= dcls[i]:
                    d_obs[i] = dmed[i, min(int(dcls[i]), nd - 1)]
                # else: served at full depth (knob off / fallback) —
                # the reference itself, MED 0
            med_by_knob["depth"] = {"med": dmed, "observed_med": d_obs,
                                    "served_class": dcls}
        feats = feat_lib.query_features(
            torch.from_numpy(qt).to(srv.device), srv.stats, srv.ctf,
            srv.df).cpu().numpy()
        self.n_labeled += len(recs)
        self.n_cycles += 1
        return ShadowBatch(
            features=feats, med=med, observed_med=observed,
            served_class=np.array([r.pred_class for r in recs], np.int64),
            predictor_version=np.array(
                [r.predictor_version for r in recs], np.int64),
            t_wall=time.perf_counter(),
            max_seq=max(r.seq for r in recs),
            med_by_knob=med_by_knob)
