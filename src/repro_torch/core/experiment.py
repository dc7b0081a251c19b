"""Experiment harness for the paper's tables.

  1. corpus + impact-ordered index + query log,
  2. per query: gold run + candidate runs at the 9 cutoffs, MED tables
     (k knob: second-stage restriction semantics; rho knob: exhaustive
     vs anytime),
  3. the 70 static pre-retrieval features,
  4. envelope labeling at tau + stratified folds,
  5. train LRCascade + MultiLabel + MetaCost per fold (forests fitted on
     the host), predict the held-out fold on the system's device,
  6. tradeoff accounting against the fixed-cutoff horizon (Tables 4-6).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import baselines as bl
from repro_torch.core import cascade as cascade_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import labeling, med, tradeoff
from repro_torch.device import fence, resolve_device
from repro_torch.retrieval import corpus as corpus_lib
from repro_torch.retrieval import gold, index as index_lib, jass

__all__ = ["ExperimentConfig", "System", "MethodResults", "build_system",
           "med_tables", "run_methods", "K_CUTOFFS_SMALL"]

#: paper cutoffs; the harness caps k at the gold-pool depth
K_CUTOFFS_SMALL = (20, 50, 100, 200, 500, 1000, 2000, 5000, 10000)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    n_docs: int = 20_000
    vocab: int = 30_000
    n_queries: int = 2_000
    mean_doc_len: float = 180.0
    seed: int = 7
    stream_cap: int = 4096
    gold_depth: int = 1000       # evaluation depth of the ranked lists
    pool_depth: int = 10_000     # stage-1 depth feeding the gold reranker
    query_batch: int = 128
    rbp_p: float = 0.95


@dataclasses.dataclass
class System:
    cfg: ExperimentConfig
    corpus: corpus_lib.Corpus
    index: index_lib.InvertedIndex
    queries: corpus_lib.QueryLog
    features: np.ndarray         # (Q, 70)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def k_cutoffs(self) -> tuple[int, ...]:
        return tuple(min(k, self.cfg.pool_depth) for k in K_CUTOFFS_SMALL)

    @property
    def rho_cutoffs(self) -> tuple[int, ...]:
        return tuple(max(8, int(f * self.cfg.stream_cap))
                     for f in labeling.RHO_FRACTIONS)


def build_system(cfg: ExperimentConfig = ExperimentConfig(), *,
                 device=None) -> System:
    dev = resolve_device(device)
    corpus = corpus_lib.make_corpus(corpus_lib.CorpusConfig(
        n_docs=cfg.n_docs, vocab=cfg.vocab, mean_doc_len=cfg.mean_doc_len,
        seed=cfg.seed))
    index = index_lib.build_index(corpus, device=dev)
    queries = corpus_lib.make_queries(corpus, n_queries=cfg.n_queries,
                                      seed=cfg.seed + 1)
    ts = index.term_stats
    feats = feat_lib.query_features(
        torch.from_numpy(queries.terms).to(dev), ts.stats, ts.ctf, ts.df)
    return System(cfg, corpus, index, queries, feats.cpu().numpy())


def _batches(n, b):
    for s in range(0, n, b):
        yield slice(s, min(s + b, n))


def med_tables(sys: System, knob: str, metrics=("rbp", "dcg", "err"),
               progress: bool = False) -> dict[str, np.ndarray]:
    """(Q, 9) MED tables per metric for the chosen knob ('k' | 'rho'),
    computed on the system's device."""
    cfg = sys.cfg
    idx = sys.index
    dev = idx.device
    pimp = idx.postings_impact.to(torch.float32)
    cutoffs = sys.k_cutoffs if knob == "k" else sys.rho_cutoffs
    depth = min(cfg.gold_depth, cfg.pool_depth)
    qn = sys.queries.n_queries
    out = {m: np.zeros((qn, len(cutoffs)), np.float32) for m in metrics}

    for sl in _batches(qn, cfg.query_batch):
        qt = torch.from_numpy(sys.queries.terms[sl]).to(dev)
        ds, im = jass.gather_streams(idx.offsets, idx.postings_doc, pimp, qt,
                                     cap=cfg.stream_cap)
        if knob == "k":
            acc = jass.saat_scores(ds, im, cfg.n_docs, ds.shape[-1])
            deep_pool = jass.rank_from_scores(acc, min(cfg.pool_depth,
                                                       cfg.n_docs))
            sdocs, s3 = jass.gather_score_streams(
                idx.offsets, idx.postings_doc, idx.postings_score, qt,
                cap=cfg.stream_cap)
            a1, a2, a3 = jass.scorer_accumulators(sdocs, s3, cfg.n_docs,
                                                  n_terms=qt.shape[1])
            qids = torch.arange(sl.start, sl.stop, device=dev)
            stage2 = gold.second_stage_scores(a1, a2, a3, idx.doc_len, qids)
            a_run = gold.gold_run_k(stage2, deep_pool, depth)
            for ci, k in enumerate(cutoffs):
                b_run = gold.candidate_run_k(stage2, deep_pool, k, depth)
                _accumulate_med(out, metrics, sl, ci, a_run, b_run,
                                cfg.rbp_p)
        else:
            a_run = jass.saat_rank(ds, im, cfg.n_docs, ds.shape[-1], depth)
            for ci, rho in enumerate(cutoffs):
                b_run = jass.saat_rank(ds, im, cfg.n_docs, rho, depth)
                _accumulate_med(out, metrics, sl, ci, a_run, b_run,
                                cfg.rbp_p)
        if progress:
            print(f"  med[{knob}] {sl.stop}/{qn}", flush=True)
    return out


def _accumulate_med(out, metrics, sl, ci, a_run, b_run, p):
    if "rbp" in metrics:
        out["rbp"][sl, ci] = med.med_rbp(a_run, b_run, p=p).cpu().numpy()
    if "dcg" in metrics:
        out["dcg"][sl, ci] = med.med_dcg(a_run, b_run).cpu().numpy()
    if "err" in metrics:
        out["err"][sl, ci] = med.med_err(a_run, b_run).cpu().numpy()


@dataclasses.dataclass
class MethodResults:
    """Held-out predictions per method + the evaluation table rows.

    ``seconds``: wall time of the forest fitting on the host (``fit``,
    MetaCost's bagged predictions included) and of the held-out
    predictions on the device, fenced (``predict``)."""

    labels: np.ndarray
    preds: dict[str, np.ndarray]
    table: list[dict]
    horizon: list
    seconds: dict


def run_methods(sys: System, med_table: np.ndarray, cutoffs, tau: float,
                thresholds=(0.75, 0.80, 0.85), n_folds: int = 3,
                kinds=("cascade", "multilabel", "metacost"),
                forest_kwargs: dict | None = None,
                seed: int = 0) -> MethodResults:
    """Cross-validated predictions for every method (paper Tables 4-6).
    ``forest_kwargs`` reaches the cascade only; MultiLabel and MetaCost
    keep their own forest sizes, as in the JAX package."""
    dev = sys.device
    labels = labeling.envelope_labels(med_table, tau).numpy()
    c = len(cutoffs)
    folds = labeling.stratified_folds(labels, n_folds, seed=seed)
    x = sys.features
    preds: dict[str, np.ndarray] = {
        f"cascade_t{t}": np.zeros(len(labels), np.int64)
        for t in thresholds if "cascade" in kinds}
    if "multilabel" in kinds:
        preds["multilabel"] = np.zeros(len(labels), np.int64)
    if "metacost" in kinds:
        preds["metacost"] = np.zeros(len(labels), np.int64)
    seconds = {"fit": 0.0, "predict": 0.0}

    def fit(train, *args, **kw):
        t0 = time.perf_counter()
        out = train(*args, **kw)
        seconds["fit"] += time.perf_counter() - t0
        return out

    def predict(name, te, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        fence(dev)
        seconds["predict"] += time.perf_counter() - t0
        preds[name][te] = out.cpu().numpy()

    for f in range(n_folds):
        tr, te = folds != f, folds == f
        if te.sum() == 0:
            continue
        xt = torch.from_numpy(x[te]).to(dev)
        if "cascade" in kinds:
            casc = fit(cascade_lib.train_cascade, x[tr], labels[tr],
                       n_cutoffs=c, seed=seed + f,
                       forest_kwargs=forest_kwargs, device=dev)
            for t in thresholds:
                predict(f"cascade_t{t}", te, cascade_lib.predict_batched,
                        casc, xt, t)
        if "multilabel" in kinds:
            ml = fit(bl.train_multilabel, x[tr], labels[tr], c + 1,
                     seed=seed + f)
            predict("multilabel", te, bl.predict_multilabel, ml, xt)
        if "metacost" in kinds:
            mc = fit(bl.train_metacost, x[tr], labels[tr], c + 1, n_bags=5,
                     seed=seed + f, device=dev)
            predict("metacost", te, bl.predict_multilabel, mc, xt)

    hor = tradeoff.horizon(med_table, cutoffs)
    table = []
    oracle_pt = tradeoff.method_point("Oracle", med_table, labels, cutoffs)
    table.append(tradeoff.interp_gain(oracle_pt, hor))
    for name, pr in preds.items():
        pt = tradeoff.method_point(name, med_table, pr, cutoffs)
        table.append(tradeoff.interp_gain(pt, hor))
    return MethodResults(labels=labels, preds=preds, table=table,
                         horizon=hor, seconds=seconds)
