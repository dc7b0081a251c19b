"""The system under test: the port's ``RetrievalService`` over
``EngineBackend(RetrievalServer)``, built from the benchmark's inputs.

The port derives its index from the corpus and serves the benchmark's
cascade tables; the benchmark adds nothing to its path but a record of
each batch (its host times, query rows and classes) and each result's
batch and row, which the stage-2 hash keys on.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.cascade import Cascade
from repro_torch.obs import NULL_TRACE, TraceRecorder
from repro_torch.retrieval.corpus import Corpus, CorpusConfig
from repro_torch.retrieval.index import build_index
from repro_torch.serving.admission import AdmissionConfig
from repro_torch.serving.pipeline import RetrievalServer, ServingConfig
from repro_torch.serving.service import (EngineBackend, RetrievalService,
                                         WarmupPolicy)


class RecordingBackend(EngineBackend):
    """``EngineBackend`` that keeps each batch's record.  Batches are
    numbered in predict order, which is also execute order (the service
    hands predicted batches to execution first in, first out)."""

    def __init__(self, server, query_len: int):
        super().__init__(server, query_len)
        self.predicts: list = []   # (t0, t1), perf_counter seconds
        self.executes: list = []   # (t0, t1, query rows, classes)

    def predict(self, qt):
        t0 = time.perf_counter()
        pred = super().predict(qt)
        self.predicts.append((t0, time.perf_counter()))
        return pred

    def execute(self, qt, pred):
        i = len(self.executes)
        t0 = time.perf_counter()
        results, timings = super().execute(qt, pred)
        self.executes.append((t0, time.perf_counter(), qt, pred[0]))
        for row, res in enumerate(results):
            res["batch"], res["row"] = i, row
        return results, timings


class BatchTrace(TraceRecorder):
    """The traced run's span recorder: it keeps the batch-scoped spans
    (``predict``, ``handoff``, ``execute``, ``engine.*``) and only stamps
    the per-request ones (``request``, ``queue``), which the per-layer
    metrics do not read, so that tracing a window of hundreds of
    thousands of requests holds a few spans a batch."""

    SKIP = frozenset(("request", "queue"))

    def begin(self, name, **kw):
        if name in self.SKIP:
            return NULL_TRACE.begin(name, **kw)
        return super().begin(name, **kw)

    def end(self, h, **attrs):
        if h is not None and h.name in self.SKIP:
            return NULL_TRACE.end(h, **attrs)
        return super().end(h, **attrs)

    def record(self, name, t0, t1, **kw):
        if name in self.SKIP:
            return None
        return super().record(name, t0, t1, **kw)


def build(inputs, cfg: dict, traffic: dict, device, obs=None):
    """The port's index, server and service for one cell, with every
    padded batch size of the admission grid warmed.  Returns (server,
    backend, service)."""
    c = inputs.corpus
    corpus = Corpus(config=CorpusConfig(
        n_docs=c.n_docs, vocab=c.vocab,
        mean_doc_len=cfg["corpus"]["mean_doc_len"],
        sigma_doc_len=cfg["corpus"]["sigma_doc_len"],
        zipf_s=cfg["corpus"]["zipf_s"]),
        doc_ids=c.doc_ids, term_ids=c.term_ids, counts=c.counts,
        doc_len=c.doc_len)
    index = build_index(corpus, device=device)
    casc = Cascade(kind="forest", nodes=[],
                   node_params=[dict(t) for t in inputs.cascade],
                   max_depth=cfg["forest"]["max_depth"],
                   n_cutoffs=len(cfg["cutoffs"]))
    scfg = ServingConfig(knob=cfg["knob"], cutoffs=tuple(cfg["cutoffs"]),
                         threshold=cfg["threshold"],
                         rerank_depth=cfg["rerank_depth"],
                         stream_cap=cfg["stream_cap"])
    server = RetrievalServer(index, casc, scfg, device=device)
    backend = RecordingBackend(server, cfg["query_len"])
    pad = server.engine.batch_multiple
    adm = AdmissionConfig(max_batch=traffic["max_batch"], pad_multiple=pad,
                          max_wait_ms=traffic["max_wait_ms"],
                          default_deadline_ms=traffic["deadline_ms"])
    service = RetrievalService(backend, adm, WarmupPolicy(census_path=None),
                               obs=obs)
    service.warmup_now(list(range(pad, traffic["max_batch"] + 1, pad)))
    return server, backend, service


def programs_built(server) -> int:
    """Programs the engine's and the predict's caches have built."""
    return server.engine.n_compiles + server.predict_programs.built()


def batch_table(backend, widths_of, stream_len, cap: int) -> dict:
    """Per batch: predict and execute host times, real rows, and the
    postings its ``impact_scan`` call accumulates."""
    pre, ex = backend.predicts, backend.executes
    n = len(ex)
    live = np.zeros(n, np.int64)
    rows = np.zeros(n, np.int64)
    for i, (_, _, qt, classes) in enumerate(ex):
        rows[i] = qt.shape[0]
        live[i] = int(np.minimum(widths_of(np.asarray(classes)),
                                 stream_len(qt, cap)).sum())
    return dict(pred_t0=np.array([p[0] for p in pre[:n]]),
                pred_t1=np.array([p[1] for p in pre[:n]]),
                exec_t0=np.array([e[0] for e in ex]),
                exec_t1=np.array([e[1] for e in ex]),
                n=rows, live=live)
