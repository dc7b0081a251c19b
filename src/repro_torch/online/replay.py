"""Replay / load-generation helpers for online-adaptation experiments
(the port of ``repro.online.replay``).

Real query logs drift: topics trend, sessions lengthen, vocabularies
shift toward the head or the tail of the collection.  The offline
harness draws queries from one fixed mid-frequency band
(``retrieval.corpus.make_queries``), so a controlled *shift* needs a
second generator.  ``shifted_queries`` draws from a different frequency
band with a different length profile — "head" queries hit long posting
lists and dense candidate overlap, "tail" queries hit sparse ones — so
the static pre-retrieval features (df/ctf/score statistics) move well
outside the boot cascade's training distribution while the corpus and
index stay fixed.

``replay`` is the micro load-generator: it feeds a query stream through
a ``RetrievalService`` in submission-order chunks (optionally
interleaving controller steps), which is what the benchmark and example
use to drive the adaptation story.
"""

from __future__ import annotations

import numpy as np

from repro_torch.retrieval import corpus as corpus_lib

__all__ = ["shifted_queries", "replay"]


def shifted_queries(corpus, n_queries: int, *, band: str = "head",
                    max_len: int = 5, seed: int = 1031):
    """A query log from a shifted term-frequency band.

    band="head": the most frequent ~2% of observed terms (the stopword
    band ``make_queries`` deliberately truncates away), weighted toward
    the very head, with longer queries.  band="tail": the rare half of
    the vocabulary, short queries.  band="long": the *same* mid-frequency
    band the boot training used, but verbose 3+-term queries (the
    "sessions lengthen" drift) — aggregate term statistics stay
    in-distribution while query length and total score mass leave it,
    which is the shift that defeats extrapolation rather than just
    exercising it."""
    rng = np.random.default_rng(seed)
    vocab = corpus.config.vocab
    df = np.bincount(corpus.term_ids, minlength=vocab)
    present = np.flatnonzero(df > 0)
    order = present[np.argsort(-df[present])]
    if band == "head":
        sel = order[:max(8, len(order) // 50)]
        w = df[sel].astype(np.float64)             # strongly head-weighted
        lengths = np.clip(rng.geometric(0.25, n_queries), 2, max_len)
    elif band == "tail":
        sel = order[len(order) // 2:]
        w = 1.0 / np.maximum(df[sel].astype(np.float64), 1.0)
        lengths = np.clip(rng.geometric(0.6, n_queries), 1, max_len)
    elif band == "long":
        # make_queries' own band (stopword band truncated, df^0.35
        # weights) — only the length profile shifts
        sel = order[max(1, len(order) // 200):]
        w = df[sel].astype(np.float64) ** 0.35
        lengths = np.full(n_queries, max_len, np.int64)
        lengths -= rng.integers(0, max(1, max_len - 2), n_queries)
    else:
        raise ValueError(
            f"unknown band {band!r} (use 'head', 'tail' or 'long')")
    w /= w.sum()
    terms = np.full((n_queries, max_len), -1, np.int32)
    flat = rng.choice(sel, size=int(lengths.sum()), p=w).astype(np.int32)
    pos = 0
    for i, ln in enumerate(lengths):
        u = np.unique(flat[pos:pos + ln])
        terms[i, :len(u)] = u
        lengths[i] = np.count_nonzero(terms[i] >= 0)
        pos += ln
    return corpus_lib.QueryLog(terms=terms,
                               lengths=lengths.astype(np.int32),
                               seed=seed)


def replay(service, query_terms: np.ndarray, *, chunk: int = 128,
           deadline_ms: float | None = None,
           controller=None, steps_per_chunk: int = 1) -> list[dict]:
    """Feed a query stream through the service in chunks, optionally
    interleaving inline controller cycles between chunks (deterministic
    stand-in for the background thread).  Returns all per-request
    results in submission order."""
    out: list[dict] = []
    qt = np.asarray(query_terms, np.int32)
    for lo in range(0, qt.shape[0], chunk):
        out.extend(service.serve_all(list(qt[lo:lo + chunk]),
                                     deadline_ms=deadline_ms))
        if controller is not None:
            for _ in range(steps_per_chunk):
                controller.step()
    return out
