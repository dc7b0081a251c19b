"""The port's retrieval modules against the JAX package's, on tiny_system.

Tolerances, with their reasons:
  * corpus, offsets, postings doc ids and impacts, streams, stage-1
    accumulators, pools and ranked lists: exact.  Impacts are
    integer-valued, and every ranking is a stable sort.
  * posting scores: rtol 1e-6.  ``log`` is computed by another float32
    implementation than XLA's, so scores may differ in the last place.
  * stage-2 scores: rtol 1e-6 (log and divide in float32).
  * scorer accumulators: exact, because both add the terms in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval import corpus as j_corpus
from repro.retrieval import gold as j_gold
from repro.retrieval import index as j_index
from repro.retrieval import jass as j_jass
from repro.retrieval import topk as j_topk
from repro_torch.retrieval import corpus as t_corpus
from repro_torch.retrieval import gold as t_gold
from repro_torch.retrieval import index as t_index
from repro_torch.retrieval import jass as t_jass
from repro_torch.retrieval import topk as t_topk


@pytest.fixture(scope="module")
def both(tiny_system):
    """tiny_system, its index built again by the port, and a batch of
    queries with their streams on both sides."""
    cfg = tiny_system.cfg
    tcorpus = t_corpus.make_corpus(t_corpus.CorpusConfig(
        n_docs=cfg.n_docs, vocab=cfg.vocab, mean_doc_len=cfg.mean_doc_len,
        seed=cfg.seed))
    tidx = t_index.build_index(tcorpus, device="cpu")
    ji = tiny_system.index
    qt = tiny_system.queries.terms[:40]
    jds, jim = j_jass.gather_streams(
        jnp.asarray(ji.offsets), jnp.asarray(ji.postings_doc),
        jnp.asarray(ji.postings_impact.astype(np.float32)), jnp.asarray(qt),
        cap=cfg.stream_cap)
    tds, tim = t_jass.gather_streams(
        tidx.offsets, tidx.postings_doc, tidx.postings_impact.float(),
        torch.from_numpy(qt), cap=cfg.stream_cap)
    return dict(sys=tiny_system, tcorpus=tcorpus, tidx=tidx, qt=qt,
                jds=jds, jim=jim, tds=tds, tim=tim)


def test_corpus_and_queries_byte_identical(both):
    sys_ = both["sys"]
    for f in ("doc_ids", "term_ids", "counts", "doc_len"):
        a, b = getattr(sys_.corpus, f), getattr(both["tcorpus"], f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jq = j_corpus.make_queries(sys_.corpus, n_queries=50, seed=4)
    tq = t_corpus.make_queries(both["tcorpus"], n_queries=50, seed=4)
    assert jq.terms.tobytes() == tq.terms.tobytes()
    assert jq.lengths.tobytes() == tq.lengths.tobytes()


def test_index_arrays(both):
    ji, ti = both["sys"].index, both["tidx"]
    np.testing.assert_array_equal(ti.offsets.numpy(), ji.offsets)
    np.testing.assert_array_equal(ti.postings_doc.numpy(), ji.postings_doc)
    np.testing.assert_array_equal(ti.postings_impact.numpy(),
                                  ji.postings_impact)
    np.testing.assert_array_equal(ti.postings_tf.numpy(), ji.postings_tf)
    np.testing.assert_allclose(ti.postings_score.numpy(), ji.postings_score,
                               rtol=1e-6, atol=0)
    # term statistics are order statistics and sums of those scores
    # (iqr = q3 - q1 cancels), so they carry the scores' last-place error
    # at the scale of each scorer's values
    js, tst = ji.term_stats.stats, ti.term_stats.stats.numpy()
    scale = np.abs(js).max(axis=(0, 2), keepdims=True)
    assert (np.abs(tst - js) <= 1e-6 * scale).all()
    np.testing.assert_array_equal(ti.term_stats.df.numpy(), ji.term_stats.df)
    np.testing.assert_array_equal(ti.term_stats.ctf.numpy(),
                                  ji.term_stats.ctf)
    assert ti.impact_scale == ji.impact_scale


def test_gather_streams_tie_order(both):
    """8-bit impacts tie everywhere; the stable sort keeps lax.top_k's
    lower-position-first order, so the same postings fall inside rho."""
    np.testing.assert_array_equal(both["tds"].numpy(), np.asarray(both["jds"]))
    np.testing.assert_array_equal(both["tim"].numpy(), np.asarray(both["jim"]))
    imps = both["tim"].numpy()
    assert (np.diff(imps, axis=1) <= 0).all()
    assert any(len(np.unique(r)) < len(r) for r in imps)     # ties exist


@pytest.mark.parametrize("use_kernel", [False, True])
def test_saat_scores_masked_and_rank(both, use_kernel):
    n_docs = both["sys"].cfg.n_docs
    p = both["tds"].shape[1]
    rho = np.random.default_rng(5).integers(0, p + 20, both["tds"].shape[0])
    rho = rho.astype(np.int32)
    ja = j_jass.saat_scores_masked(both["jds"], both["jim"],
                                   jnp.asarray(rho), n_docs)
    seg = t_index.block_doc_bounds(both["tds"], block_p=64, n_docs=n_docs)
    ta = t_jass.saat_scores_masked(both["tds"], both["tim"],
                                   torch.from_numpy(rho), n_docs,
                                   use_kernel=use_kernel, seg_bounds=seg,
                                   block_p=64, block_d=256)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for depth in (1, 37, 100):
        np.testing.assert_array_equal(
            t_jass.rank_from_scores(ta, depth).numpy(),
            np.asarray(j_jass.rank_from_scores(ja, depth)))
        np.testing.assert_array_equal(
            t_topk.select_pool(ta, depth, use_kernel=use_kernel).numpy(),
            np.asarray(j_topk.select_pool(ja, depth)))
    for rho_s in (0, 5, p):
        np.testing.assert_array_equal(
            t_jass.saat_rank(both["tds"], both["tim"], n_docs, rho_s,
                             50).numpy(),
            np.asarray(j_jass.saat_rank(both["jds"], both["jim"], n_docs,
                                        rho_s, 50)))


def test_block_doc_bounds(both):
    n_docs = both["sys"].cfg.n_docs
    for bp in (32, 100, 512):
        jl, jh = j_index.block_doc_bounds(both["jds"], block_p=bp,
                                          n_docs=n_docs)
        tl, th = t_index.block_doc_bounds(both["tds"], block_p=bp,
                                          n_docs=n_docs)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_hash_noise_uint32_wraparound():
    r = np.random.default_rng(9)
    docs = np.concatenate([r.integers(0, 2**31 - 1, 500),
                           [0, 1, 2**31 - 1, 65535, 65536]]).astype(np.int32)
    for qid, seed in [(0, 11), (7, 11), (123457, 3), (2**31 - 1, 2**31)]:
        j = j_gold._hash_noise(jnp.asarray(docs), jnp.asarray(qid), seed)
        t = t_gold._hash_noise(torch.from_numpy(docs), torch.tensor(qid),
                               seed)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _stage2_inputs(both):
    sys_ = both["sys"]
    ji, ti, qt = sys_.index, both["tidx"], both["qt"]
    cap, n_docs = sys_.cfg.stream_cap, sys_.cfg.n_docs
    jd, js = j_jass.gather_score_streams(
        jnp.asarray(ji.offsets), jnp.asarray(ji.postings_doc),
        jnp.asarray(ji.postings_score), jnp.asarray(qt), cap=cap)
    # the port reads the JAX index's scores, so both accumulate the same
    # float32 values and the comparison isolates the accumulation
    td, ts = t_jass.gather_score_streams(
        ti.offsets, ti.postings_doc, torch.from_numpy(ji.postings_score),
        torch.from_numpy(qt), cap=cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jacc = j_jass.scorer_accumulators(jd, js, n_docs)
    tacc = t_jass.scorer_accumulators(td, ts, n_docs, n_terms=qt.shape[1])
    return jacc, tacc


def test_scorer_accumulators_exact(both):
    """One scatter per term (no collisions inside a pass) reproduces
    XLA's in-order float32 sums bit for bit."""
    jacc, tacc = _stage2_inputs(both)
    for a, b in zip(jacc, tacc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_second_stage_scores_and_rerank(both):
    jacc, tacc = _stage2_inputs(both)
    doc_len = both["sys"].corpus.doc_len
    qids = np.arange(len(both["qt"]), dtype=np.int32) + 3
    js = j_gold.second_stage_scores(*jacc, jnp.asarray(doc_len),
                                    jnp.asarray(qids))
    ts = t_gold.second_stage_scores(*tacc, torch.from_numpy(doc_len),
                                    torch.from_numpy(qids))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    # rerank_pool on identical inputs: exact (stable sorts on both keys)
    n_docs = both["sys"].cfg.n_docs
    acc = np.asarray(j_jass.saat_scores(both["jds"], both["jim"], n_docs,
                                        both["jds"].shape[1]))
    pool = np.array(j_jass.rank_from_scores(jnp.asarray(acc), 200))
    s2 = np.round(np.asarray(js) * 64) / 64        # force score ties
    for depth in (10, 100, 300):
        np.testing.assert_array_equal(
            t_gold.rerank_pool(torch.from_numpy(s2), torch.from_numpy(pool),
                               depth).numpy(),
            np.asarray(j_gold.rerank_pool(jnp.asarray(s2), jnp.asarray(pool),
                                          depth)))
    for k in (20, 100):
        np.testing.assert_array_equal(
            t_gold.candidate_run_k(torch.from_numpy(s2),
                                   torch.from_numpy(pool), k, 50).numpy(),
            np.asarray(j_gold.candidate_run_k(jnp.asarray(s2),
                                              jnp.asarray(pool), k, 50)))
