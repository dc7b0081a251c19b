"""The benchmark's plain reference held against the port at a tiny size
on the CPU: the same corpus, index, features, forest, streams, pools,
second stage and served lists, bit for bit."""

import numpy as np
import pytest
import torch

from portbench import bench, check, tiny
from portbench.reference import corpus as ref_corpus
from portbench.reference import features as ref_feat
from portbench.reference import forest as ref_forest
from portbench.reference import retrieval as ref_ret

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["rho-open", "k-open"])
def system(request):
    from portbench import port
    spec = tiny.spec(request.param)
    cfg = spec["config"]
    inputs = bench.make_inputs(cfg, bench.seed_streams(20240917), CPU, {})
    server, backend, service = port.build(inputs, cfg, spec["traffic"], CPU)
    return cfg, inputs, server


def test_corpus_and_queries_are_the_recipe():
    from repro_torch.retrieval import corpus as pc
    mine = ref_corpus.make_corpus(900, 3000, mean_doc_len=60.0,
                                  sigma_doc_len=0.6, zipf_s=1.07, seed=11)
    port = pc.make_corpus(pc.CorpusConfig(n_docs=900, vocab=3000,
                                          mean_doc_len=60.0, seed=11))
    for k in ("doc_ids", "term_ids", "counts", "doc_len"):
        assert np.array_equal(getattr(mine, k), getattr(port, k)), k
    q = ref_corpus.make_queries(mine, 50, max_len=5, seed=12)
    assert np.array_equal(q, pc.make_queries(port, 50, 5, seed=12).terms)


def test_index_is_the_ports(system):
    cfg, inputs, server = system
    eng, ix = server.engine, inputs.index
    assert np.array_equal(eng.offsets.numpy(), ix.offsets)
    assert np.array_equal(eng.pdoc.numpy(), ix.doc)
    assert np.array_equal(eng.pimp.numpy(), ix.impact.astype(np.float32))
    assert np.array_equal(eng.pscore.numpy(), ix.score)
    assert np.array_equal(server.stats.numpy(), ix.stats)
    assert np.array_equal(server.df.numpy(), ix.df)
    assert np.array_equal(server.ctf.numpy(), ix.ctf)


def test_features_forest_and_classes(system):
    from repro_torch.core import cascade as pcas
    from repro_torch.core import features as pfeat
    from repro_torch.core import forest as pforest
    cfg, inputs, server = system
    ix = inputs.index.tensors(CPU)
    qt = torch.from_numpy(inputs.served[:64])
    got = ref_feat.features(qt, ix["stats"], ix["ctf"], ix["df"])
    want = pfeat.query_features(qt, server.stats, server.ctf, server.df)
    assert torch.equal(got, want)
    x = ref_feat.features(torch.from_numpy(inputs.train), ix["stats"],
                          ix["ctf"], ix["df"]).numpy()
    y = (inputs.labels > 2).astype(np.int64)
    kw = cfg["forest"]
    mine = ref_forest.fit_forest(x, y, n_classes=2, seed=5, **kw)
    port = pforest.train_forest(x, y, n_classes=2, seed=5,
                                **{k: kw[k] for k in kw})
    for k in ref_forest.TABLES:
        assert np.array_equal(mine[k], getattr(port, k)), k
    casc = pcas.Cascade("forest", [],
                        [{k: torch.from_numpy(v) for k, v in t.items()}
                         for t in inputs.cascade],
                        kw["max_depth"], len(cfg["cutoffs"]))
    want = pcas.predict_batched(casc, got, cfg["threshold"])
    mine = ref_forest.classes(inputs.cascade, got,
                              max_depth=kw["max_depth"],
                              threshold=cfg["threshold"])
    assert torch.equal(mine.to(torch.int32), want)


def test_streams_pools_and_stage2(system):
    from repro_torch.retrieval import gold, jass
    cfg, inputs, server = system
    eng = server.engine
    ix = inputs.index.tensors(CPU)
    qt = torch.from_numpy(inputs.served[:40])
    cap = cfg["stream_cap"]
    d, i = ref_ret.stream(ix, qt, cap)
    pd, pi = jass.gather_streams(eng.offsets, eng.pdoc, eng.pimp, qt, cap)
    assert torch.equal(d.to(torch.int32), pd) and torch.equal(i, pi)
    rho = torch.tensor([8, 30, 64, cap] * 10)
    acc = ref_ret.accumulate(d, i, rho, eng.n_docs)
    assert torch.equal(acc, jass.saat_scores_masked(pd, pi, rho, eng.n_docs))
    assert torch.equal(ref_ret.top_docs(acc, 100).to(torch.int32),
                       jass.rank_from_scores(acc, 100))
    qids = torch.arange(40)
    s2 = ref_ret.stage2(ix, qt, cap, qids)
    sd, s3 = jass.gather_score_streams(eng.offsets, eng.pdoc, eng.pscore, qt,
                                       cap)
    a = jass.scorer_accumulators(sd, s3, eng.n_docs, n_terms=qt.shape[1])
    want = gold.second_stage_scores(*a, eng.doc_len, qids)
    assert torch.equal(s2, want)
    pool = ref_ret.top_docs(acc, 100)
    assert torch.equal(ref_ret.rerank(s2, pool, 100).to(torch.int32),
                       gold.rerank_pool(want, pool, 100))


def test_served_batches_judged_clean(system):
    cfg, inputs, server = system
    ix = inputs.index.tensors(CPU)
    for b in (13, 32):
        qt = inputs.served[b:2 * b]
        out = server.serve_batch(qt)
        nums = check.judge(ix, inputs.cascade, cfg, qt, np.arange(b),
                           out["classes"], out["ranked"])
        assert nums == dict(class_mismatch=0.0, pool_miss=0.0,
                            score_gap=0.0)
        wrong = out["ranked"].copy()
        wrong[:, [0, 1]] = wrong[:, [1, 0]]
        assert not check.verdict(
            check.judge(ix, inputs.cascade, cfg, qt, np.arange(b),
                        out["classes"], wrong), cfg["limits"])
