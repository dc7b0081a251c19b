"""The port's recsys funnel (layers, chunked attention, two-tower, BST,
embedding bags, the funnel itself) against the JAX package's, on the CPU.

The same numpy inputs go to both packages; parameters are drawn by each
package's own seeded init (checked equal) or carried across by
``repro_torch.convert``.  Tolerances, with their reasons:
  * inits: identical (the same numpy draws in the same order).
  * attention, BST logits, tower embeddings: rtol 1e-5 / 1e-6; float32
    products and sums run in another order than XLA's.
  * request features: the user vector, max, min, history length and
    share of distinct items equal; mean and standard deviation to rtol
    1e-6 (XLA adds a row of 64 in two halves, torch in its own order).
  * runs, labels, classes and k: equal.  Ranked lists: equal, except
    that two neighbours may swap where their stage-2 scores lie within
    STAGE2_ATOL of each other (float order again); each test reports
    such positions through ``_assert_ranked`` and fails on any other.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as j_cascade
from repro.core import knobs as j_knobs
from repro.models import attention as j_attn
from repro.models.recsys import bst as j_bst
from repro.models.recsys import embedding as j_emb
from repro.models.recsys import retrieval_tower as j_rt
from repro.serving import funnel as j_funnel
from repro_torch import convert
from repro_torch.configs import recsys as t_configs
from repro_torch.core import knobs as t_knobs
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.recsys import bst as t_bst
from repro_torch.models.recsys import embedding as t_emb
from repro_torch.models.recsys import retrieval_tower as t_rt
from repro_torch.serving import funnel as t_funnel

#: stage-2 scores of the two packages agree to ~1e-6 (float32 order)
STAGE2_ATOL = 1e-5
N_REQ = 32

# the tiny funnel of tests/test_service.py
TOWER_KW = dict(d_user_in=8, embed_dim=8, hidden=(16,), n_candidates=500)
BST_KW = dict(embed_dim=8, seq_len=6, n_heads=2, item_vocab=500, n_profile=4,
              mlp=(16, 8))
FUNNEL_KW = dict(cutoffs=(10, 20, 50), pool_depth=100, eval_depth=20,
                 tau=0.05)


def _cfgs(**funnel_kw):
    kw = dict(FUNNEL_KW, **funnel_kw)
    j = j_funnel.FunnelConfig(tower=j_rt.TowerConfig(**TOWER_KW),
                              bst=j_bst.BSTConfig(**BST_KW), **kw)
    t = t_funnel.FunnelConfig(tower=t_rt.TowerConfig(**TOWER_KW),
                              bst=t_bst.BSTConfig(**BST_KW), **kw)
    return j, t


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def carried():
    """Both packages' funnels on the same parameters, requests, runs,
    labels and cascade (the JAX-trained cascade carried by convert)."""
    jcfg, tcfg = _cfgs()
    jtower = j_rt.init_tower(jcfg.tower, seed=0)
    jbst = j_bst.init_bst(jcfg.bst, seed=1)
    rng = np.random.default_rng(0)
    uf = rng.normal(size=(N_REQ, 8)).astype(np.float32)
    hist = rng.integers(-1, 500, (N_REQ, 6)).astype(np.int32)
    gold, runs = j_funnel.funnel_gold_runs(jcfg, jtower, jbst,
                                           jnp.asarray(uf), jnp.asarray(hist))
    labels, table = j_funnel.label_requests(jcfg, gold, runs)
    feats = np.asarray(j_funnel.request_features(jnp.asarray(uf),
                                                 jnp.asarray(hist)))
    casc = j_cascade.train_cascade(
        feats, labels, n_cutoffs=len(jcfg.cutoffs),
        forest_kwargs=dict(n_trees=4, max_depth=4))
    ttower = convert.tower_from_numpy(jtower, device="cpu")
    tbst = convert.bst_from_numpy(jbst, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jtower=jtower, jbst=jbst,
                ttower=ttower, tbst=tbst, uf=uf, hist=hist, gold=gold,
                runs=runs, labels=labels, table=table, casc=casc,
                tcasc=_carry_cascade(casc))


def _carry_cascade(casc):
    return convert.cascade_from_numpy(
        "forest", [{k: np.asarray(v) for k, v in p.items()}
                   for p in casc.node_params],
        casc.max_depth, casc.n_cutoffs, device="cpu")


def _served_scores(c, tcfg, ks, depths):
    """Per request {item: stage-2 score} as the port's execute scores
    them (the pool of max(k), each request normalised over its own
    prefix min(k, depth))."""
    uf, hist = _t(c["uf"]), _t(c["hist"])
    eff = torch.minimum(_t(ks.astype(np.int64)), _t(depths.astype(np.int64)))
    ids, vals = t_rt.retrieve_topk(c["ttower"], tcfg.tower, uf,
                                   int(ks.max()))
    s2 = t_funnel._bst_scores(c["tbst"], tcfg.bst, hist, ids, vals,
                              norm_width=eff)
    return [dict(zip(i.tolist(), s.tolist())) for i, s in zip(ids, s2)]


def _assert_ranked(got, want, scores) -> int:
    """Ranked lists equal, or each differing position holds two items
    whose stage-2 scores lie within STAGE2_ATOL; returns how many
    positions differ."""
    qs, pos = np.nonzero(got != want)
    for q, i in zip(qs, pos):
        a, b = int(got[q, i]), int(want[q, i])
        assert a >= 0 and b >= 0, (q, i, a, b)
        assert abs(scores[q][a] - scores[q][b]) <= STAGE2_ATOL, (
            q, i, a, b, scores[q][a], scores[q][b])
    return len(qs)


# ------------------------------------------------------------ layers --

def test_layer_norm_matches_jax():
    from repro.models import layers as j_layers
    r = np.random.default_rng(5)
    x = r.normal(size=(6, 7, 32)).astype(np.float32) * 3 + 1
    w, b = r.normal(size=32).astype(np.float32), r.normal(size=32).astype(
        np.float32)
    j = np.asarray(j_layers.layer_norm(jnp.asarray(w), jnp.asarray(b),
                                       jnp.asarray(x)))
    t = t_layers.layer_norm(_t(w), _t(b), _t(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------- attention --

@pytest.mark.parametrize("branch", [
    dict(causal=False, window=8, block_q=16),            # window, non-causal
    dict(causal=True, window=8, block_q=16, unroll=True),   # window, causal
    dict(causal=True, block_q=16, unroll=True),          # unrolled causal
    dict(causal=True, block_q=16),                       # plain, causal
    dict(causal=False, block_q=16),                      # plain
])
@pytest.mark.parametrize("b,s,hq,hkv,hd", [(2, 40, 4, 2, 8), (3, 21, 8, 8, 4)])
def test_chunked_attention_branches_match_jax(branch, b, s, hq, hkv, hd):
    r = np.random.default_rng(s * hq + hd)
    q = r.normal(size=(b, s, hq, hd)).astype(np.float32)
    k = r.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = r.normal(size=(b, s, hkv, hd)).astype(np.float32)
    j = np.asarray(j_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **branch))
    t = t_attn.chunked_attention(_t(q), _t(k), _t(v),
                                 causal=branch["causal"],
                                 window=branch.get("window"))
    np.testing.assert_allclose(t.numpy(), j, rtol=2e-5, atol=2e-5)


def test_repeat_kv_matches_jax():
    kv = np.random.default_rng(0).normal(size=(2, 5, 3, 4)).astype(
        np.float32)
    for g in (1, 2, 4):
        np.testing.assert_array_equal(
            t_attn.repeat_kv(_t(kv), g).numpy(),
            np.asarray(j_attn.repeat_kv(jnp.asarray(kv), g)))


def test_chunked_attention_rejects_wide_value_heads():
    # no longer rejected (MLA, ROADMAP item 7b): a value head dim other
    # than the query's takes the plain path, equal to the JAX package's
    r = np.random.default_rng(1)
    q = r.normal(size=(1, 4, 2, 8)).astype(np.float32)
    v = r.normal(size=(1, 4, 2, 16)).astype(np.float32)
    got = t_attn.chunked_attention(_t(q), _t(q), _t(v))
    want = j_attn.chunked_attention(jnp.asarray(q), jnp.asarray(q),
                                    jnp.asarray(v))
    assert got.shape == (1, 4, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------------------ models --

@pytest.mark.parametrize("tower_kw", [TOWER_KW,
                                      dict(d_user_in=64, n_candidates=300)])
def test_init_tower_equals_jax(tower_kw):
    j = j_rt.init_tower(j_rt.TowerConfig(**tower_kw), seed=3)
    t = t_rt.init_tower(t_rt.TowerConfig(**tower_kw), seed=3, device="cpu")
    jl, tl = list(_leaves(j)), list(_leaves(t))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("bst_kw", [
    BST_KW, dataclasses.asdict(t_configs.bst_smoke_config())])
def test_init_bst_equals_jax(bst_kw):
    jc = j_bst.BSTConfig(**{**bst_kw, "mlp": tuple(bst_kw["mlp"])})
    j = j_bst.init_bst(jc, seed=4)
    t = t_bst.init_bst(t_bst.BSTConfig(**{**bst_kw,
                                          "mlp": tuple(bst_kw["mlp"])}),
                       seed=4, device="cpu")
    jl, tl = list(_leaves(j)), list(_leaves(t))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), a)


def test_configs_copy_the_jax_numbers():
    from repro.configs import bst as j_bst_configs
    assert dataclasses.asdict(t_configs.bst_model_config()) == \
        dataclasses.asdict(j_bst_configs.model_config())
    assert dataclasses.asdict(t_configs.bst_smoke_config()) == \
        dataclasses.asdict(j_bst_configs.smoke_config())
    assert dataclasses.asdict(t_configs.tower_config()) == \
        dataclasses.asdict(j_rt.TowerConfig())
    f = t_configs.funnel_config()
    jf = j_funnel.FunnelConfig(tower=j_rt.TowerConfig(),
                               bst=j_bst_configs.model_config())
    for name in ("cutoffs", "pool_depth", "eval_depth", "tau", "rbp_p",
                 "depth_cutoffs"):
        assert getattr(f, name) == getattr(jf, name)


def test_user_embed_and_retrieve_topk_match_jax(carried):
    c = carried
    j_u = np.asarray(j_rt.user_embed(c["jtower"], c["jcfg"].tower,
                                     jnp.asarray(c["uf"])))
    t_u = t_rt.user_embed(c["ttower"], c["tcfg"].tower, _t(c["uf"]))
    np.testing.assert_allclose(t_u.numpy(), j_u, rtol=1e-5, atol=1e-6)
    for k in (10, 100, 500):
        ji, jv = j_rt.retrieve_topk(c["jtower"], c["jcfg"].tower,
                                    jnp.asarray(c["uf"]), k)
        ti, tv = t_rt.retrieve_topk(c["ttower"], c["tcfg"].tower,
                                    _t(c["uf"]), k)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)


def test_retrieve_topk_ties_go_to_the_lower_id():
    cfg = t_rt.TowerConfig(d_user_in=2, embed_dim=2, hidden=(),
                           n_candidates=6)
    params = {"mlp": [{"w": torch.eye(2), "b": torch.zeros(2)}],
              "items": torch.tensor([[0., 1.], [1., 0.], [1., 0.], [0., 2.],
                                     [1., 0.], [.5, 0.]])}
    ids, vals = t_rt.retrieve_topk(params, cfg, torch.tensor([[1., 0.]]), 4)
    assert ids[0].tolist() == [1, 2, 4, 5]
    assert vals[0].tolist() == [1.0, 1.0, 1.0, 0.5]


def _boundary_scores():
    """Rows whose k-th score ties: 64 items at 1.0 and one at 2.0;
    mixed-sign zeros; rounded normals, heavy with ties."""
    r = np.random.default_rng(8)
    tie = np.ones(65, np.float32)
    tie[5] = 2.0
    zeros = np.full(65, -1.0, np.float32)
    zeros[:6] = [0.0, -0.0, -0.0, 0.0, 1.0, -1.0]
    zeros[[30, 31]] = [-0.0, 0.0]
    rounded = np.round(r.normal(size=(3, 65)) * 2).astype(np.float32)
    rounded[0, :9] = -0.0
    return np.stack([tie, zeros, -tie, *rounded])


@pytest.mark.parametrize("k", [1, 3, 10, 40, 65])
def test_top_k_equals_lax_top_k_at_the_boundary(k):
    """Where the k-th score ties, the lowest ids win, and +0.0 ranks
    above -0.0, as ``jax.lax.top_k`` has it (the 64-way tie selects
    [5, 0, 1] at k = 3)."""
    import jax
    scores = _boundary_scores()
    jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
    ti, tv = t_rt.top_k(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    if k == 3:
        assert ti[0].tolist() == [5, 0, 1]
        assert ti[1].tolist() == [4, 0, 3]
    # tie-free rows, and the keyed selection (the plain form) on them
    free = np.round(np.random.default_rng(k).permutation(65) - 30.0)
    free = np.stack([free, -free, free * 0.5]).astype(np.float32)
    free[:, 3] = -0.0
    jv, ji = jax.lax.top_k(jnp.asarray(free), k)
    ti, _ = t_rt.top_k(torch.from_numpy(free), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        t_rt._top_k_keyed(torch.from_numpy(free), k).numpy(), np.asarray(ji))


@pytest.mark.parametrize("bst_kw", [
    BST_KW, dataclasses.asdict(t_configs.bst_smoke_config())])
def test_bst_logits_match_jax(bst_kw):
    kw = {**bst_kw, "mlp": tuple(bst_kw["mlp"])}
    jc, tc = j_bst.BSTConfig(**kw), t_bst.BSTConfig(**kw)
    jp = j_bst.init_bst(jc, seed=2)
    tp = convert.bst_from_numpy(jp, device="cpu")
    r = np.random.default_rng(7)
    n, v = 40, kw["item_vocab"]
    hist = r.integers(0, v, (n, kw["seq_len"])).astype(np.int32)
    hist[np.arange(kw["seq_len"])[None, :] >= r.integers(
        0, kw["seq_len"] + 1, (n, 1))] = -1       # -1 tails, some empty
    batch = {"hist_items": hist,
             "target_item": r.integers(-1, v, n).astype(np.int32),
             "profile": r.normal(size=(n, kw["n_profile"])).astype(
                 np.float32)}
    j = np.asarray(j_bst.bst_logits(jp, jc, {k: jnp.asarray(a) for k, a
                                             in batch.items()}))
    t = t_bst.bst_logits(tp, tc, {k: _t(a) for k, a in batch.items()})
    assert t.dtype == torch.float32 and t.shape == (n,)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bags_match_jax(combiner):
    fields = (t_emb.FieldSpec("a", 50, 8), t_emb.FieldSpec("b", 30, 16))
    jt = j_emb.init_tables(tuple(j_emb.FieldSpec(f.name, f.vocab, f.dim)
                                 for f in fields), seed=1)
    tt = t_emb.init_tables(fields, seed=1)
    for name in jt:
        np.testing.assert_array_equal(tt[name], jt[name])
    table = jt["b"]
    r = np.random.default_rng(2)
    ids = r.integers(-1, 30, (9, 5)).astype(np.int32)
    ids[3] = -1                                         # all padding
    j = np.asarray(j_emb.bag_fixed(jnp.asarray(table), jnp.asarray(ids),
                                   combiner))
    t = t_emb.bag_fixed(_t(table), _t(ids), combiner)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)
    assert not t[3].any()
    flat = r.integers(-1, 30, 20).astype(np.int32)
    seg = np.sort(r.integers(0, 6, 20)).astype(np.int32)
    j = np.asarray(j_emb.bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                    jnp.asarray(seg), 7, combiner))
    t = t_emb.bag_ragged(_t(table), _t(flat), _t(seg), 7, combiner)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        t_emb.lookup(_t(table), _t(ids[:, 0])).numpy(),
        np.asarray(j_emb.lookup(jnp.asarray(table), jnp.asarray(ids[:, 0]))))


def test_convert_rejects_foreign_trees(carried):
    bad = dict(carried["jtower"], extra=np.zeros(1))
    with pytest.raises(ValueError, match="tower params"):
        convert.tower_from_numpy(bad, device="cpu")
    blk = dict(carried["jbst"]["blocks"][0])
    blk.pop("wo")
    with pytest.raises(ValueError, match="BST block"):
        convert.bst_from_numpy(dict(carried["jbst"], blocks=[blk]),
                               device="cpu")


# ------------------------------------------------------------ funnel --

def test_request_features_match_jax(carried):
    c = carried
    j = np.asarray(j_funnel.request_features(jnp.asarray(c["uf"]),
                                             jnp.asarray(c["hist"])))
    t = t_funnel.request_features(_t(c["uf"]), _t(c["hist"])).numpy()
    d = c["uf"].shape[1]
    assert t.shape == j.shape == (N_REQ, d + 6)
    exact = list(range(d)) + [d + 2, d + 3, d + 4, d + 5]
    np.testing.assert_array_equal(t[:, exact], j[:, exact])
    np.testing.assert_allclose(t[:, [d, d + 1]], j[:, [d, d + 1]],
                               rtol=1e-6, atol=1e-7)


def test_gold_runs_and_labels_match_jax(carried):
    c = carried
    gold, runs = t_funnel.funnel_gold_runs(c["tcfg"], c["ttower"], c["tbst"],
                                           c["uf"], c["hist"])
    np.testing.assert_array_equal(gold.numpy(), np.asarray(c["gold"]))
    assert set(runs) == set(c["runs"])
    for k in runs:
        np.testing.assert_array_equal(runs[k].numpy(),
                                      np.asarray(c["runs"][k]))
    labels, table = t_funnel.label_requests(c["tcfg"], gold, runs)
    np.testing.assert_array_equal(labels, c["labels"])
    np.testing.assert_allclose(table, c["table"], rtol=1e-5, atol=1e-6)


def test_funnel_serve_matches_jax(carried):
    c = carried
    jf = j_funnel.Funnel(c["jcfg"], c["jtower"], c["jbst"], c["casc"])
    tf = t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"],
                         device="cpu")
    a = jf.serve(jnp.asarray(c["uf"]), jnp.asarray(c["hist"]))
    b = tf.serve(c["uf"], c["hist"])
    np.testing.assert_array_equal(b["classes"], a["classes"])
    np.testing.assert_array_equal(b["k"], a["k"])
    assert b["mean_k"] == a["mean_k"]
    assert b["ranked"].shape == (N_REQ, c["tcfg"].eval_depth)
    depths = np.full_like(b["k"], max(c["tcfg"].cutoffs))
    _assert_ranked(b["ranked"], a["ranked"],
                   _served_scores(c, c["tcfg"], b["k"], depths))
    assert set(b["timings"]) == {"predict_ms", "execute_ms", "total_ms"}


def test_funnel_serve_with_depth_cascade_matches_jax(carried):
    c = carried
    grid = j_knobs.depth_cutoffs(max(FUNNEL_KW["cutoffs"]))
    assert grid == t_knobs.depth_cutoffs(max(FUNNEL_KW["cutoffs"]))
    jcfg, tcfg = _cfgs(depth_cutoffs=grid)
    dgold, druns = j_funnel.funnel_gold_runs(
        jcfg, c["jtower"], c["jbst"], jnp.asarray(c["uf"]),
        jnp.asarray(c["hist"]), cutoffs=grid)
    dlabels, _ = j_funnel.label_requests(jcfg, dgold, druns, cutoffs=grid)
    tgold, truns = t_funnel.funnel_gold_runs(tcfg, c["ttower"], c["tbst"],
                                             c["uf"], c["hist"],
                                             cutoffs=grid)
    tlabels, _ = t_funnel.label_requests(tcfg, tgold, truns, cutoffs=grid)
    np.testing.assert_array_equal(tlabels, dlabels)
    feats = np.asarray(j_funnel.request_features(jnp.asarray(c["uf"]),
                                                 jnp.asarray(c["hist"])))
    dcasc = j_cascade.train_cascade(feats, dlabels, n_cutoffs=len(grid),
                                    forest_kwargs=dict(n_trees=4,
                                                       max_depth=4))
    jf = j_funnel.Funnel(jcfg, c["jtower"], c["jbst"], c["casc"],
                         depth_cascade=dcasc)
    tf = t_funnel.Funnel(tcfg, c["ttower"], c["tbst"], c["tcasc"],
                         depth_cascade=_carry_cascade(dcasc), device="cpu")
    a = jf.serve(jnp.asarray(c["uf"]), jnp.asarray(c["hist"]))
    b = tf.serve(c["uf"], c["hist"])
    for key in ("classes", "k", "depth_classes", "depths"):
        np.testing.assert_array_equal(b[key], a[key])
    _assert_ranked(b["ranked"], a["ranked"],
                   _served_scores(c, tcfg, b["k"], b["depths"]))


def test_funnel_depth_pinned_to_max_is_the_depth_free_funnel(carried):
    c = carried
    plain = t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"],
                            device="cpu")
    _, tcfg = _cfgs(depth_cutoffs=t_knobs.depth_cutoffs(
        max(FUNNEL_KW["cutoffs"])))
    deep = t_funnel.Funnel(tcfg, c["ttower"], c["tbst"], c["tcasc"],
                           device="cpu")
    a, b = plain.serve(c["uf"], c["hist"]), deep.serve(c["uf"], c["hist"])
    assert deep.has_depth_knob and not plain.has_depth_knob
    assert (b["depths"] == max(tcfg.cutoffs)).all()
    np.testing.assert_array_equal(a["ranked"], b["ranked"])


def test_funnel_execute_pads_narrow_pools_with_minus_one(carried):
    c = carried
    tf = t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"],
                         device="cpu")
    out = tf.execute(c["uf"][:4], c["hist"][:4], np.zeros(4, np.int32))
    assert (out["k"] == 10).all()
    assert out["ranked"].shape == (4, 20)
    assert (out["ranked"][:, 10:] == -1).all()
    assert (out["ranked"][:, :10] >= 0).all()


def test_funnel_mixed_k_batch_equals_each_request_alone(carried):
    """A batch spanning every class ranks each request as JAX does and as
    the request ranks alone at its own k: the prefix mask and the
    per-request normalisation width hide the pool of the widest k."""
    c = carried
    cuts = FUNNEL_KW["cutoffs"]
    classes = (np.arange(N_REQ) % (len(cuts) + 1)).astype(np.int32)
    tf = t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"],
                         device="cpu")
    jf = j_funnel.Funnel(c["jcfg"], c["jtower"], c["jbst"], c["casc"])
    out = tf.execute(c["uf"], c["hist"], classes)
    assert set(out["k"].tolist()) == set(cuts)
    depths = np.full_like(out["k"], max(cuts))
    scores = _served_scores(c, c["tcfg"], out["k"], depths)
    ref = jf.execute(jnp.asarray(c["uf"]), jnp.asarray(c["hist"]), classes)
    np.testing.assert_array_equal(out["k"], ref["k"])
    _assert_ranked(out["ranked"], np.asarray(ref["ranked"]), scores)
    alone = np.concatenate([
        tf.execute(c["uf"][q:q + 1], c["hist"][q:q + 1],
                   classes[q:q + 1])["ranked"] for q in range(N_REQ)])
    _assert_ranked(out["ranked"], alone, scores)


def test_funnel_checks_full_float32_products_and_sets_nothing(carried,
                                                              monkeypatch):
    c = carried
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)   # restored after
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"],
                    device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32       # left as it was
    with pytest.raises(ValueError, match="TF32"):
        t_layers.check_full_fp32_matmul(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="TF32"):
        t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"])
    t_layers.full_fp32_matmul()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    t_layers.check_full_fp32_matmul(torch.device("cuda"))


def test_funnel_defaults_to_cuda_and_raises_without_it(carried,
                                                       monkeypatch):
    c = carried
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_funnel.Funnel(c["tcfg"], c["ttower"], c["tbst"], c["tcasc"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_rt.init_tower(c["tcfg"].tower)
    with pytest.raises(ValueError, match="depth grid must end"):
        _cfgs(depth_cutoffs=(5, 20))
