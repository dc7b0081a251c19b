"""The port's core modules (features, forest, cascade, MED, labeling)
against the JAX package's, on tiny_system.

Tolerances, with their reasons:
  * features: rtol 1e-6 (masked means and a harmonic mean in float32).
  * forest tables: identical, from the same seed (host numpy on both).
  * forest probabilities: rtol 1e-6; predicted classes: equal.  A class
    flip would be a fault, logged in ROADMAP.md section 4.
  * MED: rtol 1e-5 with an atol of 1e-6: sums of up to 2000 float32
    weights in another order; MED(A, A) is exactly 0.
  * envelope labels from one MED table: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as j_cascade
from repro.core import experiment as j_exp
from repro.core import features as j_features
from repro.core import forest as j_forest
from repro.core import labeling as j_labeling
from repro.core import med as j_med
from repro_torch import convert
from repro_torch.core import cascade as t_cascade
from repro_torch.core import experiment as t_exp
from repro_torch.core import features as t_features
from repro_torch.core import forest as t_forest
from repro_torch.core import labeling as t_labeling
from repro_torch.core import med as t_med

FOREST_KW = dict(n_trees=6, max_depth=5)


@pytest.fixture(scope="module")
def labels_k(tiny_system):
    med = j_exp.med_tables(tiny_system, "k", metrics=("rbp",))["rbp"]
    return med, np.asarray(j_labeling.envelope_labels(med, 0.05))


def _stats(sys_):
    ts = sys_.index.term_stats
    return ts.stats, ts.ctf, ts.df


def test_query_features(tiny_system):
    stats, ctf, df = _stats(tiny_system)
    qt = tiny_system.queries.terms
    j = np.asarray(j_features.query_features(
        jnp.asarray(qt), jnp.asarray(stats), jnp.asarray(ctf),
        jnp.asarray(df)))
    t = t_features.query_features(
        torch.from_numpy(qt), torch.from_numpy(stats), torch.from_numpy(ctf),
        torch.from_numpy(df)).numpy()
    assert t.shape == (len(qt), t_features.N_FEATURES)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert t_features.feature_names() == j_features.feature_names()


def test_forest_tables_identical_from_seed(tiny_system, labels_k):
    _, labels = labels_k
    y = (labels > 2).astype(np.int64)
    jf = j_forest.train_forest(tiny_system.features, y, n_classes=2,
                               seed=5, **FOREST_KW)
    tf = t_forest.train_forest(tiny_system.features, y, n_classes=2,
                               seed=5, **FOREST_KW)
    for k in ("feature", "thresh", "left", "right", "leaf"):
        a, b = getattr(jf, k), getattr(tf, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_cascade_proba_classes_and_padding(tiny_system, labels_k):
    """Carried params: the port predicts the JAX cascade's classes; the
    capacity-padded tables are bit-identical to the unpadded ones."""
    _, labels = labels_k
    casc = j_cascade.train_cascade(tiny_system.features, labels,
                                   n_cutoffs=9, forest_kwargs=FOREST_KW)
    tcasc = convert.cascade_from_numpy(
        "forest", [{k: np.asarray(v) for k, v in p.items()}
                   for p in casc.node_params],
        casc.max_depth, casc.n_cutoffs, device="cpu")
    x = np.array(tiny_system.features)
    jp = np.asarray(casc.proba0(jnp.asarray(x)))
    tp = tcasc.proba0(torch.from_numpy(x))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=0)
    for t in (0.6, 0.75, np.linspace(0.55, 0.95, 9).astype(np.float32)):
        np.testing.assert_array_equal(
            t_cascade.predict_batched(tcasc, torch.from_numpy(x), t).numpy(),
            np.asarray(j_cascade.predict_batched(casc, jnp.asarray(x), t)))
    cap = t_forest.node_capacity(casc.max_depth)
    for p in tcasc.node_params:
        padded = t_forest.pad_forest_params(p, cap)
        assert padded["feature"].shape[1] == cap
        assert torch.equal(
            t_forest.forest_predict_proba(padded, torch.from_numpy(x),
                                          casc.max_depth),
            t_forest.forest_predict_proba(p, torch.from_numpy(x),
                                          casc.max_depth))
    with pytest.raises(ValueError, match="more than the swap capacity"):
        t_forest.pad_forest_params(tcasc.node_params[0], 2)
    # the port's own trainer gives the same cascade from the same seed
    own = t_cascade.train_cascade(x, labels, n_cutoffs=9,
                                  forest_kwargs=FOREST_KW, device="cpu")
    for a, b in zip(own.node_params, tcasc.node_params):
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="NaN"):
        own.proba0(torch.full((2, 70), float("nan")))


def test_med_rbp_dcg_err(tiny_system):
    r = np.random.default_rng(11)
    qn, da, db = 12, 60, 45
    a = np.stack([r.permutation(200)[:da] for _ in range(qn)]).astype(np.int32)
    b = np.stack([np.concatenate([a[i, :20], r.permutation(200)[:db - 20]])
                  for i in range(qn)]).astype(np.int32)
    a[0, 50:] = -1
    b[1, 30:] = -1
    pairs = [(j_med.med_rbp, t_med.med_rbp), (j_med.med_dcg, t_med.med_dcg),
             (j_med.med_err, t_med.med_err)]
    for jf, tf in pairs:
        j = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        t = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
        assert (tf(torch.from_numpy(a), torch.from_numpy(a)) == 0).all()
    ta = torch.from_numpy(a)
    np.testing.assert_array_equal(
        t_med.rank_in(ta, torch.from_numpy(b)).numpy(),
        np.stack([np.asarray(j_med.rank_in(jnp.asarray(a[i]),
                                           jnp.asarray(b[i])))
                  for i in range(qn)]))
    np.testing.assert_array_equal(t_med.rbp_weights(100, 0.95).numpy(),
                                  np.asarray(j_med.rbp_weights(100, 0.95)))


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_med_tables_and_envelope_labels(tiny_system, knob):
    cfg = tiny_system.cfg
    tsys = t_exp.build_system(t_exp.ExperimentConfig(
        n_docs=cfg.n_docs, vocab=cfg.vocab, n_queries=cfg.n_queries,
        stream_cap=cfg.stream_cap, pool_depth=cfg.pool_depth,
        gold_depth=cfg.gold_depth, query_batch=cfg.query_batch,
        seed=cfg.seed), device="cpu")
    assert tsys.k_cutoffs == tiny_system.k_cutoffs
    assert tsys.rho_cutoffs == tiny_system.rho_cutoffs
    jm = j_exp.med_tables(tiny_system, knob, metrics=("rbp",))["rbp"]
    tm = t_exp.med_tables(tsys, knob, metrics=("rbp",))["rbp"]
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-6)
    for tau in (0.02, 0.05, 0.2):
        np.testing.assert_array_equal(
            t_labeling.envelope_labels(jm, tau).numpy(),
            np.asarray(j_labeling.envelope_labels(jm, tau)))
    np.testing.assert_array_equal(
        t_labeling.multiclass_to_binary(np.arange(10), 9),
        j_labeling.multiclass_to_binary(np.arange(10), 9))
