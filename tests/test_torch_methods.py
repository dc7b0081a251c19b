"""The offline end of the main path on the port (``run_methods``, the
baselines, threshold tuning, Algorithm 2, MED-MAP, the MLP node and the
quickstart driver) against the JAX package's, on the CPU.

The same numpy inputs go to both packages.  The JAX forest inference is
jitted here, as the JAX serving path runs it (``_jit_jax_forest``): run
op by op it retraces its scan on every call, and the reference would
cost minutes.  Tolerances, with their reasons:
  * stratified folds, cost matrix, forest tables: identical (host numpy
    on both sides, same seeds).
  * classes of a forest node, of MultiLabel and of MetaCost: equal.  The
    probabilities are means of the same leaf values; the port adds the
    trees in order and XLA in its own, so they may differ in the last
    bit (``FOREST_RTOL``), but no tie or threshold on ``tiny_system``
    falls inside that bit: every test below counts the classes that
    differ and requires 0.
  * thresholds from ``tune_thresholds``: equal (numpy on both sides, on
    probabilities that pick the same exits).
  * MED-MAP and ``med_all``: rtol 1e-5, atol 1e-6, as
    ``test_torch_core.py`` holds MED (float32 sums in another order);
    MED(A, A) is exactly 0.
  * ``run_methods``: labels and every method's predictions equal; table
    floats to rtol 1e-6 (float64 means of the same float32 cells).
  * the quickstart driver: run on the CPU in a process of its own; its
    table is ``run_methods``' (held above), so only its lines are read.
  * the MLP from carried parameters: probabilities to rtol 1e-5 / atol
    1e-6 (float32 products in another order); classes equal.  The init
    is bit-equal (the same numpy draws).  One AdamW step from the same
    init and batch moves the weights alike to atol 1e-6 (float32
    gradients in another order); a trained node is held, as the JAX
    package's own test holds it, to accuracy > 0.75.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as j_bl
from repro.core import cascade as j_cascade
from repro.core import experiment as j_exp
from repro.core import forest as j_forest
from repro.core import labeling as j_labeling
from repro.core import med as j_med
from repro.core import mlp as j_mlp
from repro_torch import convert
from repro_torch.core import baselines as t_bl
from repro_torch.core import cascade as t_cascade
from repro_torch.core import experiment as t_exp
from repro_torch.core import labeling as t_labeling
from repro_torch.core import med as t_med
from repro_torch.core import mlp as t_mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST_KW = dict(n_trees=6, max_depth=5)
FOREST_RTOL = 1e-6
TAU = 0.05
RUN_KW = dict(tau=TAU, n_folds=3, forest_kwargs=FOREST_KW)


@pytest.fixture(scope="module", autouse=True)
def _jit_jax_forest():
    mp = pytest.MonkeyPatch()
    mp.setattr(j_forest, "forest_predict_proba",
               jax.jit(j_forest.forest_predict_proba, static_argnums=2))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tsys(tiny_system):
    """The port's system from tiny_system's config, on the CPU."""
    cfg = tiny_system.cfg
    return t_exp.build_system(t_exp.ExperimentConfig(
        **dataclasses.asdict(cfg)), device="cpu")


@pytest.fixture(scope="module")
def meds(tiny_system):
    """The JAX package's MED_RBP table of each knob on tiny_system."""
    return {knob: j_exp.med_tables(tiny_system, knob, metrics=("rbp",))["rbp"]
            for knob in ("rho", "k")}


@pytest.fixture(scope="module")
def ordinal_data():
    """The synthetic ordinal problem of tests/test_core_classifiers.py."""
    rng = np.random.default_rng(1234)
    n, f, c = 1200, 20, 9
    x = rng.normal(size=(n, f)).astype(np.float32)
    score = x[:, 0] + 0.6 * x[:, 3] - 0.7 * x[:, 7]
    edges = np.quantile(score, np.linspace(0.1, 0.9, c))
    y = np.clip(np.digitize(score, edges), 0, c).astype(np.int64)
    return x, y, c


def _cutoffs(sys_, knob):
    return sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs


def _carry(casc):
    params = [jax.tree.map(np.array, p) for p in casc.node_params]
    return convert.cascade_from_numpy(casc.kind, params, casc.max_depth,
                                      casc.n_cutoffs, device="cpu")


def _same_forest(jf, tf):
    for k in ("feature", "thresh", "left", "right", "leaf"):
        a, b = getattr(jf, k), getattr(tf, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_stratified_folds_and_cost_matrix(ordinal_data, tiny_system, meds):
    _, y, c = ordinal_data
    for labels, n_folds, seed in ((y, 5, 1), (y, 3, 0), (
            np.asarray(j_labeling.envelope_labels(meds["k"], TAU)), 3, 0)):
        want = j_labeling.stratified_folds(labels, n_folds, seed=seed)
        got = t_labeling.stratified_folds(labels, n_folds, seed=seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for n in (2, 5, c + 1):
        np.testing.assert_array_equal(t_bl.cost_matrix(n),
                                      j_bl.cost_matrix(n))
    np.testing.assert_array_equal(t_bl.cost_matrix(6, 0.5, 3.0),
                                  j_bl.cost_matrix(6, 0.5, 3.0))
    assert (t_bl.oracle_predict(y) == y).all()


@pytest.mark.parametrize("data", ["ordinal", "tiny_k"])
def test_multilabel_and_metacost_match_jax(data, ordinal_data, tiny_system,
                                           meds):
    if data == "ordinal":
        x, y, c = ordinal_data
        kw = dict(n_trees=8, max_depth=6)
    else:
        x = tiny_system.features
        y = np.asarray(j_labeling.envelope_labels(meds["k"], TAU))
        c, kw = 9, {}
    jml = j_bl.train_multilabel(x, y, c + 1, seed=0, **kw)
    tml = t_bl.train_multilabel(x, y, c + 1, seed=0, **kw)
    _same_forest(jml, tml)
    jmc = j_bl.train_metacost(x, y, c + 1, n_bags=3, seed=2, **kw)
    tmc = t_bl.train_metacost(x, y, c + 1, n_bags=3, seed=2, device="cpu",
                              **kw)
    _same_forest(jmc, tmc)
    xt = torch.tensor(x)
    for jf, tf in ((jml, tml), (jmc, tmc)):
        want = np.asarray(j_bl.predict_multilabel(jf, jnp.asarray(x)))
        got = t_bl.predict_multilabel(tf, xt)
        assert got.dtype == torch.int32
        assert int((got.numpy() != want).sum()) == 0
        np.testing.assert_allclose(
            j_forest.forest_predict_proba(jf.as_jax(), jnp.asarray(x),
                                          jf.max_depth),
            t_cascade.forest_lib.forest_predict_proba(
                tf.as_torch("cpu"), xt, tf.max_depth).numpy(),
            rtol=FOREST_RTOL, atol=0)


def test_tune_thresholds_and_sequential_on_synthetic(ordinal_data):
    """JAX test_core_classifiers.py's test_variable_thresholds setup."""
    x, y, c = ordinal_data
    kw = dict(n_trees=6, max_depth=5)
    jc = j_cascade.train_cascade(x[:800], y[:800], n_cutoffs=c, seed=0,
                                 forest_kwargs=kw)
    tc = t_cascade.train_cascade(x[:800], y[:800], n_cutoffs=c, seed=0,
                                 forest_kwargs=kw, device="cpu")
    med = np.where(np.arange(c)[None, :] >= y[:, None], 0.01, 0.5)
    want = j_cascade.tune_thresholds(jc, x[800:1000], med[800:1000],
                                     list(range(c)), tau=0.05)
    got = t_cascade.tune_thresholds(tc, x[800:1000], med[800:1000],
                                    list(range(c)), tau=0.05)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    xt = torch.from_numpy(x[1000:])
    batched = t_cascade.predict_batched(tc, xt, got).numpy()
    np.testing.assert_array_equal(batched, np.asarray(
        j_cascade.predict_batched(jc, jnp.asarray(x[1000:]), want)))
    b08 = t_cascade.predict_batched(tc, xt, 0.8).numpy()
    for i in range(40):
        seq = t_cascade.predict_sequential(tc, x[1000 + i], 0.8)
        assert seq == b08[i] == j_cascade.predict_sequential(
            jc, x[1000 + i], 0.8)


def test_tune_thresholds_on_tiny_k_table(tiny_system, meds):
    x = tiny_system.features
    med = meds["k"]
    labels = np.asarray(j_labeling.envelope_labels(med, TAU))
    jc = j_cascade.train_cascade(x[:64], labels[:64], n_cutoffs=9,
                                 forest_kwargs=FOREST_KW)
    tc = t_cascade.train_cascade(x[:64], labels[:64], n_cutoffs=9,
                                 forest_kwargs=FOREST_KW, device="cpu")
    cuts = tiny_system.k_cutoffs
    for tau, comp in ((TAU, 0.95), (0.2, 0.8)):
        want = j_cascade.tune_thresholds(jc, x[64:], med[64:], cuts, tau,
                                         min_compliance=comp)
        got = t_cascade.tune_thresholds(tc, x[64:], med[64:], cuts, tau,
                                        min_compliance=comp)
        np.testing.assert_array_equal(got, want)
    for i in range(64, 96):
        assert (t_cascade.predict_sequential(tc, x[i], 0.75)
                == j_cascade.predict_sequential(jc, x[i], 0.75))


def test_med_map_and_med_all_match_jax():
    r = np.random.default_rng(5)
    qn, da, db = 10, 50, 40
    a = np.stack([r.permutation(150)[:da] for _ in range(qn)]).astype(
        np.int32)
    b = np.stack([np.concatenate([a[i, :15], r.permutation(150)[:db - 15]])
                  for i in range(qn)]).astype(np.int32)
    a[0, 40:] = -1
    b[2, 20:] = -1
    b[3] = a[3, :db]                       # b a prefix of a
    ja, jb, ta, tb = (jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a),
                      torch.from_numpy(b))
    for n_rel in (1, 3, 50):
        np.testing.assert_allclose(
            t_med.med_map(ta, tb, n_rel=n_rel).numpy(),
            np.asarray(j_med.med_map(ja, jb, n_rel=n_rel)), rtol=1e-5,
            atol=1e-6)
        assert (t_med.med_map(ta, ta, n_rel=n_rel) == 0).all()
    want = j_med.med_all(ja, jb, p=0.9, eval_depth=10)
    got = t_med.med_all(ta, tb, p=0.9, eval_depth=10)
    assert set(got) == set(want) == {"rbp", "dcg", "err", "map"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    same = t_med.med_all(ta, ta)
    assert all((v == 0).all() for v in same.values())
    disjoint = t_med.med_map(torch.arange(5)[None].int(),
                             torch.arange(100, 105)[None].int())
    assert float(disjoint[0]) == 1.0


def test_postings_of_matches_jax(tiny_system, tsys):
    ix = tiny_system.index
    for term in (0, 1, 17, ix.vocab // 2, ix.vocab - 1):
        want = ix.postings_of(term)
        got = tsys.index.postings_of(term)
        assert got == want
        np.testing.assert_array_equal(
            tsys.index.postings_doc[got].numpy(), ix.postings_doc[want])


def _assert_same_results(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int32
    assert list(got.preds) == list(want.preds)
    for name in want.preds:
        assert got.preds[name].dtype == want.preds[name].dtype == np.int64
        flips = int((got.preds[name] != want.preds[name]).sum())
        assert flips == 0, (name, flips)
    assert [r["method"] for r in got.table] == [r["method"]
                                                for r in want.table]
    for g, w in zip(got.table, want.table):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-6, atol=0)
    for g, w in zip(got.horizon, want.horizon):
        assert (g.name, g.mean_cutoff) == (w.name, w.mean_cutoff)
        np.testing.assert_allclose(g.mean_med, w.mean_med, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_methods(tiny_system, meds):
    """The JAX package's ``run_methods`` on its own system, per knob."""
    cache = {}

    def get(knob):
        if knob not in cache:
            cache[knob] = j_exp.run_methods(
                tiny_system, meds[knob], _cutoffs(tiny_system, knob),
                **RUN_KW)
        return cache[knob]

    return get


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_run_methods_matches_jax_on_one_med_table(knob, tiny_system, tsys,
                                                  meds, jax_methods):
    """The port fed the JAX MED table and the JAX features."""
    carried = dataclasses.replace(tsys, features=tiny_system.features)
    got = t_exp.run_methods(carried, meds[knob], _cutoffs(tsys, knob),
                            **RUN_KW)
    _assert_same_results(got, jax_methods(knob))
    assert set(got.seconds) == {"fit", "predict"}
    c = len(_cutoffs(tsys, knob))
    assert all(((p >= 0) & (p <= c)).all() for p in got.preds.values())


def test_run_methods_on_each_packages_own_system(tsys, jax_methods):
    """The port on its own features and its own MED table (k knob, the
    cascade: its predictions and rows do not depend on the other
    methods, so the JAX run of every method holds them)."""
    own = t_exp.med_tables(tsys, "k", metrics=("rbp",))["rbp"]
    got = t_exp.run_methods(tsys, own, tsys.k_cutoffs, kinds=("cascade",),
                            **RUN_KW)
    full = jax_methods("k")
    want = dataclasses.replace(
        full, preds={k: v for k, v in full.preds.items()
                     if k.startswith("cascade")},
        table=[r for r in full.table
               if r["method"] not in ("multilabel", "metacost")])
    _assert_same_results(got, want)


def _jax_mlp_state(m):
    return jax.tree.map(np.array, m.as_jax())


def test_mlp_init_and_one_step_match_jax(ordinal_data):
    x, y, _ = ordinal_data
    yb = (y > 4).astype(np.int64)
    sizes = (x.shape[1], 16, 8, 2)
    ji = j_mlp._init(np.random.default_rng(3), sizes)
    ti = t_mlp._init(np.random.default_rng(3), sizes)
    for a, b in zip(jax.tree.leaves(ji), jax.tree.leaves(ti)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # one AdamW step on one batch of 512, from the same init
    kw = dict(n_classes=2, hidden=(16, 8), epochs=1, batch=512, seed=3)
    jm = j_mlp.train_mlp(x[:600], yb[:600], **kw)
    tm = t_mlp.train_mlp(x[:600], yb[:600], device="cpu", **kw)
    np.testing.assert_array_equal(tm.mean, jm.mean)
    np.testing.assert_array_equal(tm.std, jm.std)
    for a, b in zip(jax.tree.leaves(jm.params), jax.tree.leaves(tm.params)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_mlp_carried_params_and_own_training(ordinal_data):
    x, y, _ = ordinal_data
    yb = (y > 4).astype(np.int64)
    jm = j_mlp.train_mlp(x, yb, n_classes=2, epochs=40, hidden=(32,),
                         lr=5e-3, seed=0)
    jp = np.asarray(j_mlp.mlp_predict_proba(jm.as_jax(), jnp.asarray(x)))
    state = convert.mlp_from_numpy(_jax_mlp_state(jm), device="cpu")
    tp = t_mlp.mlp_predict_proba(state, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tp.argmax(1), jp.argmax(1))
    # the port's own training reaches what the JAX test asks of its own
    tm = t_mlp.train_mlp(x, yb, n_classes=2, epochs=40, hidden=(32,),
                         lr=5e-3, seed=0, device="cpu")
    own = t_mlp.mlp_predict_proba(tm.as_torch("cpu"), torch.from_numpy(x))
    assert float((own.argmax(1).numpy() == yb).mean()) > 0.75
    with pytest.raises(ValueError, match="MLP state"):
        convert.mlp_from_numpy({"params": {}, "mean": 0}, device="cpu")


def test_mlp_cascade_predicts_the_jax_classes(ordinal_data):
    x, y, c = ordinal_data
    kw = dict(hidden=(16,), epochs=3)
    jc = j_cascade.train_cascade(x[:600], y[:600], n_cutoffs=c, kind="mlp",
                                 seed=0, mlp_kwargs=kw)
    tc = _carry(jc)
    assert tc.kind == "mlp" and tc.device.type == "cpu"
    xt = torch.from_numpy(x[600:])
    np.testing.assert_allclose(
        tc.proba0(xt).numpy(), np.asarray(jc.proba0(jnp.asarray(x[600:]))),
        rtol=1e-5, atol=1e-6)
    for t in (0.6, 0.8, np.linspace(0.55, 0.9, c).astype(np.float32)):
        want = np.asarray(j_cascade.predict_batched(
            jc, jnp.asarray(x[600:]), t))
        got = t_cascade.predict_batched(tc, xt, t).numpy()
        assert int((got != want).sum()) == 0
    for i in range(20):
        assert (t_cascade.predict_sequential(tc, x[600 + i], 0.8)
                == j_cascade.predict_sequential(jc, x[600 + i], 0.8))
    # the port trains an mlp cascade of its own, on its device
    own = t_cascade.train_cascade(x[:600], y[:600], n_cutoffs=c, kind="mlp",
                                  seed=0, mlp_kwargs=kw, device="cpu")
    assert own.kind == "mlp" and len(own.node_params) == c
    assert torch.equal(own.to("cpu").proba0(xt), own.proba0(xt))
    with pytest.raises(ValueError, match="unknown node kind"):
        t_cascade.train_cascade(x[:50], y[:50], n_cutoffs=c, kind="svm",
                                device="cpu")


def test_quickstart_driver_runs_on_the_cpu():
    """The port's quickstart, as a user runs it, with ``--device cpu``
    (about 11 s): the JAX example's lines, one table row per method."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))).stdout
    lines = out.splitlines()
    assert lines[0] == ("== building corpus / impact-ordered index / "
                        "query log ==")
    assert "docs=4000" in lines[1] and "queries=400" in lines[1]
    head = lines.index("   method            mean-k     MED  fixed-k    "
                       "gain")
    rows = [ln.split() for ln in lines[head + 1:head + 6]]
    assert [r[0] for r in rows] == ["Oracle", "cascade_t0.75",
                                    "cascade_t0.85", "multilabel",
                                    "metacost"]
    for r in rows:
        assert float(r[1]) > 0 and 0 <= float(r[2]) <= 1
        assert r[4].endswith("%")
