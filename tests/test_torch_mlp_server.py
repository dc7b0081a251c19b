"""The port's ``RetrievalServer`` with an ``mlp`` cascade against the JAX
package's on ``tiny_system``: both servers boot the same JAX-trained MLP
nodes (carried by ``convert.cascade_from_numpy``) over the same carried
index, on both knobs, before and after a swap of new nodes.

Tolerances: the two frameworks' float32 MLP forwards round differently,
so class-0 probabilities (and the margins built from them) agree within
1e-5; classes must be equal (the test fails if a probability lands that
close to a threshold, which the fixed seeds avoid), and with equal
classes the engines give equal ranked lists bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import cascade as j_cascade
from repro.core import experiment as j_exp
from repro.core import labeling as j_labeling
from repro.serving import pipeline as j_pipeline
from repro_torch import convert
from repro_torch.core import mlp as t_mlp
from repro_torch.online.store import PredictorStore
from repro_torch.serving import pipeline as t_pipeline

from _torch_carry import carry_index

MLP_KW = dict(hidden=(16,), epochs=3, batch=32)


def _mlp_cascade(sys_, labels, n_cutoffs, seed):
    return j_cascade.train_cascade(sys_.features, labels,
                                   n_cutoffs=n_cutoffs, kind="mlp",
                                   seed=seed, mlp_kwargs=MLP_KW)


def _numpy_nodes(casc):
    return [jax.tree.map(np.array, p) for p in casc.node_params]


@pytest.fixture(scope="module")
def mlp_servers(tiny_system):
    """{knob: (JAX server, port server, labels)} with mlp cascades."""
    sys_ = tiny_system
    tindex = carry_index(sys_)
    out = {}
    for knob in ("rho", "k"):
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        med = j_exp.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
        labels = np.asarray(j_labeling.envelope_labels(med, 0.05))
        casc = _mlp_cascade(sys_, labels, len(cuts), seed=0)
        tcasc = convert.cascade_from_numpy("mlp", _numpy_nodes(casc), 0,
                                           casc.n_cutoffs, device="cpu")
        kw = dict(knob=knob, cutoffs=cuts, rerank_depth=30,
                  stream_cap=sys_.cfg.stream_cap, kernel_block_p=64,
                  kernel_block_d=512, threshold=0.5)
        out[knob] = (
            j_pipeline.RetrievalServer(
                sys_.index, casc,
                j_pipeline.ServingConfig(use_kernel=False, **kw)),
            t_pipeline.RetrievalServer(
                tindex, tcasc, t_pipeline.ServingConfig(**kw),
                device="cpu"),
            labels)
    return out


def _assert_same_serving(js, ts, qt):
    jc = js.predict_classes(qt)
    tc = ts.predict_classes(qt)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts.predict_margin(qt), js.predict_margin(qt),
                               rtol=0, atol=1e-5)
    jo, to = js.serve_batch(qt), ts.serve_batch(qt)
    np.testing.assert_array_equal(to["classes"], jo["classes"])
    np.testing.assert_array_equal(to["ranked"], jo["ranked"])
    return tc


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_mlp_cascade_serves_as_the_jax_server(tiny_system, mlp_servers,
                                              knob):
    js, ts, _ = mlp_servers[knob]
    qt = tiny_system.queries.terms[:40]
    classes = _assert_same_serving(js, ts, qt)
    # the cascade is not constant: several classes are served
    assert len(np.unique(classes)) > 1
    # serve_fixed at each served class's cutoff gives that class's lists
    # (the whole batch: stage 2's noise keys on the row)
    served = ts.serve_batch(qt)["ranked"]
    for c in np.unique(classes):
        param = int(ts.params_of(np.array([c]))[0])
        fixed = ts.serve_fixed(qt, param)["ranked"]
        np.testing.assert_array_equal(fixed,
                                      js.serve_fixed(qt, param)["ranked"])
        np.testing.assert_array_equal(fixed[classes == c],
                                      served[classes == c])


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_mlp_cascade_swaps_as_the_jax_server(tiny_system, mlp_servers,
                                             knob):
    js, ts, labels = mlp_servers[knob]
    sys_ = tiny_system
    new = _mlp_cascade(sys_, labels, js.cascade.n_cutoffs, seed=5)
    thr = np.linspace(0.4, 0.7, new.n_cutoffs).astype(np.float32)
    nodes = _numpy_nodes(new)
    vj = js.swap_predictor(nodes, thr)
    vt = ts.swap_predictor(nodes, thr)
    assert vt == vj
    try:
        _assert_same_serving(js, ts, sys_.queries.terms[40:80])
        # a swap must keep the live layout
        bad = [dict(p, mean=np.zeros(3, np.float32)) for p in nodes]
        with pytest.raises(ValueError, match="mismatch"):
            ts.swap_predictor(bad)
        with pytest.raises(ValueError, match="differ"):
            ts.swap_predictor([{"mean": p["mean"]} for p in nodes])
    finally:
        old = _numpy_nodes(js.cascade)
        js.swap_predictor(old, np.full(new.n_cutoffs, 0.5, np.float32))
        ts.swap_predictor(old, np.full(new.n_cutoffs, 0.5, np.float32))


def test_mlp_nodes_cross_through_the_store(mlp_servers):
    """``online.PredictorStore`` places mlp nodes as the server does, and
    its install swaps them in unchanged."""
    _, ts, _ = mlp_servers["rho"]
    tc = ts.cascade
    store = PredictorStore(tc, np.full(tc.n_cutoffs, 0.5, np.float32),
                           device="cpu")
    before = ts.predictor_version
    try:
        assert store.install(ts) == 0
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(5, tc.node_params[0]["mean"].shape[0])).astype(np.float32))
        for placed, own in zip(store.current().node_params, tc.node_params):
            assert torch.equal(t_mlp.mlp_predict_proba(placed, x),
                               t_mlp.mlp_predict_proba(own, x))
    finally:
        ts.swap_predictor(tc.node_params, version=before)
