"""The port's sharded continuous scheduler (``ShardedSchedPrograms``,
the ``prog.sharded`` branches of ``ContinuousScheduler``, ``Slot.lpos`` /
``Slot.lend``) on the CPU, following the JAX package's
``tests/test_sharded_sched.py`` on its 301-doc system (a ragged last
shard on 4; max_k 100 > the 4-way shard width), built by the JAX package
and carried to the port.  The mesh's positions are laid over the one
CPU with ``force_host_device_count``.

Classes come from a stub that is a pure function of the query's content
(refill groups regroup queries).  Stage-2 noise keys on the arrival
index, so each check compares with one ``engine.serve`` of the whole
stream by the port's unsharded server (itself equal to the JAX one,
``test_torch_sched``).  Tolerance: none; impacts are integer-valued, so
chunked sums are exact, and the sharded arithmetic is the unsharded one
(``test_torch_sharded``).
"""

import numpy as np
import pytest

import _torch_sharded_counts as sharded_counts
from _torch_carry import carry_index
from repro.core import experiment as j_exp
from repro_torch.analysis import sanitizers as S
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serving import engine as t_engine
from repro_torch.serving import pipeline as t_pipeline
from repro_torch.serving import service as t_service


@pytest.fixture(scope="module", autouse=True)
def positions():
    """Four mesh positions over the one CPU, for this module only."""
    mesh_lib.force_host_device_count(4)
    yield
    mesh_lib.force_host_device_count(0)


@pytest.fixture(scope="module", autouse=True)
def _jax_side():
    """The JAX sharded scheduler's warmup counts, compiled in a
    subprocess over forced host devices while the port's cases run."""
    proc = sharded_counts.start("sched")
    yield proc
    if proc.poll() is None:             # no case read it: stop it
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_counts(_jax_side):
    return sharded_counts.result(_jax_side)


@pytest.fixture(scope="module")
def system():
    sys_ = j_exp.build_system(j_exp.ExperimentConfig(
        n_docs=301, vocab=900, n_queries=40, stream_cap=128, pool_depth=100,
        gold_depth=50, query_batch=16, seed=5))
    return sys_, carry_index(sys_)


def _hash_rows(qt):
    qt = np.asarray(qt)
    return np.where(qt >= 0, qt, 0).sum(axis=1) + (qt >= 0).sum(axis=1)


def _server(system, knob, shards=None, **kw):
    sys_, tindex = system
    cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
    cfg = t_pipeline.ServingConfig(
        knob=knob, cutoffs=cuts, rerank_depth=30,
        stream_cap=sys_.cfg.stream_cap, kernel_block_p=32,
        kernel_block_d=64, **kw)
    mesh = (None if shards is None
            else mesh_lib.make_serving_mesh(shards, device="cpu"))
    srv = t_pipeline.RetrievalServer(tindex, None, cfg, device="cpu",
                                     mesh=mesh)
    n_cls = len(cuts) + 1
    srv.predict_classes = (
        lambda qt, knob=None: (_hash_rows(qt) % n_cls).astype(np.int64))
    return srv


@pytest.mark.parametrize("arm", ["dynamic", "fixed"])
@pytest.mark.parametrize("knob", ["rho", "k"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_continuous_equals_one_engine_serve(system, shards, knob,
                                                    arm):
    """``ContinuousBackend`` over a model-only mesh: every list equals one
    unsharded ``engine.serve`` of the stream (the dynamic arm) or
    ``serve_fixed`` (the fixed arm: rho at the stream cap, k at the
    largest cutoff), and every slot retires."""
    sh, oracle = _server(system, knob, shards), _server(system, knob)
    qt = system[0].queries.terms[:24]
    fixed = None
    if arm == "dynamic":
        ref, _ = oracle.engine.serve(
            qt, oracle.params_of(oracle.predict_classes(qt)))
    else:
        fixed = (sh.cfg.stream_cap if knob == "rho"
                 else int(max(sh.cfg.cutoffs)))
        ref = oracle.serve_fixed(qt, fixed)["ranked"]
    backend = t_service.ContinuousBackend(sh, slots=8, grain=4,
                                          fixed_param=fixed)
    svc = t_service.RetrievalService(backend)
    res = svc.serve_all(list(qt), deadline_ms=1e6)
    np.testing.assert_array_equal(np.stack([r["ranked"] for r in res]), ref)
    st = backend.scheduler.stats()
    assert st["sharded"] is True
    assert sum(st["retire_reasons"].values()) == 24
    assert st["chunks_max"] == sh.engine.shard_cap // backend.scheduler.prog.chunk_p
    assert backend.warmup_shape(8) == 0


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_scheduler_warmup_and_churn_build_as_the_jax_one(
        system, jax_counts, shards):
    """The warmup builds the four programs the JAX scheduler compiles on
    the same model-only mesh; ragged waves of admits and retires after
    it build nothing (``hot_path``), every list equal to the unsharded
    scheduler's on the same waves."""
    L = system[0].queries.terms.shape[1]
    svcs = []
    for srv in (_server(system, "rho", shards), _server(system, "rho")):
        backend = t_service.ContinuousBackend(srv, query_len=L, slots=8,
                                              grain=4)
        svcs.append(t_service.RetrievalService(backend))
    sh = svcs[0].backend
    assert sh.warmup_shape(8) == jax_counts[f"sched/{shards}"] > 0
    assert sh.n_compiles == jax_counts[f"sched/{shards}"]
    terms = system[0].queries.terms
    with S.hot_path(sh.server.engine) as rec:
        for i, n in enumerate((3, 11, 7, 16, 5)):
            qt = terms[i:i + n]
            got, want = (s.serve_all(list(qt), deadline_ms=1e6)
                         for s in svcs)
            np.testing.assert_array_equal(
                np.stack([r["ranked"] for r in got]),
                np.stack([r["ranked"] for r in want]))
    assert rec.new_compiles == 0


def test_a_second_budget_grid_of_one_length_is_refused(system):
    """The schedulers of one engine share its gather program and the
    budget grid it reads in place: a grid of the same length with other
    budgets raises instead of replaying the first one's."""
    sh = _server(system, "rho", 2)
    a = t_engine.SchedPrograms.for_engine(sh.engine, grain=4,
                                          extra_widths=(77,))
    b = t_engine.SchedPrograms.for_engine(sh.engine, grain=4,
                                          extra_widths=(77,))
    assert a._wvecs is b._wvecs
    with pytest.raises(ValueError, match="budget grid"):
        t_engine.SchedPrograms.for_engine(sh.engine, grain=4,
                                          extra_widths=(99,))


def test_sharded_programs_pick_and_refuse(system):
    """``for_engine`` picks the program set by the engine; each refuses
    the other's engine; the budget grid holds the cutoffs, the stream
    cap and the fixed arm's extra width."""
    sh, plain = _server(system, "rho", 2), _server(system, "rho")
    prog = t_engine.SchedPrograms.for_engine(sh.engine, grain=4,
                                             extra_widths=(77,))
    assert isinstance(prog, t_engine.ShardedSchedPrograms) and prog.sharded
    cap = sh.cfg.stream_cap
    assert prog.widths == tuple(sorted(
        {min(c, cap) for c in sh.cfg.cutoffs} | {cap, 77}))
    assert prog.lend_col(10_000) == prog.width_col[cap]
    assert not t_engine.SchedPrograms.for_engine(plain.engine,
                                                 grain=4).sharded
    with pytest.raises(TypeError, match="for_engine"):
        t_engine.SchedPrograms(sh.engine, grain=4)
    with pytest.raises(TypeError, match="ShardedServingEngine"):
        t_engine.ShardedSchedPrograms(plain.engine, grain=4)


def test_sharded_sched_gather_raises_on_overflow(system):
    tight = _server(system, "k", 4, partition_slack=0.25)
    prog = t_engine.SchedPrograms.for_engine(tight.engine, grain=4)
    qt = system[0].queries.terms[:4]
    prog.init_state(8, qt.shape[1])
    with pytest.raises(RuntimeError, match="partition_slack"):
        prog.gather(qt.astype(np.int32))


def test_continuous_backend_on_a_one_shard_mesh(tiny_system):
    """The JAX package's in-process case: on a 1x1 mesh the sharded
    engine drives ``ContinuousBackend``, equal to its own batch-once
    serve."""
    tindex = carry_index(tiny_system)
    cuts = tiny_system.k_cutoffs
    srv = t_pipeline.RetrievalServer(
        tindex, None, t_pipeline.ServingConfig(
            knob="k", cutoffs=cuts, rerank_depth=30,
            stream_cap=tiny_system.cfg.stream_cap), device="cpu",
        mesh=mesh_lib.make_serving_mesh(1, device="cpu"))
    n_cls = len(cuts) + 1
    srv.predict_classes = (
        lambda qt, knob=None: (_hash_rows(qt) % n_cls).astype(np.int64))
    assert srv.engine.supports_continuous is True
    qt = tiny_system.queries.terms[:16]
    ref, _ = srv.engine.serve(qt, srv.params_of(srv.predict_classes(qt)))
    svc = t_service.RetrievalService(
        t_service.ContinuousBackend(srv, slots=8, grain=4))
    res = svc.serve_all(list(qt), deadline_ms=1e6)
    np.testing.assert_array_equal(np.stack([r["ranked"] for r in res]), ref)
    assert svc.backend.scheduler.stats()["sharded"] is True
