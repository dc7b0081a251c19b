"""The port's program cache (``ServingEngine._compiled``,
``serving/programs.py``) against the JAX engine's executable cache, on
the CPU, with the port's ``compile_sentinel`` / ``hot_path``.

On the CPU a program is the stage function itself (the card's CUDA
graphs are held in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s
phase 18), so these tests hold the cache's keys, counts, locks and
warmup: the port builds one program per stage and padded shape, as many
as the JAX engine compiles on the same calls.  Both packages serve the
same carried index with stubbed classes (``tests/_torch_carry.py``).
Tolerances: counts and ranked lists equal (``tests/test_torch_serving.py``
gives the reasons the lists are exact).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from _torch_carry import bare_servers, carry_index
from repro.serving import service as j_service
from repro_torch.analysis import sanitizers as S
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.impact_scan import kernel as is_kernel
from repro_torch.serving import engine as t_engine
from repro_torch.serving import programs as t_programs
from repro_torch.serving import service as t_service

GRID = [8, 16, 24]


@pytest.fixture(scope="module")
def carried(tiny_system):
    return tiny_system, carry_index(tiny_system)


def _stub(server, shift=0):
    """The primary knob's classes as a pure function of the query's
    content (every class live in a batch of a few queries)."""
    n_cls = len(server.cfg.cutoffs) + 1
    real = server.predict_classes

    def stub(qt, knob=None):
        if knob not in (None, server.cfg.knob):
            return real(qt, knob=knob)
        qt = np.asarray(qt)
        h = np.where(qt >= 0, qt, 0).sum(axis=1) + (qt >= 0).sum(axis=1)
        return ((h + shift) % n_cls).astype(np.int64)

    server.predict_classes = stub


def _pair(carried, knob, **cfg_kw):
    js, ts = bare_servers(*carried, knob, **cfg_kw)
    for s in (js, ts):
        _stub(s)
    return js, ts


@pytest.mark.parametrize("with_depth", [False, True])
@pytest.mark.parametrize("knob", ["rho", "k"])
def test_warmup_builds_as_many_programs_as_the_jax_engine(carried, knob,
                                                          with_depth):
    js, ts = _pair(carried, knob)
    qlen = carried[0].queries.terms.shape[1]
    built = [s.engine.warmup(GRID, qlen, with_depth=with_depth)
             for s in (ts, js)]
    assert built[0] == built[1] > 0
    assert ts.engine.n_compiles == js.engine.n_compiles == built[0]
    # a warm grid builds nothing, in both packages
    assert [s.engine.warmup(GRID, qlen, with_depth=with_depth)
            for s in (ts, js)] == [0, 0]
    assert [s.engine.warmup_shape(20, qlen) for s in (ts, js)] == [0, 0]
    assert ts.engine.program_stats() == {
        "programs": built[0], "graphs": 0, "replays": 0, "static_bytes": 0}


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_mixed_batches_on_a_warm_grid_build_nothing(carried, knob):
    """20 batches of every size on the grid with shifting class mixes,
    then the fixed baseline, under ``hot_path``: no program is built and
    the ranked lists equal the JAX engine's (the JAX package's
    compile-count tests, on the port)."""
    js, ts = _pair(carried, knob)
    terms = carried[0].queries.terms
    for s in (js, ts):
        s.engine.warmup(GRID, terms.shape[1])
    base = ts.engine.n_compiles
    with S.hot_path(ts.engine) as rec:
        for b in range(20):
            n = 1 + (7 * b) % 24
            for s in (js, ts):
                _stub(s, shift=b)
            qt = terms[b:b + n]
            got, want = ts.serve_batch(qt), js.serve_batch(qt)
            np.testing.assert_array_equal(got["ranked"], want["ranked"])
            np.testing.assert_array_equal(got["classes"], want["classes"])
            assert got["n_compiles"] == want["n_compiles"] == base
        cut = int(ts.cfg.cutoffs[-1])
        np.testing.assert_array_equal(
            ts.serve_fixed(terms[:24], cut)["ranked"],
            js.serve_fixed(terms[:24], cut)["ranked"])
    assert rec.new_compiles == 0 and rec.syncs is None   # no stream here
    assert ts.engine.n_compiles == js.engine.n_compiles == base


def test_a_batch_off_the_grid_raises_recompile_error(carried):
    js, ts = _pair(carried, "rho")
    terms = carried[0].queries.terms
    ts.engine.warmup([8, 16], terms.shape[1])
    ts.serve_batch(terms[:13])                       # pads to 16: warm
    with pytest.raises(S.RecompileError, match="4 new program"):
        with S.hot_path(ts.engine):
            ts.serve_batch(terms[:20])               # pads to 24: cold
    # the sentinel takes an engine or a zero-argument callable
    with S.compile_sentinel(lambda: ts.engine.n_compiles) as rec:
        ts.serve_batch(terms[:20])
    assert rec.new_compiles == 0
    with S.compile_sentinel(ts.engine, allowed=4) as rec:
        ts.serve_batch(terms[:30])                   # pads to 32
    assert rec.new_compiles == 4
    with pytest.raises(TypeError, match="probe"):
        with S.compile_sentinel(3):
            pass


def test_scheduler_warmup_and_churn_build_as_the_jax_scheduler(carried):
    """The scheduler's four programs: ``SchedPrograms.warmup`` builds as
    many as the JAX one compiles, and 50 admit/retire cycles of 1..8
    requests after it build none (the JAX scheduler's churn test)."""
    js, ts = _pair(carried, "rho")
    terms = carried[0].queries.terms
    warm, after = [], []
    for mod, server in ((t_service, ts), (j_service, js)):
        backend = mod.ContinuousBackend(server, query_len=terms.shape[1],
                                        slots=8, grain=4)
        svc = mod.RetrievalService(backend)
        warm.append(backend.scheduler.warmup())
        rng = np.random.default_rng(7)
        n0 = server.engine.n_compiles
        with S.compile_sentinel(server.engine) as rec:
            for cycle in range(50):
                rows = terms[rng.integers(0, terms.shape[0], 1 + cycle % 8)]
                svc.serve_all(list(rows), deadline_ms=1e6)
        after.append(server.engine.n_compiles - n0)
        assert rec.new_compiles == 0
    assert warm[0] == warm[1] > 0 and after == [0, 0]
    assert ts.engine.n_compiles == js.engine.n_compiles


def test_threads_warming_one_shape_build_each_key_once(carried,
                                                       monkeypatch):
    """The pending marker: a thread that misses a key another thread is
    building waits for that build instead of building it again."""
    _, ts = _pair(carried, "k")
    qlen = carried[0].queries.terms.shape[1]
    builds = []
    real = t_programs.build_program

    def slow_build(name, *a, **kw):
        builds.append(name)
        time.sleep(0.05)                 # hold the key while others miss
        return real(name, *a, **kw)

    monkeypatch.setattr(t_programs, "build_program", slow_build)
    n_threads = 2 * (os.cpu_count() or 4)
    go = threading.Barrier(n_threads)
    errors = []

    def warm():
        go.wait()
        try:
            ts.engine.warmup_shape(16, qlen)
        except Exception as e:           # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=warm) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(builds) == sorted(set(builds)) and len(builds) == 4
    assert ts.engine.n_compiles == ts.engine.program_stats()["programs"] == 4


def test_the_cache_refuses_host_arguments_and_changed_keywords(carried):
    _, ts = _pair(carried, "rho")
    e = ts.engine
    x = e.doc_len[:4]
    with pytest.raises(TypeError, match="tensor arguments"):
        e._compiled("probe", t_engine._depth_mask, (x, 3), {})
    e._compiled("mask", t_engine._stage_rerank, (x[None], x[None]),
                {"depth": 2})
    with pytest.raises(ValueError, match="static keywords"):
        e._compiled("mask", t_engine._stage_rerank, (x[None], x[None]),
                    {"depth": 3})


def test_a_capture_tally_counts_at_replay_not_at_build():
    """A wrapper's launch inside a build goes to the build's tally; each
    replay adds the tally to the counters (by route for flash)."""
    n0, f0 = is_kernel.n_launches, dict(fa_kernel.route_launches)
    assert not _build.counted_in_capture(is_kernel.__name__)
    with _build.capture_tally() as tally:
        assert _build.counted_in_capture(is_kernel.__name__)
        assert _build.counted_in_capture(fa_kernel.__name__, "general")
    assert tally == {(is_kernel.__name__, None): 1,
                     (fa_kernel.__name__, "general"): 1}
    assert is_kernel.n_launches == n0
    n_fa = fa_kernel.n_launches
    for _ in range(2):
        _build.count_replay(tally)
    assert is_kernel.n_launches == n0 + 2 and fa_kernel.n_launches == n_fa + 2
    assert fa_kernel.route_launches["general"] == f0.get("general", 0) + 2
    is_kernel.n_launches, fa_kernel.n_launches = n0, n_fa
    fa_kernel.route_launches.clear()
    fa_kernel.route_launches.update(f0)
