"""The port's continuous scheduler (``serving/sched``, ``SchedPrograms``,
``ContinuousBackend``) against the JAX package's, on the CPU.

Both packages serve the same carried index; classes come from a stub
that is a pure function of the query's content (the JAX scheduler
tests' idiom: refill groups differ from batch-once groups, so a
batch-position stub would not survive regrouping).  Stage-2 noise keys
on the request's arrival index, so a bit-identity check compares with
one ``engine.serve`` of the whole stream from a fresh service (arrival
index = batch position).  Tolerances, with their reasons:
  * ranked lists, classes, widths, retire reasons, chunk counts and the
    scheduler's counters are equal: impacts are integer-valued float32,
    so chunked sums equal one-shot sums bit for bit, and both packages
    run the same host bookkeeping.
"""

import numpy as np
import pytest

from _torch_carry import bare_servers, carry_index
from repro.core import knobs as j_knobs
from repro.online import telemetry as j_telemetry
from repro.serving import service as j_service
from repro_torch.core import knobs as t_knobs
from repro_torch.online import telemetry as t_telemetry
from repro_torch.serving import engine as t_engine
from repro_torch.serving import service as t_service

N = 40
#: the stats() keys both schedulers must agree on
COUNTERS = ("n_admitted", "n_retired", "n_refill_calls", "n_chunk_calls",
            "n_finalize_calls", "n_rows_scored", "n_rows_full",
            "retire_reasons", "chunks_max", "slots", "grain", "chunk_p")
RESULT_KEYS = ("class", "width", "depth", "depth_class", "retire_reason",
               "chunks_executed", "chunks_max", "trace_id")


def _hash_rows(qt):
    qt = np.asarray(qt)
    return np.where(qt >= 0, qt, 0).sum(axis=1) + (qt >= 0).sum(axis=1)


def _stub(server, shift):
    """Replace the primary knob's classes by the content hash (plus a
    mutable shift that stands in for a predictor swap)."""
    n_cls = len(server.cfg.cutoffs) + 1
    real = server.predict_classes

    def stub(qt, knob=None):
        if knob not in (None, server.cfg.knob):
            return real(qt, knob=knob)
        return ((_hash_rows(qt) + shift["v"]) % n_cls).astype(np.int64)

    server.predict_classes = stub


@pytest.fixture(scope="module")
def carried(tiny_system):
    return tiny_system, carry_index(tiny_system)


def _pair(carried, knob="rho", shift=None, **cfg_kw):
    """(JAX server, port server) with stubbed classes."""
    sys_, tindex = carried
    shift = {"v": 0} if shift is None else shift
    js, ts = bare_servers(sys_, tindex, knob, **cfg_kw)
    for s in (js, ts):
        _stub(s, shift)
    return js, ts


def _depth_pair(carried, knob):
    """Servers with the depth knob live, depth classes a pure function
    of the query's content."""
    sys_ = carried[0]
    pool = 30 if knob == "rho" else int(max(sys_.k_cutoffs))
    grid = t_knobs.depth_cutoffs(pool)
    assert tuple(grid) == tuple(j_knobs.depth_cutoffs(pool))
    pair = _pair(carried, knob, depth_cutoffs=grid)

    def pdepth_for(server):
        def pdepth(qt):
            cls = (_hash_rows(qt) % (len(grid) + 1)).astype(np.int64)
            return cls, server.params_of(cls, knob="depth")
        return pdepth

    for s in pair:
        s.predict_depths = pdepth_for(s)
    return pair


def _serve(mod, server, qt, **kw):
    backend = mod.ContinuousBackend(server, **kw)
    svc = mod.RetrievalService(backend)
    return backend, svc, svc.serve_all(list(qt), deadline_ms=1e6)


def _assert_same(got, want, keys=RESULT_KEYS):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ranked"], w["ranked"])
        for k in keys:
            assert g[k] == w[k], k


# ------------------------------------------------- churn bit-identity --

@pytest.mark.parametrize("knob", ["rho", "k"])
def test_churn_bit_identity_every_bucket(carried, knob):
    """Under slot churn the port's results equal the JAX scheduler's and
    one batch-once ``engine.serve`` of the same stream, with every class
    bucket of the grid in the mix."""
    js, ts = _pair(carried, knob)
    qt = carried[0].queries.terms[:N]
    classes = ts.predict_classes(qt)
    assert set(classes.tolist()) == set(range(len(ts.cfg.cutoffs) + 1))
    ranked_ref, _ = ts.engine.serve(qt, ts.params_of(classes))
    kw = dict(slots=16, grain=4, window=8)
    tb, _, got = _serve(t_service, ts, qt, **kw)
    jb, _, want = _serve(j_service, js, qt, **kw)
    _assert_same(got, want)
    for i, res in enumerate(got):
        np.testing.assert_array_equal(res["ranked"], ranked_ref[i])
        assert res["class"] == classes[i]
        assert res["chunks_executed"] <= res["chunks_max"]
        assert 0.0 < res["slot_occupancy"] <= 1.0
        assert res["slot_occupancy"] == want[i]["slot_occupancy"]
    tst, jst = tb.scheduler.stats(), jb.scheduler.stats()
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert tst["n_admitted"] == tst["n_retired"] == N
    if knob == "rho":
        assert set(tst["retire_reasons"]) <= {"rho_exhausted",
                                              "stream_exhausted"}
    else:
        assert set(tst["retire_reasons"]) == {"pool_complete"}


@pytest.mark.parametrize("n", [1, 7])
def test_ragged_tail_bit_identity(carried, n):
    """Trickle traffic (below a grain, or not a grain multiple) pads
    within the fixed shapes and stays bit-identical."""
    js, ts = _pair(carried)
    qt = carried[0].queries.terms[:n]
    ranked_ref, _ = ts.engine.serve(qt, ts.params_of(ts.predict_classes(qt)))
    _, _, got = _serve(t_service, ts, qt, slots=8, grain=4)
    _, _, want = _serve(j_service, js, qt, slots=8, grain=4)
    _assert_same(got, want)
    for i, res in enumerate(got):
        np.testing.assert_array_equal(res["ranked"], ranked_ref[i])


def _mid_flight_swap(mod, server, shift, qt):
    svc = mod.RetrievalService(
        mod.ContinuousBackend(server, slots=8, grain=4, window=8))
    futs = svc.submit_many(list(qt[:12]), deadline_ms=1e6)
    svc.flush()
    while sum(f.done() for f in futs) < 4:
        assert svc.step()
    assert svc.outstanding > 0
    # the stub's stand-in for a swap: new classes, a bumped version
    shift["v"] = 2
    server.predictor_version += 1
    futs += svc.submit_many(list(qt[12:]), deadline_ms=1e6)
    svc.flush()
    while svc.outstanding:
        assert svc.step()
    return [f.result() for f in futs]


def test_mid_flight_hot_swap_bit_identity(carried):
    """A predictor swap while slots are in flight: admitted requests
    keep their admission-time widths, later ones see the new predictor,
    and every result equals a batch-once serve at the widths used."""
    qt = carried[0].queries.terms[:24]
    tshift, jshift = {"v": 0}, {"v": 0}
    js, _ = _pair(carried, shift=jshift)
    _, ts = _pair(carried, shift=tshift)
    got = _mid_flight_swap(t_service, ts, tshift, qt)
    want = _mid_flight_swap(j_service, js, jshift, qt)
    _assert_same(got, want, RESULT_KEYS + ("predictor_version",))
    assert len({r["predictor_version"] for r in got}) == 2
    widths = np.asarray([r["width"] for r in got], np.int64)
    ranked_ref, _ = ts.engine.serve(qt, widths)
    for i, res in enumerate(got):
        np.testing.assert_array_equal(res["ranked"], ranked_ref[i])


@pytest.mark.parametrize("knob", ["rho", "k"])
def test_mixed_depth_churn_bit_identity(carried, knob):
    """Per-slot retirement at each query's predicted reranking depth
    equals one batch-once serve with the same depth vector and the JAX
    scheduler, with the same stage-2 row accounting."""
    js, ts = _depth_pair(carried, knob)
    qt = carried[0].queries.terms[:N]
    classes = ts.predict_classes(qt)
    dcls, depths = ts.predict_depths(qt)
    assert len(set(depths.tolist())) > 1
    ranked_ref, _ = ts.engine.serve(qt, ts.params_of(classes),
                                    depth_vec=depths)
    kw = dict(slots=16, grain=4, window=8)
    tb, _, got = _serve(t_service, ts, qt, **kw)
    jb, _, want = _serve(j_service, js, qt, **kw)
    _assert_same(got, want)
    for i, res in enumerate(got):
        np.testing.assert_array_equal(res["ranked"], ranked_ref[i])
        assert res["depth"] == depths[i] and res["depth_class"] == dcls[i]
    tst, jst = tb.scheduler.stats(), jb.scheduler.stats()
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    rows, full = ts._rows_scored(ts.params_of(classes), depths)
    assert tst["n_rows_scored"] == int(rows.sum()) < tst["n_rows_full"]
    assert tst["n_rows_full"] == int(full.sum())


def test_depth_pinned_to_max_matches_depth_free_scheduler(carried):
    """A depth server whose every prediction is the full pool retires
    bit-identically to a scheduler with no depth knob at all."""
    qt = carried[0].queries.terms[:24]
    _, plain = _pair(carried)
    _, deep = _pair(carried, depth_cutoffs=t_knobs.depth_cutoffs(30))
    _, _, a = _serve(t_service, plain, qt, slots=8, grain=4)
    b_backend, _, b = _serve(t_service, deep, qt, slots=8, grain=4)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra["ranked"], rb["ranked"])
        assert rb["depth"] == deep.cfg.depth_pool_width
    sch = b_backend.scheduler.stats()
    assert sch["n_rows_scored"] == sch["n_rows_full"]


def test_churn_cycles_admit_and_retire_every_request(carried):
    """50 admit/retire cycles of 1..8 requests after warmup: every
    request is admitted and retired, as in the JAX scheduler, and the
    warmup builds as many programs as the JAX one compiles."""
    js, ts = _pair(carried)
    L = carried[0].queries.terms.shape[1]
    stats, warm = [], []
    for mod, server in ((t_service, ts), (j_service, js)):
        backend = mod.ContinuousBackend(server, query_len=L, slots=8,
                                        grain=4)
        svc = mod.RetrievalService(backend)
        warm.append(backend.scheduler.warmup())
        rng = np.random.default_rng(7)
        qpool = carried[0].queries.terms
        for cycle in range(50):
            rows = qpool[rng.integers(0, qpool.shape[0], 1 + cycle % 8)]
            svc.serve_all(list(rows), deadline_ms=1e6)
        stats.append(backend.scheduler.stats())
    assert warm[0] == warm[1] > 0
    n = sum(1 + c % 8 for c in range(50))
    assert stats[0]["n_admitted"] == stats[0]["n_retired"] == n
    assert ({k: stats[0][k] for k in COUNTERS}
            == {k: stats[1][k] for k in COUNTERS})


# --------------------------------------------------------- co-grouping --

def test_co_grouping_selects_nearest_classes(carried):
    _, ts = _pair(carried)
    backend = t_service.ContinuousBackend(ts, slots=8, grain=4)
    t_service.RetrievalService(backend)
    sched = backend.scheduler
    cand = list(range(5))               # only len() matters to _select
    classes = np.array([3, 0, 3, 1, 3])
    keep, back = sched._select(cand, classes, 3)
    assert keep.tolist() == [0, 2, 4] and back.tolist() == [1, 3]
    sched.co_group = False
    keep, back = sched._select(cand, classes, 3)
    assert keep.tolist() == [0, 1, 2]


def test_grain_larger_than_the_table_is_refused(carried):
    _, ts = _pair(carried)
    with pytest.raises(ValueError, match="grain"):
        t_service.RetrievalService(
            t_service.ContinuousBackend(ts, slots=4, grain=8))


def test_overlong_query_fails_fast(carried):
    _, ts = _pair(carried)
    L = carried[0].queries.terms.shape[1]
    svc = t_service.RetrievalService(
        t_service.ContinuousBackend(ts, query_len=L, slots=8, grain=4))
    fut = svc.submit(np.zeros(L + 3, np.int32), deadline_ms=1e6)
    svc.flush()
    while not fut.done():
        svc.step()
    with pytest.raises(ValueError, match="query length"):
        fut.result()


# ------------------------------------------------ deadline accounting --

def test_deadline_tally_counts_served_requests(carried):
    _, ts = _pair(carried)
    terms = carried[0].queries.terms
    svc = t_service.RetrievalService(
        t_service.ContinuousBackend(ts, slots=8, grain=4))
    ok = svc.serve_all(list(terms[:4]), deadline_ms=1e6)
    late = svc.serve_all(list(terms[4:8]), deadline_ms=0.0)
    assert all(r["deadline_met"] for r in ok)
    assert not any(r["deadline_met"] for r in late)
    st = svc.stats()
    assert st.n_deadline_met == 4 and st.n_deadline_missed == 4
    assert "deadline_met=50.0%" in st.summary()


def _cancel_mid_flight(mod, server, terms):
    svc = mod.RetrievalService(mod.ContinuousBackend(server, slots=8,
                                                     grain=4))
    futs = svc.submit_many(list(terms[:10]), deadline_ms=1e6)
    svc.flush()
    svc.step()                          # admit a grain: some mid-flight
    svc.stop(drain=False)
    assert all(f.done() for f in futs)
    return [f.cancelled() for f in futs], svc.stats()


def test_cancelled_requests_are_not_deadline_misses(carried):
    """stop(drain=False) with work queued and mid-flight: every future
    resolves, cancels never count as deadline misses, and the tallies
    equal the JAX service's."""
    js, ts = _pair(carried)
    terms = carried[0].queries.terms
    cancelled, st = _cancel_mid_flight(t_service, ts, terms)
    j_cancelled, jst = _cancel_mid_flight(j_service, js, terms)
    assert cancelled == j_cancelled and sum(cancelled) > 0
    assert st.n_cancelled == jst.n_cancelled == sum(cancelled)
    served = 10 - sum(cancelled)
    assert (st.n_deadline_met or 0) + (st.n_deadline_missed or 0) == served
    assert (st.n_deadline_met, st.n_deadline_missed) == (
        jst.n_deadline_met, jst.n_deadline_missed)
    assert f"cancelled={sum(cancelled)}" in st.summary()


# ----------------------------------------------- retirement telemetry --

def test_retirement_trail_reaches_telemetry_ring(carried):
    js, ts = _pair(carried)
    terms = carried[0].queries.terms[:8]
    bufs = []
    for mod, tel, server in ((t_service, t_telemetry, ts),
                             (j_service, j_telemetry, js)):
        buf = tel.TelemetryBuffer(capacity=64)
        svc = mod.RetrievalService(
            mod.ContinuousBackend(server, slots=8, grain=4), telemetry=buf)
        svc.serve_all(list(terms), deadline_ms=1e6)
        bufs.append(buf.snapshot())
    recs, want = bufs
    assert len(recs) == 8
    for r, w in zip(recs, want):
        assert r.retire_reason in ("rho_exhausted", "stream_exhausted")
        assert 0 <= r.chunks_executed <= r.chunks_max
        assert 0.0 < r.slot_occupancy <= 1.0
        for k in ("retire_reason", "chunks_executed", "chunks_max",
                  "pred_class", "width", "trace_id", "slot_occupancy"):
            assert getattr(r, k) == getattr(w, k), k
        np.testing.assert_array_equal(r.ranked, w.ranked)


# ------------------------------------------------- refill and warmup --

def _live_state(carried, mod=t_service):
    """A scheduler stopped mid-flight (k knob: every slot scans its
    whole stream), the port's or ``mod``'s: (programs, live state)."""
    js, ts = _pair(carried, "k")
    backend = mod.ContinuousBackend(ts if mod is t_service else js,
                                    slots=8, grain=4)
    svc = mod.RetrievalService(backend)
    svc.submit_many(list(carried[0].queries.terms[:6]), deadline_ms=1e6)
    svc.flush()
    svc.step()
    sched = backend.scheduler
    assert sched.table.active()
    return sched.prog, sched._state


def _tensors(state):
    return [getattr(state, f).clone() for f in
            ("ds", "im", "seg_lo", "seg_hi", "sdocs", "s3", "acc")]


def test_refill_of_padding_only_changes_nothing(carried):
    prog, state = _live_state(carried)
    before = _tensors(state)
    rows, _, _ = prog.gather(np.full((prog.grain, state.sdocs.shape[1]
                                      // prog.slot_cap), -1, np.int32))
    new = prog.refill(state, np.full(prog.grain, 8, np.int32), rows)
    for a, b in zip(before, _tensors(new)):
        assert a.equal(b)
    # padding must trail the real slots: a pad in front is refused, and
    # the live state is left as it was
    idx = np.array([8, 0, 1, 2], np.int32)
    with pytest.raises(ValueError, match="trail"):
        prog.refill(state, idx, rows)
    for a, b in zip(before, _tensors(state)):
        assert a.equal(b)


def test_refill_is_out_of_place(carried):
    """A refill returns new tensors and leaves the old state whole, so
    a failure part-way leaves the table as it was (the JAX state is an
    immutable value)."""
    prog, state = _live_state(carried)
    before = _tensors(state)
    qt = carried[0].queries.terms[10:10 + prog.grain]
    rows, _, _ = prog.gather(qt.astype(np.int32))
    new = prog.refill(state, np.array([5, 6, 8, 8], np.int32), rows)
    for a, b in zip(before, _tensors(state)):
        assert a.equal(b)
    assert not new.ds[5].equal(state.ds[5])
    assert float(new.acc[5:7].abs().sum()) == 0.0
    assert new.ds[:5].equal(state.ds[:5])


def test_warmup_mid_flight_leaves_live_state_unchanged(carried):
    """A warmup mid-flight builds the programs the live run has not
    built yet, as many as the JAX scheduler compiles at the same point,
    and leaves the live state as it was."""
    prog, state = _live_state(carried)
    jprog, jstate = _live_state(carried, j_service)
    before = _tensors(state)
    built = prog.warmup(8, state.sdocs.shape[1] // prog.slot_cap)
    assert built == jprog.warmup(8, jstate.sdocs.shape[1] // jprog.slot_cap)
    for a, b in zip(before, _tensors(state)):
        assert a.equal(b)


def test_default_chunk_and_bounds_geometry(carried):
    """Chunk length and segment-bound granularity as the JAX package
    derives them."""
    assert [t_engine._default_chunk_p(p) for p in (4096, 256, 100, 7)] == \
        [512, 32, 10, 1]
    _, ts = _pair(carried)
    prog = t_engine.SchedPrograms.for_engine(ts.engine, grain=4)
    assert (prog.chunk_p, prog.bounds_p, prog.n_chunks) == (32, 32, 8)
    with pytest.raises(ValueError, match="divide"):
        t_engine.SchedPrograms(ts.engine, grain=4, chunk_p=48)


# ----------------------------------------------------------- threaded --

@pytest.mark.parametrize("knob", ["rho", "k"])
def test_threaded_equals_inline(carried, knob):
    """With every request queued before ``start()``, the tick thread
    serves exactly what the inline scheduler serves."""
    _, ts = _pair(carried, knob)
    qt = carried[0].queries.terms[:N]
    _, _, inline = _serve(t_service, ts, qt, slots=16, grain=4, window=8)
    backend = t_service.ContinuousBackend(ts, slots=16, grain=4, window=8)
    svc = t_service.RetrievalService(backend)
    futs = svc.submit_many(list(qt), deadline_ms=1e6)
    with svc:
        threaded = [f.result(timeout=120.0) for f in futs]
    _assert_same(threaded, inline)
    assert backend.scheduler.stats()["n_retired"] == N
