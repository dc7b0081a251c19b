"""The port's sharded serving (``distrib/``, ``launch/mesh.py``, the
``partition_*`` functions, ``ShardedServingEngine``,
``ShardedEngineBackend``, the CLI's ``--shards``) against the JAX
package, on the CPU.

The mesh's positions are laid over the one CPU with
``force_host_device_count(8)`` (the JAX tests force 8 host devices the
same way).  The engine cases follow the JAX package's
``tests/test_sharded_serving.py`` on its 301-doc system (301 % 4 != 0:
a ragged last shard; max_k 100 > the 4-way shard width), built by the
JAX package and carried to the port.

Tolerance: none.  Partitions, positions and ranked ids are integers and
the float outputs of the partitions are copies; the JAX package promises
the sharded engine's lists equal the unsharded engine's bit for bit, and
the port's unsharded engine equals the JAX one (``test_torch_serving``).
"""

import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_counts as sharded_counts
from _torch_carry import carry_index
from repro.core import experiment as j_exp
from repro.kernels.impact_scan import ops as j_is_ops
from repro.retrieval import index as j_index
from repro.retrieval import jass as j_jass
from repro.serving import engine as j_engine
from repro.serving import pipeline as j_pipeline
from repro_torch import obs as t_obs
from repro_torch.analysis import sanitizers as S
from repro_torch.core import knobs as t_knobs
from repro_torch.distrib import collectives
from repro_torch.distrib.sharding import DeviceMesh, MeshInfo, dp_axis_spec
from repro_torch.kernels.impact_scan import ops as t_is_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.retrieval import index as t_index
from repro_torch.serving import admission as t_admission
from repro_torch.serving import pipeline as t_pipeline
from repro_torch.serving import service as t_service

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = sharded_counts.MESHES
#: the JAX partitions, traced once a shape (``lo`` is an operand there)
J_PARTITION = jax.jit(j_index.partition_postings,
                      static_argnames=("width", "cap"))
J_PARTITION_SCORED = jax.jit(j_index.partition_scored_postings,
                             static_argnames=("width", "cap"))


@pytest.fixture(scope="module", autouse=True)
def positions():
    """Eight mesh positions over the one CPU, for this module only."""
    mesh_lib.force_host_device_count(8)
    yield
    mesh_lib.force_host_device_count(0)


@pytest.fixture(scope="module", autouse=True)
def _jax_side():
    """The JAX sharded engine's program counts, compiled in a subprocess
    over forced host devices while the port's cases run."""
    proc = sharded_counts.start("engine")
    yield proc
    if proc.poll() is None:             # no case read it: stop it
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_counts(_jax_side):
    return sharded_counts.result(_jax_side)


def _mesh(shape):
    """A CPU mesh: (data, model) or (pod, data, model)."""
    pod = shape[0] if len(shape) == 3 else 1
    return mesh_lib.make_serving_mesh(shape[-1], shape[-2], pod,
                                      device="cpu")


# ------------------------------------------------------------ partitions --

def _streams(rng, qn, p, n_docs):
    """Impact-ordered-style streams with a -1 padded tail (the JAX
    package's ``tests/test_partition.py`` helper)."""
    ds = rng.integers(0, n_docs, (qn, p)).astype(np.int32)
    lens = rng.integers(1, p + 1, qn)
    ds[np.arange(p)[None, :] >= lens[:, None]] = -1
    im = np.where(ds >= 0, rng.integers(1, 250, (qn, p)), -1.0)
    return ds, im.astype(np.float32)


def _shards(n_docs, n_shards):
    width = -(-n_docs // n_shards)
    return [(s * width, width) for s in range(n_shards)]


def _case(name, tiny):
    """(doc streams, impacts, [(lo, width)], cap, rhos) of each case of
    the JAX package's ``tests/test_partition.py``, and the streams of
    ``jass.gather_streams`` on ``tiny_system``."""
    if name == "order":
        ds, im = _streams(np.random.default_rng(3), 5, 64, 37)
        return ds, im, _shards(37, 4), j_index.partition_cap(64, 4, 2.0), ()
    if name == "reconstruct":
        ds, im = _streams(np.random.default_rng(7), 4, 96, 301)
        return ds, im, _shards(301, 4), j_index.partition_cap(96, 4, 2.0), ()
    if name == "gpos_prefix":
        ds, im = _streams(np.random.default_rng(11), 6, 80, 40)
        return ds, im, [(10, 10)], 80, (0, 1, 17, 80)
    if name == "zero_posting":
        ds = np.array([[3, 1, 2, -1, -1, -1, -1, -1]], np.int32)
        return ds, np.where(ds >= 0, 5.0, -1.0).astype(np.float32), \
            [(100, 50)], 8, (3,)
    if name == "overflow":
        ds = (np.arange(16) % 4)[None].astype(np.int32)
        return ds, np.full((1, 16), 2.0, np.float32), [(0, 4)], 8, (5,)
    if name == "one_shard":
        ds, im = _streams(np.random.default_rng(17), 3, 32, 20)
        return ds, im, [(0, 20)], 32, (7,)
    srv = j_pipeline.RetrievalServer(tiny.index, None, j_pipeline.ServingConfig(
        knob="rho", cutoffs=tiny.rho_cutoffs, stream_cap=tiny.cfg.stream_cap,
        use_kernel=False))
    e = srv.engine
    ds, im = j_jass.gather_streams(e.offsets, e.pdoc, e.pimp,
                                   jnp.asarray(tiny.queries.terms[:24]),
                                   cap=tiny.cfg.stream_cap)
    cap = j_index.partition_cap(tiny.cfg.stream_cap, 4, 2.0)
    return (np.array(ds), np.array(im), _shards(tiny.index.corpus.n_docs, 4),
            cap, (0, 30, tiny.cfg.stream_cap))


PARTITION_CASES = ["order", "reconstruct", "gpos_prefix", "zero_posting",
                   "overflow", "one_shard", "gather_streams"]


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("name", PARTITION_CASES)
def test_partition_postings_matches_jax(name, tiny_system):
    """``partition_postings`` at ``lo = s * width`` for every shard, its
    segment bounds, and ``owned_prefix_len`` at several rho, equal to
    the JAX functions."""
    ds, im, shards, cap, rhos = _case(name, tiny_system)
    for lo, w in shards:
        got = t_index.partition_postings(torch.from_numpy(ds),
                                         torch.from_numpy(im), lo, width=w,
                                         cap=cap)
        want = J_PARTITION(jnp.asarray(ds), jnp.asarray(im), jnp.int32(lo),
                           width=w, cap=cap)
        for g, x in zip(got, want):
            _eq(g, x)
        for g, x in zip(t_index.block_doc_bounds(got[0], block_p=4, n_docs=w),
                        j_index.block_doc_bounds(want[0], block_p=4,
                                                 n_docs=w)):
            _eq(g, x)
        for rho in rhos:
            _eq(t_is_ops.owned_prefix_len(got[2], rho),
                j_is_ops.owned_prefix_len(want[2], jnp.int32(rho)))
    if name == "overflow":
        assert int(got[3][0]) == 8


@pytest.mark.parametrize("name", ["scored_random", "gather_score_streams"])
def test_partition_scored_postings_matches_jax(name, tiny_system):
    """``partition_scored_postings`` equal to the JAX function for every
    shard; the port's extra ``spos`` is each kept posting's source
    column (its term is ``spos // cap``)."""
    if name == "scored_random":
        rng = np.random.default_rng(13)
        sd = rng.integers(-1, 30, (3, 24)).astype(np.int32)
        s3 = rng.normal(size=(3, 24, 3)).astype(np.float32)
        shards, caps = [(10, 10), (0, 10), (20, 10)], (24, 8)
    else:
        srv = j_pipeline.RetrievalServer(
            tiny_system.index, None, j_pipeline.ServingConfig(
                knob="rho", cutoffs=tiny_system.rho_cutoffs,
                stream_cap=tiny_system.cfg.stream_cap, use_kernel=False))
        e = srv.engine
        sd, s3 = (np.array(a) for a in j_jass.gather_score_streams(
            e.offsets, e.pdoc, e.pscore,
            jnp.asarray(tiny_system.queries.terms[:24]),
            cap=tiny_system.cfg.stream_cap))
        shards = _shards(tiny_system.index.corpus.n_docs, 4)
        caps = (j_index.partition_cap(sd.shape[1], 4, 2.0),)
    for cap in caps:
        for lo, w in shards:
            sdl, s3l, spos, ovf = t_index.partition_scored_postings(
                torch.from_numpy(sd), torch.from_numpy(s3), lo, width=w,
                cap=cap)
            want = J_PARTITION_SCORED(jnp.asarray(sd), jnp.asarray(s3),
                                      jnp.int32(lo), width=w, cap=cap)
            for g, x in zip((sdl, s3l, ovf), want):
                _eq(g, x)
            kept = sdl.numpy() >= 0
            rows = np.nonzero(kept)[0]
            np.testing.assert_array_equal(
                sd[rows, spos.numpy()[kept]] - lo, sdl.numpy()[kept])
            assert (spos.numpy()[~kept] == sd.shape[1]).all()


@pytest.mark.parametrize("cap,s,slack", [
    (128, 1, 2.0), (128, 4, 2.0), (128, 2, 1.5), (96, 8, 3.0), (7, 4, 1.0),
    (4096, 4, 2.0), (4096, 4, 0.25)])
def test_partition_cap_matches_jax(cap, s, slack):
    assert (t_index.partition_cap(cap, s, slack)
            == j_index.partition_cap(cap, s, slack))


# ---------------------------------------------------------- sharded_topk --

@pytest.mark.parametrize("k", [5, 11, 37])
def test_sharded_topk_equals_lax_top_k(k):
    """k > the shard width (11 > 37 // 4), uneven N (37 over 4), and
    k == N."""
    s = np.random.default_rng(1).normal(size=(3, 37)).astype(np.float32)
    v, i = collectives.sharded_topk(_mesh((1, 4)), torch.from_numpy(s), k)
    vr, ir = jax.lax.top_k(jnp.asarray(s), k)
    _eq(v, vr)
    _eq(i, ir)


def test_sharded_topk_ties_go_to_the_lowest_id():
    st = (np.random.default_rng(1).integers(0, 3, (4, 24))
          .astype(np.float32))
    v, i = collectives.sharded_topk(_mesh((1, 4)), torch.from_numpy(st), 10)
    vr, ir = jax.lax.top_k(jnp.asarray(st), 10)
    _eq(v, vr)
    _eq(i, ir)


def test_sharded_topk_rejects_missing_axis():
    mesh = DeviceMesh(["cpu"], (1,), ("data",))
    with pytest.raises(ValueError, match="axis 'model' is not an axis"):
        collectives.sharded_topk(mesh, torch.zeros((2, 8)), 3)


def test_sharded_topk_rejects_bad_k():
    with pytest.raises(ValueError, match="outside"):
        collectives.sharded_topk(_mesh((1, 1)), torch.zeros((2, 8)), 9)


# ------------------------------------------------------------------ mesh --

def test_serving_mesh_layout_and_limits(monkeypatch):
    """Named axes and shard rows as the JAX mesh's; more positions than
    are visible raise unless forced."""
    mesh = _mesh((2, 2, 2))
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    info = MeshInfo(mesh)
    assert (info.dp, info.dp_size, info.tp) == (("pod", "data"), 4, 2)
    assert dp_axis_spec(mesh) == ("pod", "data")
    assert dp_axis_spec(_mesh((2, 2))) == "data"
    assert dp_axis_spec(DeviceMesh(["cpu"], (1,), ("model",))) is None
    assert [len(r) for r in mesh.grid("model")] == [2] * 4
    assert len(mesh_lib.visible_positions("cpu")) == 8
    monkeypatch.setattr(mesh_lib, "_forced", 0)
    assert mesh_lib.visible_positions("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 2 devices"):
        mesh_lib.make_serving_mesh(2, device="cpu")


# ---------------------------------------------------------------- engine --

@pytest.fixture(scope="module")
def system():
    """The JAX sharded tests' system, carried to the port."""
    return j_exp.build_system(j_exp.ExperimentConfig(
        n_docs=301, vocab=900, n_queries=40, stream_cap=128, pool_depth=100,
        gold_depth=50, query_batch=16, seed=5))


@pytest.fixture(scope="module")
def carried(system):
    return carry_index(system)


def _stub(server, n_cls):
    real = server.predict_classes
    primary = server.cfg.knob

    def stub(qt, knob=None):
        if knob not in (None, primary):     # depth: the real predict path
            return real(qt, knob=knob)
        return np.arange(qt.shape[0]) % n_cls

    server.predict_classes = stub
    return server


def _cfg_kw(system, knob, **kw):
    cuts = system.k_cutoffs if knob == "k" else system.rho_cutoffs
    return dict(knob=knob, cutoffs=cuts, rerank_depth=30,
                stream_cap=system.cfg.stream_cap, kernel_block_p=32,
                kernel_block_d=64, **kw)


def _port_server(system, carried, knob, mesh=None, **kw):
    cfg = t_pipeline.ServingConfig(**_cfg_kw(system, knob, **kw))
    srv = t_pipeline.RetrievalServer(carried, None, cfg, device="cpu",
                                     mesh=mesh)
    return _stub(srv, len(cfg.cutoffs) + 1)


@pytest.fixture(scope="module")
def reference(system, carried):
    """{(knob, n): ranked} of the JAX unsharded server and of the port's
    unsharded server, the stub's classes on both."""
    out = {}
    for knob in ("k", "rho"):
        cfg = j_pipeline.ServingConfig(use_kernel=False,
                                       **_cfg_kw(system, knob))
        jsrv = _stub(j_pipeline.RetrievalServer(system.index, None, cfg),
                     len(cfg.cutoffs) + 1)
        tsrv = _port_server(system, carried, knob)
        for n in (16, 37):
            qt = system.queries.terms[:n]
            out[knob, n] = jsrv.serve_batch(qt)["ranked"]
            out["port", knob, n] = tsrv.serve_batch(qt)["ranked"]
        if knob == "k":
            n_docs = system.index.corpus.n_docs
            out["fixed"] = jsrv.serve_fixed(qt, n_docs)["ranked"]
            out["port", "fixed"] = tsrv.serve_fixed(qt, n_docs)["ranked"]
    return out


@pytest.mark.parametrize("n", [16, 37])
@pytest.mark.parametrize("knob", ["k", "rho"])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_engine_equals_unsharded_and_jax(system, carried, reference,
                                                 jax_counts, shape, knob, n):
    """Every class bucket (the stub cycles through them), on 1, 2 and 4
    shards and over data and pod axes: the lists equal the port's and
    the JAX package's unsharded servers', in 6 dispatches a batch, and
    the engine builds as many programs as the JAX sharded engine
    compiles on the same call and mesh."""
    srv = _port_server(system, carried, knob, _mesh(shape))
    o = t_obs.Observability.create()
    srv.engine.bind_obs(o)
    out = srv.serve_batch(system.queries.terms[:n])
    np.testing.assert_array_equal(out["ranked"], reference[knob, n])
    np.testing.assert_array_equal(out["ranked"], reference["port", knob, n])
    assert o.metrics.counters()["engine.dispatches"] == 6
    assert srv.engine.n_compiles == jax_counts[
        f"engine/{shape}/{knob}/{n}"] > 0
    assert set(out["timings"]) >= {"gather_ms", "stage1_ms", "stage2_ms",
                                   "merge_ms", "rerank_ms"}


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_serve_fixed_wider_than_every_shard(system, carried,
                                                    reference, jax_counts,
                                                    shape):
    """k == n_docs: a pool wider than every shard (301 > 76 on 4), its
    stage 1 and merge programs named by the width, as the JAX engine's."""
    srv = _port_server(system, carried, "k", _mesh(shape))
    out = srv.serve_fixed(system.queries.terms[:37],
                          system.index.corpus.n_docs)
    np.testing.assert_array_equal(out["ranked"], reference["fixed"])
    np.testing.assert_array_equal(out["ranked"], reference["port", "fixed"])
    assert srv.engine.n_compiles == jax_counts[f"fixed/{shape}"]
    names = {k[0] for k in srv.engine._programs.keys()}
    assert {"stage1:301", "merge:301"} <= names


@pytest.mark.parametrize("shards,knob", [(2, "k"), (2, "rho"), (4, "k")])
def test_sharded_depth_knob_equals_unsharded(system, carried, reference,
                                             shards, knob):
    """The depth knob on the mesh: depth pinned to the pool width equals
    the depth-free lists, and mixed per-query depths equal the unsharded
    engine's."""
    pool = 30 if knob == "rho" else int(max(system.k_cutoffs))
    grid = t_knobs.depth_cutoffs(pool)
    deep = _port_server(system, carried, knob, _mesh((1, shards)),
                        depth_cutoffs=grid)
    qt = system.queries.terms[:16]
    b = deep.serve_batch(qt)
    assert (b["depths"] == deep.cfg.depth_pool_width).all()
    np.testing.assert_array_equal(b["ranked"], reference[knob, 16])
    single = _port_server(system, carried, knob, depth_cutoffs=grid)
    dvec = np.asarray(grid)[np.arange(16) % len(grid)]
    widths = deep.params_of(np.arange(16) % (len(deep.cfg.cutoffs) + 1))
    ra, _ = single.engine.serve(qt, widths, depth_vec=dvec)
    rb, _ = deep.engine.serve(qt, widths, depth_vec=dvec)
    np.testing.assert_array_equal(ra, rb)


def test_sharded_engine_geometry(system, carried):
    """doc_pad, shard_width, shard_cap and the pad grid as the JAX
    engine derives them."""
    srv = _port_server(system, carried, "k", _mesh((2, 4)))
    e = srv.engine
    assert (e.n_shards, e.dp, e.dp_size) == (4, ("data",), 2)
    assert (e.doc_pad, e.shard_width) == (304, 76)
    assert e.shard_cap == j_index.partition_cap(128, 4, 2.0) == 64
    assert e.batch_multiple == 8 and e.padded_batch(37) == 40
    with pytest.raises(ValueError, match="axis 'rows' is not an axis"):
        t_pipeline.RetrievalServer(
            carried, None, t_pipeline.ServingConfig(**_cfg_kw(system, "k")),
            device="cpu", mesh=_mesh((1, 2)), shard_axis="rows")


@pytest.mark.parametrize("knob", ["k", "rho"])
def test_partition_overflow_raises_naming_the_slack(system, carried, knob):
    tight = _port_server(system, carried, knob, _mesh((1, 4)),
                         partition_slack=0.25)
    with pytest.raises(RuntimeError, match="partition_slack"):
        tight.serve_batch(system.queries.terms[:16])


# --------------------------------------------------------------- service --

def test_sharded_backend_inline_equals_serve_batch(system, carried):
    srv = _port_server(system, carried, "rho", _mesh((2, 2)))
    backend = t_service.ShardedEngineBackend(
        srv, query_len=system.queries.terms.shape[1])
    assert backend.pad_multiple == 8
    svc = t_service.RetrievalService(backend, t_admission.AdmissionConfig(
        max_batch=16, pad_multiple=backend.pad_multiple))
    qt = system.queries.terms[:16]
    res = svc.serve_all(list(qt))
    np.testing.assert_array_equal(np.stack([r["ranked"] for r in res]),
                                  srv.serve_batch(qt)["ranked"])


def test_sharded_traffic_on_a_warm_grid_builds_nothing(system, carried,
                                                      jax_counts):
    """The JAX package's mesh case: ``warmup_now([8, 16])`` over a
    ``ShardedEngineBackend`` on the data x model mesh builds the programs
    the JAX engine compiles there, and mixed batch sizes that snap to the
    warmed shapes build nothing (``hot_path``), their lists equal to
    ``serve_batch``."""
    srv = _port_server(system, carried, "k", _mesh((2, 2)))
    backend = t_service.ShardedEngineBackend(
        srv, query_len=system.queries.terms.shape[1])
    svc = t_service.RetrievalService(backend, t_admission.AdmissionConfig(
        max_batch=16, pad_multiple=backend.pad_multiple))
    warmed = svc.warmup_now([8, 16])
    assert [warmed, srv.engine.n_compiles] == jax_counts["warm/(2, 2)"]
    assert srv.engine.n_compiles > 0
    with S.hot_path(srv.engine) as rec:
        for n in (3, 5, 8, 11, 16, 13, 4):
            qt = system.queries.terms[:n]
            res = svc.serve_all(list(qt))
            np.testing.assert_array_equal(
                np.stack([r["ranked"] for r in res]),
                srv.serve_batch(qt)["ranked"])
    assert rec.new_compiles == 0


def test_a_mesh_over_several_devices_raises_when_a_stage_is_built(
        system, carried):
    """A program is captured on one device: with the positions on two
    devices the first stage raises, naming the layout, and nothing is
    built or run in its place."""
    srv = _port_server(system, carried, "rho", _mesh((1, 2)))
    e = srv.engine
    e._devices = (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="over 2 devices"):
        srv.serve_batch(system.queries.terms[:16])
    assert e.n_compiles == 0 and e.program_stats()["programs"] == 0


def test_sharded_backend_requires_sharded_engine(system, carried):
    with pytest.raises(TypeError, match="mesh"):
        t_service.ShardedEngineBackend(_port_server(system, carried, "k"))


def test_sharded_engine_smoke_mesh_through_the_service(tiny_system):
    """On a 1x1 mesh the sharded engine is a drop-in, through the
    service front door (the JAX package's in-process case)."""
    tindex = carry_index(tiny_system)
    cuts = tiny_system.k_cutoffs
    kw = dict(knob="k", cutoffs=cuts, rerank_depth=30,
              stream_cap=tiny_system.cfg.stream_cap)
    ref = t_pipeline.RetrievalServer(tindex, None,
                                     t_pipeline.ServingConfig(**kw),
                                     device="cpu")
    srv = t_pipeline.RetrievalServer(tindex, None,
                                     t_pipeline.ServingConfig(**kw),
                                     device="cpu", mesh=_mesh((1, 1)))
    for s in (ref, srv):
        _stub(s, len(cuts) + 1)
    svc = t_service.RetrievalService(
        t_service.ShardedEngineBackend(srv),
        t_admission.AdmissionConfig(max_batch=16, pad_multiple=8))
    qt = tiny_system.queries.terms[:16]
    res = svc.serve_all(list(qt))
    np.testing.assert_array_equal(np.stack([r["ranked"] for r in res]),
                                  ref.serve_batch(qt)["ranked"])


def test_data_mesh_refused_for_continuous_with_the_jax_reason(system,
                                                             carried):
    srv = _port_server(system, carried, "k", _mesh((2, 2)))
    assert srv.engine.supports_continuous is False
    want = j_engine.ShardedServingEngine.continuous_unsupported_reason.fget(
        types.SimpleNamespace(dp=("data",), dp_size=2,
                              supports_continuous=False))
    assert srv.engine.continuous_unsupported_reason == want
    with pytest.raises(TypeError) as err:
        t_service.ContinuousBackend(srv)
    assert str(err.value) == "ContinuousBackend: " + want


# ------------------------------------------------------------------- CLI --

def test_serve_cli_sharded_on_the_cpu(tmp_path, jax_counts):
    """``--shards 2 --force-host-devices 2`` at the verify sizes, in a
    process of its own (the forced positions are process-wide): the
    programs of its one warmed shape, as many as the JAX sharded engine
    compiles for one padded shape on that mesh."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--knob", "rho", "--batch", "30", "--batches", "3", "--n-docs",
         "2000", "--n-queries", "256", "--census", "", "--shards", "2",
         "--force-host-devices", "2"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr
    assert ("mesh: {'data': 1, 'model': 2} — candidates over 'model', "
            "batches over data axes (pad grid 8)") in r.stdout
    want = jax_counts["engine/(1, 2)/rho/16"]
    assert int(re.search(r"compiles=(\d+)", r.stdout).group(1)) == want
    assert "merge=" in r.stdout
    assert "warmed shapes: [32]" in r.stdout
