"""The JAX package's sharded program counts, for the port's sharded tests.

XLA fixes its CPU device count when JAX starts, and the test process's
JAX has one device, so the JAX sharded engine and scheduler run in a
subprocess over eight forced host devices, on the system of the JAX
package's sharded tests (301 docs), with the port tests' configuration
and stubbed classes.  ``start`` launches it (the port's cases run while
it compiles) and ``result`` reads its counts:

* ``engine/<mesh>/<knob>/<n>``: a fresh server's ``n_compiles`` after
  one ``serve_batch`` of the first ``n`` queries;
* ``fixed/<mesh>``: a fresh k server's after ``serve_fixed`` at
  ``n_docs`` (a pool wider than every shard);
* ``warm/<mesh>``: ``RetrievalService.warmup_now([8, 16])`` over a
  ``ShardedEngineBackend`` and the engine's ``n_compiles`` after it;
* ``sched/<shards>``: a ``ContinuousBackend``'s warmup (slots 8, grain
  4) on a model-only mesh.

A mesh is named by its shape as the port tests give it: (data, model)
or (pod, data, model), or the shard count for the scheduler.
"""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (2, 2, 2)]

_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import numpy as np
    from repro.core import experiment as E
    from repro.launch.mesh import make_serving_mesh
    from repro.serving import pipeline as P
    from repro.serving import service as S
    what, meshes = sys.argv[1].split(","), json.loads(sys.argv[2])
    sys_ = E.build_system(E.ExperimentConfig(
        n_docs=301, vocab=900, n_queries=40, stream_cap=128,
        pool_depth=100, gold_depth=50, query_batch=16, seed=5))
    terms = sys_.queries.terms
    n_docs = sys_.index.corpus.n_docs

    def server(shape, knob):
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        cfg = P.ServingConfig(knob=knob, cutoffs=cuts, rerank_depth=30,
                              stream_cap=sys_.cfg.stream_cap,
                              kernel_block_p=32, kernel_block_d=64,
                              use_kernel=False)
        pod = shape[0] if len(shape) == 3 else 1
        srv = P.RetrievalServer(sys_.index, None, cfg,
                                mesh=make_serving_mesh(shape[-1], shape[-2],
                                                       pod))
        n_cls = len(cuts) + 1
        srv.predict_classes = (
            lambda qt, knob=None: np.arange(qt.shape[0]) % n_cls)
        return srv

    out = {}
    if "engine" in what:
        for shape in map(tuple, meshes):
            for knob in ("k", "rho"):
                for n in (16, 37):
                    srv = server(shape, knob)
                    srv.serve_batch(terms[:n])
                    out[f"engine/{shape}/{knob}/{n}"] = srv.engine.n_compiles
            srv = server(shape, "k")
            srv.serve_fixed(terms[:37], n_docs)
            out[f"fixed/{shape}"] = srv.engine.n_compiles
        srv = server((2, 2), "k")
        svc = S.RetrievalService(
            S.ShardedEngineBackend(srv, query_len=terms.shape[1]),
            S.AdmissionConfig(max_batch=16, pad_multiple=8))
        out["warm/(2, 2)"] = [svc.warmup_now([8, 16]),
                              srv.engine.n_compiles]
    if "sched" in what:
        for shards in (2, 4):
            backend = S.ContinuousBackend(server((1, shards), "rho"),
                                          query_len=terms.shape[1],
                                          slots=8, grain=4)
            S.RetrievalService(backend)
            out[f"sched/{shards}"] = backend.warmup_shape(8)
    print("COUNTS " + json.dumps(out))
""")


def start(what: str) -> subprocess.Popen:
    """Launch the JAX side: ``what`` is ``engine``, ``sched`` or both,
    comma-separated."""
    return subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, what, json.dumps(MESHES)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def result(proc: subprocess.Popen) -> dict:
    """The counts, once the subprocess ends."""
    out, err = proc.communicate(timeout=600)
    line = [ln for ln in out.splitlines() if ln.startswith("COUNTS ")]
    assert proc.returncode == 0 and line, out + err[-3000:]
    return json.loads(line[0][len("COUNTS "):])
