"""Serving driver: the multi-stage retrieval system behind the unified
async RetrievalService front door (the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --knob k --batches 8

Runs on the CUDA card unless ``--device cpu`` asks for the CPU; with no
card and no ``--device`` it raises ``RuntimeError``.  Requests are
submitted one at a time with per-request deadlines; the admission queue
forms deadline-ordered batches over the pad grid, the cascade prediction
for batch N+1 overlaps the engine dispatch of batch N (predict on a CUDA
stream of its own), and the warmup policy warms the padded
shapes the queue actually produces.  ``--shards N`` serves through the
mesh-sharded engine (docs over 'model', request batches over 'data')
via ``ShardedEngineBackend``; on the CPU or one card pair it with
``--force-host-devices`` to lay the mesh's positions over the one
device.  Reports latency percentiles with the queue-delay vs
service-time breakdown, mean parameter, and envelope compliance.  The
summary line's ``compiles=`` counts the programs the engine's cache
built, one per stage and padded shape (CUDA graphs on the card), the
JAX driver's count on the same flags; the sharded engine runs eagerly
and reports 0.

The warmup policy persists its padded-shape census to ``--census`` on
``stop()`` and reloads it at construction.  The default lies under the
git-ignored ``build/``, apart from the JAX driver's census.

With ``--online`` the service taps every resolved request into a
telemetry ring and an ``OnlineController`` runs the shadow-label /
retrain / hot-swap loop on idle capacity beside the traffic, then
drains the ring inline and prints an ``online:`` summary line.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knob", default="k", choices=["k", "rho"])
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--threshold", type=float, default=0.75)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=100.0)
    ap.add_argument("--n-docs", type=int, default=8000)
    ap.add_argument("--n-queries", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    ap.add_argument("--shards", type=int, default=1,
                    help="model-axis shards for the candidate dimension")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="data-axis shards for request batches")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="lay N mesh positions over the visible devices")
    ap.add_argument("--census", default="build/repro_torch/warmup_census.json",
                    help="padded-shape census path ('' disables "
                         "persistence)")
    ap.add_argument("--online", action="store_true",
                    help="run the shadow-label/retrain/hot-swap loop on "
                         "idle capacity")
    ap.add_argument("--shadow-sample", type=int, default=None,
                    help="logged queries labeled per shadow cycle "
                         "(default: --batch, so the shadow re-runs pad "
                         "to the already-warmed shape)")
    ap.add_argument("--retrain-every", type=int, default=64,
                    help="new shadow labels between cascade refits")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "here (atomic tmp+rename; '' disables): a host "
                         "lane a thread, its spans with the thread's "
                         "cpu_ms/wait_ms and the collector's gc spans; "
                         "a device lane a stream with each program's "
                         "interval (predict.program, engine.*) on the "
                         "same clock")
    ap.add_argument("--metrics-snapshot", default="",
                    help="append one JSONL metrics snapshot here on exit "
                         "('' disables)")
    args = ap.parse_args(argv)

    from repro_torch.core import cascade as cascade_lib
    from repro_torch.core import experiment as E
    from repro_torch.core import labeling, tradeoff
    from repro_torch.device import resolve_device
    from repro_torch.obs import NULL_OBS, Observability
    from repro_torch.obs import export as obs_export
    from repro_torch.online import (OnlineConfig, OnlineController,
                                    TelemetryBuffer, TrainerConfig)
    from repro_torch.serving import pipeline as sp
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.service import (EngineBackend, RetrievalService,
                                             ShardedEngineBackend,
                                             WarmupPolicy)

    dev = resolve_device(args.device)
    if args.force_host_devices:
        mesh_lib.force_host_device_count(args.force_host_devices)
    mesh = None
    if args.shards > 1 or args.data_shards > 1:
        mesh = mesh_lib.make_serving_mesh(n_model=args.shards,
                                          n_data=args.data_shards, device=dev)
    sys_ = E.build_system(E.ExperimentConfig(
        n_docs=args.n_docs, vocab=args.n_docs * 2,
        n_queries=args.n_queries, stream_cap=1024, pool_depth=2000,
        gold_depth=200, query_batch=128), device=dev)
    cutoffs = sys_.k_cutoffs if args.knob == "k" else sys_.rho_cutoffs
    med = E.med_tables(sys_, args.knob, metrics=("rbp",))["rbp"]
    labels = labeling.envelope_labels(med, args.tau).numpy()
    casc = cascade_lib.train_cascade(
        sys_.features, labels, n_cutoffs=len(cutoffs),
        forest_kwargs=dict(n_trees=10, max_depth=6), device=dev)
    server = sp.RetrievalServer(
        sys_.index, casc, sp.ServingConfig(
            knob=args.knob, cutoffs=cutoffs, threshold=args.threshold,
            rerank_depth=100, stream_cap=sys_.cfg.stream_cap), device=dev,
        mesh=mesh)
    backend_cls = ShardedEngineBackend if mesh is not None else EngineBackend
    backend = backend_cls(server, query_len=sys_.queries.terms.shape[1])
    if mesh is not None:
        print(f"mesh: {mesh.shape} — candidates over 'model', "
              f"batches over data axes (pad grid {backend.pad_multiple})")
    # one observability handle threads through service, admission and
    # engine; disabled unless an export flag asks for it
    obs = (Observability.create()
           if args.trace_out or args.metrics_snapshot else NULL_OBS)
    service = RetrievalService(
        backend,
        AdmissionConfig(max_batch=args.batch,
                        pad_multiple=backend.pad_multiple,
                        default_deadline_ms=args.deadline_ms),
        warmup=WarmupPolicy(census_path=args.census or None),
        telemetry=TelemetryBuffer() if args.online else None,
        obs=obs)
    service.warmup_now([args.batch])       # deploy-time shape; the
    # warmup policy keeps warming whatever shapes admission produces

    controller = None
    if args.online:
        controller = OnlineController(service, server, OnlineConfig(
            tau=args.tau,
            shadow_sample=args.shadow_sample or args.batch,
            trainer=TrainerConfig(
                retrain_every=args.retrain_every,
                min_labels=args.retrain_every,
                forest_kwargs=dict(n_trees=10, max_depth=6))))
        controller.start()

    qn = sys_.queries.n_queries
    with service:
        print(f"{'batch':>6}{'p50_ms':>9}{'q/s':>8}"
              f"{'mean_' + args.knob:>10}{'in_envelope':>12}"
              f"{'queue_p50':>11}")
        for bi in range(args.batches):
            lo = (bi * args.batch) % max(qn - args.batch, 1)
            qt = sys_.queries.terms[lo:lo + args.batch]
            results = service.serve_all(list(qt),
                                        deadline_ms=args.deadline_ms)
            classes = np.array([r["class"] for r in results])
            pct = tradeoff.pct_under_target(
                med[lo:lo + args.batch], classes, args.tau)
            lat_s = np.mean([r["total_ms"] for r in results]) / 1e3
            batch_p50 = float(np.percentile(
                [r["total_ms"] for r in results], 50))
            print(f"{bi:>6}{batch_p50:>9.1f}"
                  f"{args.batch / max(lat_s, 1e-9):>8.0f}"
                  f"{np.mean([r['width'] for r in results]):>10.0f}"
                  f"{pct:>11.1%}"
                  f"{np.percentile([r['queue_ms'] for r in results], 50):>10.1f}")
        if controller is not None:
            # stop the adaptation thread while the service (and its
            # engine) is still up, then drain the telemetry ring inline:
            # under saturation the idle-gated loop may never have found
            # a window
            controller.stop()
            for _ in range(8):
                before = controller.trainer.n_labels
                controller.step()
                if controller.trainer.n_labels == before:
                    break
    if controller is not None:
        st = controller.stats()
        print(f"online: labels={st['n_labels']} "
              f"retrains={st['n_retrains']} swaps={st['n_swaps']} "
              f"version={st['predictor_version']} "
              f"tau_eff={st['tau_effective']:.3f} "
              f"med_ema={st['med_ema']:.4f} fallback={st['fallback']}"
              + (f" last_error={st['last_error']}"
                 if st["last_error"] else ""))
    print(service.stats().summary())
    print("warmed shapes:", sorted(service.warmup.compiled),
          "| shape census:", dict(service.queue.shape_counts),
          "| census file:", args.census or "(disabled)")
    if args.trace_out:
        payload = obs_export.write_chrome_trace(args.trace_out, obs.trace)
        n_x = sum(1 for e in payload["traceEvents"] if e["ph"] == "X")
        print(f"trace: {n_x} spans -> {args.trace_out} "
              f"(recorder {obs.trace.counts()})")
    if args.metrics_snapshot:
        obs_export.write_metrics_snapshot(
            args.metrics_snapshot, obs.metrics,
            extra={"argv_knob": args.knob, "batches": args.batches})
        print(f"metrics snapshot -> {args.metrics_snapshot}")


if __name__ == "__main__":
    main()
