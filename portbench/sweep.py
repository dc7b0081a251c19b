"""The knee sweep of an open-loop cell: one set-up, then one window at
each offered rate, rising and then falling, each printed as one JSON
line.  Latency is the cell's own (``readers.latencies_ms``: a request
that failed or was not done when the harness stopped waiting counts the
wait it had).  A rate is sustained when 95% of its requests finish
inside the deadline and the backlog does not grow: the p95 latency of
the window's last fifth stays within twice its first fifth's."""

from __future__ import annotations

import gc
import json
import time

import numpy as np

from portbench import bench, readers
from portbench.gcwatch import GCWatch
from portbench import traffic as traffic_lib


def run(spec, seed, seconds, rates, device, t_begin) -> None:
    from portbench import port
    cfg, traffic = spec["config"], spec["traffic"]
    sd = bench.seed_streams(seed)
    times: dict = {}
    inputs = bench.make_inputs(cfg, sd, device, times)
    server, backend, service = port.build(inputs, cfg, traffic, device)
    payloads = list(inputs.served)
    service.start()
    bench.log(f"portbench sweep: set-up {time.perf_counter() - t_begin:.1f}"
              f" s {json.dumps({k: round(v, 2) for k, v in times.items()})}")
    deadline = float(traffic["deadline_ms"])
    # each rate twice, rising and then falling, so that neither the
    # order nor what a process has served before sets the knee
    for rate in list(rates) + list(reversed(rates)):
        tr = dict(traffic, rate_qps=rate, loop="open")
        backend.predicts.clear()
        backend.executes.clear()
        gc.collect()
        t_start = time.perf_counter() + 0.01
        with GCWatch() as gcw:
            reqs, t0, t1 = traffic_lib.drive_open(
                service, payloads, tr, t_start, 1.0, seconds, sd["traffic"])
        t_close = time.perf_counter() + float(traffic["drain_s"])
        service.drain(timeout=30.0)
        a = reqs.arrays()
        win = (a["due"] >= t0) & (a["due"] < t1)
        failed = a["failed"][win] | np.isnan(a["done"][win])
        late = failed | (a["done"][win] > t_close)
        run = bench.RunData(
            config=cfg, traffic=tr, seconds=seconds, t0=t0, t1=t1,
            due=a["due"][win], done=np.where(late, np.nan, a["done"][win]),
            failed=late, t_close=t_close, batch_of=None, batches={},
            spans=[], trace=None, setup_s=0.0, mem_reserved=0)
        lat = readers.latencies_ms(run)
        fifth = len(lat) // 5
        within = float(np.mean(~late & (lat <= deadline)))
        first = float(np.percentile(lat[:fifth], 95))
        last = float(np.percentile(lat[-fifth:], 95))
        ex = [e for e in backend.executes if t0 <= e[0] < t1]
        pr = [p for p in backend.predicts if t0 <= p[0] < t1]
        print(json.dumps(dict(
            rate=rate, requests=int(win.sum()), failed=int(failed.sum()),
            p50_ms=float(np.percentile(lat, 50)),
            p95_ms=float(np.percentile(lat, 95)),
            p99_ms=float(np.percentile(lat, 99)),
            within_deadline=within, p95_first_fifth_ms=first,
            p95_last_fifth_ms=last,
            sustained=bool(within >= 0.95 and last <= 2 * first),
            done_qps=readers.completed(run) / seconds, gc=gcw.summary(t0, t1),
            batches=len(ex), mean_batch=float(np.mean(
                [e[2].shape[0] for e in ex])) if ex else 0.0,
            execute_ms_p50=float(np.median(
                [(e[1] - e[0]) * 1e3 for e in ex])) if ex else 0.0,
            predict_ms_p50=float(np.median(
                [(p[1] - p[0]) * 1e3 for p in pr])) if pr else 0.0,
            late_p99_ms=float(np.percentile(
                (a["sent"] - a["due"])[win], 99) * 1e3))), flush=True)
    service.stop()
    del server, backend
