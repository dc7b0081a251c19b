"""A cell cut to a size that a CPU test run holds: the tests drive the
harness, the reference and the port with it on the CPU."""

from __future__ import annotations

import copy
import json

from portbench import bench

#: the configuration keys a tiny run overrides
TINY = dict(n_docs=1500, vocab=4000, n_queries=360, train_queries=240,
            stream_cap=256, pool_depth=400, gold_depth=100)
#: each knob's cutoffs at the tiny stream cap (256) and pool (400)
TINY_CUTOFFS = dict(rho=[8, 8, 8, 8, 10, 25, 51, 102, 256],
                    k=[20, 50, 100, 200, 400, 400, 400, 400, 400])
#: the traffic keys a tiny run overrides
TINY_TRAFFIC = dict(warm_s=0.3, profile_s=0.2, check_sample=48,
                    check_longest=4, max_batch=32)


#: cells that the tests drive with no entry in ``BENCHMARK.json``: the
#: k knob's open loop (kept for a later cell, PERF.md section 7), read
#: as the listed cell's entries with its own configuration and traffic
UNLISTED = {"k-open": ("rho-open", "paperish-k", "k-open")}


def spec(cell: str, root=bench.ROOT) -> dict:
    if cell in UNLISTED:
        base, config, traffic = UNLISTED[cell]
        s = copy.deepcopy(bench.load_spec(base, root))
        pb = root / "portbench"
        s["config"] = json.loads(
            (pb / "configs" / f"{config}.json").read_text())
        s["traffic"] = json.loads(
            (pb / "workloads" / f"{traffic}.json").read_text())
    else:
        s = copy.deepcopy(bench.load_spec(cell, root))
    s["config"].update(TINY, cutoffs=TINY_CUTOFFS[s["config"]["knob"]])
    t = s["traffic"]
    t.update(TINY_TRAFFIC)
    if t["loop"] == "open":
        t["rate_qps"] = 200.0
    else:
        t["clients"] = 64
    return s
