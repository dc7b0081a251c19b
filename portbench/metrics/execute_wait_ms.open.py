"""Mean time a batch's execute span's thread spent off a CPU (wait_ms = span ms - thread CPU ms), over the batches no full collection paused (ms).

The mean, not the median: where the thread clock advances in 10 ms ticks
(as under a gVisor sandbox), a span's cpu_ms is a whole number of ticks,
right only on average.  A full (gen-2) collection stops every thread for
100-300 ms; gc_ms_per_s carries it."""

import statistics

from portbench import readers


def read(run):
    full = [(h.t0, h.t1) for h in run.spans
            if h.name == "gc" and h.attrs and h.attrs.get("gen") == 2]
    d = [h.attrs["wait_ms"] for h in readers.spans(run, "execute")
         if h.attrs and "wait_ms" in h.attrs
         and not any(a < h.t1 and h.t0 < b for a, b in full)]
    return statistics.fmean(d) if d else None
