"""95th percentile of every request due in the window, from its due time to its result (ms)."""

from portbench import readers


def read(run):
    return readers.p95(readers.latencies_ms(run))
