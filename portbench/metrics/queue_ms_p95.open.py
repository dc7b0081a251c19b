"""95th percentile wait from a request's due time to its batch's predict span (ms)."""

from portbench import readers


def read(run):
    return readers.p95(readers.queue_ms(run))
