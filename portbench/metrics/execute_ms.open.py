"""Median open-loop execute span a batch: the engine's four stages (ms)."""

from portbench import readers


def read(run):
    return readers.median_span_ms(run, "execute")
