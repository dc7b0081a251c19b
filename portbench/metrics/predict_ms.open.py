"""Median open-loop predict span a batch: features and cascade (ms)."""

from portbench import readers


def read(run):
    return readers.median_span_ms(run, "predict")
