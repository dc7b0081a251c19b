"""Median open-loop engine.stage1 span: impact_scan and the pool selection (ms)."""

from portbench import readers


def read(run):
    return readers.median_span_ms(run, "engine.stage1")
