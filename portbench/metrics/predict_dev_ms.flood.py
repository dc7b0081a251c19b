"""Median device interval of a served batch's predict program (predict.program dev_ms, ms)."""

import statistics

from portbench import readers


def read(run):
    d = [h.attrs["dev_ms"] for h in readers.spans(run, "predict.program")
         if h.attrs and "dev_ms" in h.attrs and "batch" in h.attrs]
    return statistics.median(d) if d else None
