"""Median over served batches of the summed device intervals of the batch's engine.* stage programs (dev_ms, ms)."""

import statistics


def read(run):
    per: dict = {}
    for h in run.spans:
        if h.name.startswith("engine.") and h.attrs and "batch" in h.attrs:
            per.setdefault(h.attrs["batch"], []).append(h.attrs.get("dev_ms"))
    sums = [sum(v) for v in per.values() if None not in v]
    return statistics.median(sums) if sums else None
