"""The collector's pauses: summed gc span ms that start in the window, over its seconds (ms/s)."""


def read(run):
    # a recorder that records collections splits its spans' thread time
    # too; one without (an older program) has nothing to read
    if not any(h.attrs and "cpu_ms" in h.attrs for h in run.spans):
        return None
    return sum(h.dur_ms for h in run.spans if h.name == "gc") / run.seconds
