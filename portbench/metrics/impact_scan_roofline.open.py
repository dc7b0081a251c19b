"""impact_scan's bound at the HBM peak over its traced device time (%)."""

from portbench import readers


def read(run):
    return readers.roofline(run, "impact_scan", "impact_scan_kernel")
