"""block_topk's bound at the HBM peak over its traced device time (%)."""

from portbench import readers


def read(run):
    return readers.roofline(run, "topk", "block_topk_kernel")
