"""Mean real requests a dispatched batch (predict span attribute n)."""

from portbench import readers


def read(run):
    return readers.mean_batch(run)
