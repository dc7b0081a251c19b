"""Share of the traced slice with no device op running (%)."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
