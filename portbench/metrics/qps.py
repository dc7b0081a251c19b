"""Queries completed in the window over the window's seconds."""

from portbench import readers


def read(run):
    return readers.completed(run) / run.seconds
