"""Seconds from the process's start to the window's: inputs, the port's build and warm-up, warm traffic."""

from portbench import readers


def read(run):
    return run.setup_s
