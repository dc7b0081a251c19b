"""torch.cuda.max_memory_reserved() when the window closes (GB)."""

from portbench import readers


def read(run):
    return run.mem_reserved / 1e9
