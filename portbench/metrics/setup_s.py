"""Process start to the window's start: imports, kernels, traffic, warm-up."""

from portbench import readers


def read(run):
    return run.setup_s
