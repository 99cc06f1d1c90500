"""Bases aligned (cost only) in the window's yielded batches / window seconds."""

from portbench import readers


def read(run):
    return readers.window_rate_mbp_s(run)
