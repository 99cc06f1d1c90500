"""Least card time for the rungs' word steps / device time of the program's kernels, cost cells."""

from portbench import readers


def read(run):
    return readers.rung_roofline_pct(run)
