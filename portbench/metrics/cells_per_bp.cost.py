"""BatchStats.cells_computed over the window's batches / bases aligned, cost cells."""

from portbench import readers


def read(run):
    return readers.cells_per_bp(run)
