"""Host seconds in the pack layer (BatchAligner._pack) / window seconds, cost cells."""

from portbench import readers


def read(run):
    return readers.span_share_pct(run, "pack")
