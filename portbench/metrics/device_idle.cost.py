"""Share of the window with no kernel or copy on the card (torch.profiler), cost cells."""

from portbench import readers


def read(run):
    return readers.device_idle_pct(run)
