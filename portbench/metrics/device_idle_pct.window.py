"""The share of the traced slice of the window in which no operation ran
on the device."""
from portbench import harness


def read(cell):
    return harness.idle_pct(cell)
