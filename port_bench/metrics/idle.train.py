"""The card's idle share of the traced stretch of a train window (train cells)."""

from port_bench import readers


def read(run):
    return readers.idle(run)
