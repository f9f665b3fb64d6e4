"""The card's idle share of the traced stretch of a test window."""

from port_bench import readers


def read(run):
    return readers.idle(run)
