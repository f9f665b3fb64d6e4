"""The test window's share of the card's dense peak: model operations over time."""

from port_bench import readers


def read(run):
    return readers.mfu(run)
