"""Padded windows over the windows the trunk computed in the train window."""

from port_bench import readers


def read(run):
    return readers.pad_share(run)
