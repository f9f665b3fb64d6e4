"""Median host ms inside a train_step call (the dispatch)."""

from port_bench import readers


def read(run):
    return readers.host_ms(run)
