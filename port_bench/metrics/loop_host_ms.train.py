"""Median host ms from a train_step's return to the next call (loop, flush, prefetch)."""

from port_bench import readers


def read(run):
    return readers.host_ms(run, between=True)
