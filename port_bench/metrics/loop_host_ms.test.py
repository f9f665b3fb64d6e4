"""Median host ms from an eval_step's return to the next call (loop, meter)."""

from port_bench import readers


def read(run):
    return readers.host_ms(run, between=True)
