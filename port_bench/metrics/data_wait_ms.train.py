"""Median host ms a train step waits for its batch from the prefetcher (loop.data_wait)."""

from port_bench import program_spans


def read(run):
    return program_spans.median_ms(run, "loop.data_wait")
