"""Median host ms a test batch waits for the prefetcher (loop.data_wait)."""

from port_bench import program_spans


def read(run):
    return program_spans.median_ms(run, "loop.data_wait")
