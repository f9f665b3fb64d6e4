"""Median host ms a test batch in perform_test's copy, event and meter (loop.meter)."""

from port_bench import program_spans


def read(run):
    return program_spans.median_ms(run, "loop.meter")
