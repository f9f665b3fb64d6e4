"""Median host ms a train step in zero_grad and backward (step.backward)."""

from port_bench import program_spans


def read(run):
    return program_spans.median_ms(run, "step.backward")
