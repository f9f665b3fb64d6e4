"""Median host ms a train step in the forward and the loss (step.forward)."""

from port_bench import program_spans


def read(run):
    return program_spans.median_ms(run, "step.forward")
