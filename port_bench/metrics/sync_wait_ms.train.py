"""Median host ms a train step waits for the card in calls that block (wait.*)."""

from port_bench import program_spans


def read(run):
    return program_spans.median_ms(run, "wait.")
