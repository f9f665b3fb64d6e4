"""Host ms a train step in train_epoch's flushes (loop.flush), one every LOG_PERIOD steps."""

from port_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "loop.flush")
