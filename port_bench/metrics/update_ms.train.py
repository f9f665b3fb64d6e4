"""Device ms a traced train step in the kernels of the LR and SGD update (step.update)."""

from port_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "step.update")
