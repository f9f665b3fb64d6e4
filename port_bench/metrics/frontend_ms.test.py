"""Device ms a traced test batch in the kernels under the front end (step.frontend)."""

from port_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "step.frontend")
