"""Device ms a train step in batch-norm kernels (readers.BN_PATTERNS)."""

from port_bench import readers


def read(run):
    return readers.device_ms(run, patterns=readers.BN_PATTERNS)
