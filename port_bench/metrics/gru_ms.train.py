"""Device ms a train step in the kernels of the GRU's cuDNN forward and backward."""

from port_bench import readers


def read(run):
    return readers.device_ms(run, ops=readers.GRU_OPS)
