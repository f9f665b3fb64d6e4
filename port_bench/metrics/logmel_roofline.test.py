"""The log-mel kernel (K1's logmel_f32_kernel or K2's logmel_tc_kernel) against its
least time, in test steps."""

from port_bench import readers


def read(run):
    return readers.logmel_roofline(run)
