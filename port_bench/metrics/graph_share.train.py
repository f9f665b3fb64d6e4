"""Share of the window's untraced train steps run as a CUDA graph (step.replay), %."""

from port_bench import graph_share


def read(run):
    return graph_share.share(run)
