"""Share of the window's untraced test batches scored by a CUDA graph (step.replay), %."""

from port_bench import graph_share


def read(run):
    return graph_share.share(run)
