"""Data parallelism over processes (``torch.distributed``)."""
