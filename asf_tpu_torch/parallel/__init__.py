"""Data and tensor parallelism over processes (``torch.distributed``)."""
