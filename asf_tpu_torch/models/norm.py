"""Batch normalisation of the port.

Counterpart of ``asf_tpu/models/norm.py:40-117`` for ``NORM_TYPE="batchnorm"``:
``nn.BatchNorm2d`` with eps 1e-5, momentum 0.1, the biased variance for
normalisation and the unbiased one in ``running_var``. Statistics and
parameters stay float32 whatever the compute dtype: PyTorch's batch norm
takes a bf16 input with float32 parameters, computes in float32 and
returns bf16, as the JAX package's ``TorchBatchNorm`` does with
``dtype=bfloat16``. ``sub_batchnorm`` and ``sync_batchnorm`` come with the
distributed slice.
"""

from __future__ import annotations

from torch import nn


def make_norm(cfg):
    """Returns ``norm(num_features) -> nn.BatchNorm2d`` for the cfg's BN options."""
    if cfg.BN.NORM_TYPE != "batchnorm":
        raise NotImplementedError(f"BN.NORM_TYPE {cfg.BN.NORM_TYPE!r} is not ported yet")
    momentum = cfg.BN.get("MOMENTUM_OVERRIDE", 0.1)

    def norm(num_features: int) -> nn.BatchNorm2d:
        return nn.BatchNorm2d(num_features, eps=1e-5, momentum=momentum)

    return norm
