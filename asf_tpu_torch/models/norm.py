"""Batch normalisation of the port.

Counterpart of ``asf_tpu/models/norm.py:40-117`` for ``NORM_TYPE="batchnorm"``:
``nn.BatchNorm2d`` with eps 1e-5, momentum 0.1, the biased variance for
normalisation and the unbiased one in ``running_var``. Statistics and
parameters stay float32 whatever the compute dtype: PyTorch's batch norm
takes a bf16 input with float32 parameters, computes in float32 and
returns bf16, as the JAX package's ``TorchBatchNorm`` does with
``dtype=bfloat16``. ``sub_batchnorm`` and ``sync_batchnorm`` come with the
distributed slice.

``BN.FREEZE`` (``bn_stats_frozen`` in the JAX package,
``asf_tpu/models/layers.py:165-168, 200, 217, 230``): in train mode every
BN normalises with its running statistics and leaves them as they are,
except the s1 stems' and ``s1_fuse``'s, which the caller exempts.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that, when ``stats_frozen``, runs as in eval mode in train mode too."""

    def __init__(self, num_features, eps, momentum, stats_frozen=False):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.stats_frozen = stats_frozen

    def forward(self, x):
        if self.training and self.stats_frozen:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        return super().forward(x)


def make_norm(cfg):
    """Returns ``norm(num_features, freeze_exempt=False) -> BatchNorm2d`` for
    the cfg's BN options."""
    if cfg.BN.NORM_TYPE != "batchnorm":
        raise NotImplementedError(f"BN.NORM_TYPE {cfg.BN.NORM_TYPE!r} is not ported yet")
    momentum = cfg.BN.get("MOMENTUM_OVERRIDE", 0.1)
    freeze = bool(cfg.BN.FREEZE)

    def norm(num_features: int, freeze_exempt: bool = False) -> BatchNorm2d:
        return BatchNorm2d(num_features, eps=1e-5, momentum=momentum,
                           stats_frozen=freeze and not freeze_exempt)

    return norm
