"""Classification head.

Counterpart of ``asf_tpu/models/heads.py:52-118`` (single task): per-pathway
average pool with **stride = window** (the JAX package's deliberate delta
from the upstream stride 1, ``heads.py:70-78``: it keeps the pathway grids
aligned for inputs longer than NUM_FRAMES), channel concat, dropout (train
only) and ``Linear``. Train mode returns raw logits; eval mode applies the
activation and then the mean over the (t', f') positions.

In bf16 the projection computes in bf16 from float32 parameters, as in the
JAX package; the activation and the mean run in float32 here (the JAX
package keeps them in bf16), so probabilities come out float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ResNetBasicHead(nn.Module):
    def __init__(self, dim_in: Sequence[int], num_classes: int, pool_size, dropout_rate=0.0,
                 act_func="softmax", dtype=torch.float32):
        super().__init__()
        if isinstance(num_classes, (list, tuple)):
            raise NotImplementedError("multi-task heads are not ported yet")
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(f"{act_func} is not supported as an activation function.")
        self.pool_size = [tuple(p) for p in pool_size]
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 else None
        self.projection = nn.Linear(sum(dim_in), num_classes)
        self.act_func = act_func
        self.compute_dtype = dtype

    def forward(self, xs):
        assert len(xs) == len(self.pool_size)
        pooled = [F.avg_pool2d(x, w, stride=w) for x, w in zip(xs, self.pool_size)]
        x = torch.cat(pooled, dim=1).permute(0, 2, 3, 1)  # (B, t', f', C)
        if self.dropout is not None:
            x = self.dropout(x)
        dt = self.compute_dtype
        x = F.linear(x.to(dt), self.projection.weight.to(dt), self.projection.bias.to(dt))
        if not self.training:
            x = x.float()
            x = torch.softmax(x, dim=-1) if self.act_func == "softmax" else torch.sigmoid(x)
            x = x.mean(dim=(1, 2))
        return x.reshape(x.shape[0], -1)
