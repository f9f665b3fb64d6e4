"""Classification head, single task or verb/noun.

Counterpart of ``asf_tpu/models/heads.py:52-118``: per-pathway average pool
with **stride = window** (the JAX package's deliberate delta from the
upstream stride 1, ``heads.py:70-78``: it keeps the pathway grids aligned
for inputs longer than NUM_FRAMES), channel concat, dropout (train only)
and ``Linear``: ``projection`` for one task, ``projection_verb`` and
``projection_noun`` for a two-element ``NUM_CLASSES`` (a one-element list is
one task). Train mode returns raw logits (a pair for verb/noun); eval mode
applies the activation and then the mean over the (t', f') positions, for
each task. The state head (``with_state``, a third element) comes with its
slice.

In bf16 the projections compute in bf16 from float32 parameters, as in the
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
        if isinstance(num_classes, (list, tuple)) and len(num_classes) == 1:
            num_classes = num_classes[0]
        if isinstance(num_classes, (list, tuple)) and len(num_classes) != 2:
            raise NotImplementedError(
                f"NUM_CLASSES {list(num_classes)}: the state head is not ported yet")
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(f"{act_func} is not supported as an activation function.")
        self.pool_size = [tuple(p) for p in pool_size]
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 else None
        self.multitask = isinstance(num_classes, (list, tuple))
        if self.multitask:
            self.projection_verb = nn.Linear(sum(dim_in), num_classes[0])
            self.projection_noun = nn.Linear(sum(dim_in), num_classes[1])
        else:
            self.projection = nn.Linear(sum(dim_in), num_classes)
        self.act_func = act_func
        self.compute_dtype = dtype

    def _project(self, x, linear: nn.Linear):
        dt = self.compute_dtype
        x = F.linear(x.to(dt), linear.weight.to(dt), linear.bias.to(dt))
        if not self.training:
            x = x.float()
            x = torch.softmax(x, dim=-1) if self.act_func == "softmax" else torch.sigmoid(x)
            x = x.mean(dim=(1, 2))
        return x.reshape(x.shape[0], -1)

    def forward(self, xs):
        assert len(xs) == len(self.pool_size)
        pooled = [F.avg_pool2d(x, w, stride=w) for x, w in zip(xs, self.pool_size)]
        x = torch.cat(pooled, dim=1).permute(0, 2, 3, 1)  # (B, t', f', C)
        if self.dropout is not None:
            x = self.dropout(x)
        if self.multitask:
            return self._project(x, self.projection_verb), self._project(x, self.projection_noun)
        return self._project(x, self.projection)
