"""Classification head: single task, verb/noun, or verb/noun with the state head.

Counterpart of ``asf_tpu/models/heads.py:52-118``: per-pathway average pool
with **stride = window** (the JAX package's deliberate delta from the
upstream stride 1, ``heads.py:70-78``: it keeps the pathway grids aligned
for inputs longer than NUM_FRAMES), channel concat, dropout (train only)
and ``Linear``: ``projection`` for one task, ``projection_verb`` and
``projection_noun`` for a two-element ``NUM_CLASSES`` (a one-element list is
one task). Train mode returns raw logits (a pair for verb/noun); eval mode
applies the activation and then the mean over the (t', f') positions, for
each task.

The state head (``with_state``, chosen by ``builders.py``: a third
``NUM_CLASSES`` element P and ``MODEL.ONLY_ACTION_RECOGNITION`` off; the
JAX package's ``heads.py:99-112``) adds three ``Linear(F, P)`` projections,
``projection_min_1``, ``projection_0`` and ``projection_1``: the logits of
each attribute being false, absent or true, stacked on a class axis,
softmaxed over it in eval mode only, averaged over (t', f') and returned as
a third output (B, P, 3). Without ``with_state`` a third element is not
read, as in the JAX package.

In bf16 the projections compute in bf16 from float32 parameters, as in the
JAX package; the activation and the mean run in float32 here (the JAX
package keeps them in bf16), so probabilities come out float32. A
projection that ``parallel/tensor.py:shard_model`` sharded computes its
block of the classes and gathers the blocks (``tensor.linear``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor

# The state head's projections, in the order of the class axis: an
# attribute false (-1), absent (0), true (+1).
STATE_PROJECTIONS = ("projection_min_1", "projection_0", "projection_1")


class ResNetBasicHead(nn.Module):
    def __init__(self, dim_in: Sequence[int], num_classes: int, pool_size, dropout_rate=0.0,
                 act_func="softmax", dtype=torch.float32, with_state: bool = False):
        super().__init__()
        if isinstance(num_classes, (list, tuple)) and len(num_classes) == 1:
            num_classes = num_classes[0]
        self.with_state = with_state
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(f"{act_func} is not supported as an activation function.")
        self.pool_size = [tuple(p) for p in pool_size]
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 else None
        self.multitask = isinstance(num_classes, (list, tuple))
        if self.multitask:
            self.projection_verb = nn.Linear(sum(dim_in), num_classes[0])
            self.projection_noun = nn.Linear(sum(dim_in), num_classes[1])
            if with_state:
                for name in STATE_PROJECTIONS:
                    self.add_module(name, nn.Linear(sum(dim_in), num_classes[2]))
        else:
            self.projection = nn.Linear(sum(dim_in), num_classes)
        self.act_func = act_func
        self.compute_dtype = dtype

    def _linear(self, x, linear: nn.Linear):
        return tensor.linear(x, linear, self.compute_dtype)

    def _project(self, x, linear: nn.Linear):
        x = self._linear(x, linear)
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
        if not self.multitask:
            return self._project(x, self.projection)
        out = self._project(x, self.projection_verb), self._project(x, self.projection_noun)
        if not self.with_state:
            return out
        s = torch.stack([self._linear(x, getattr(self, n)) for n in STATE_PROJECTIONS],
                        dim=-2).float()  # (B, t', f', 3, P)
        if not self.training:
            s = torch.softmax(s, dim=-2)
        return (*out, s.mean(dim=(1, 2)).transpose(-1, -2))  # (B, P, 3)
