"""Tensor parallelism: the wide conv and dense leaves sharded on their output channels over a model group.

Counterpart of ``asf_tpu/parallel/mesh.py:param_shardings`` (:94-114) and
of the ``(data, model)`` mesh that ``TPU.MODEL_PARALLEL`` makes
(:23-46). The JAX package places each parameter leaf of rank >= 2 whose
trailing axis (a flax kernel's output channels) is divisible by mp and at
least 128 * mp wide on the mesh's ``model`` axis, the optimizer state alike,
and lets GSPMD insert the collectives. Here mp = ``GPU.MODEL_PARALLEL``
ranks form a model group (``parallel/dist.py``), and ``shard_model`` keeps
on model rank r the r-th of mp contiguous blocks of the output channels of
each such leaf: dim 0 of an OIHW conv weight or of an ``nn.Linear``
weight, the same rule on the same axis, and of its bias (which the JAX
package keeps whole: a rank-1 leaf). A sharded layer then computes its
block of the output and gathers the blocks:

* ``_CopyToModelGroup``: the layer's input as it is; backward, its
  gradient (this block's share) summed over the model group;
* ``_GatherFromModelGroup``: the blocks of every model rank, concatenated
  on the channel axis; backward, this rank's block of the gradient.

Every rank of a model group so computes the same full activations, and
every other leaf, replicated, the same gradient. State-dict names do not
change: ``full_state_dicts`` gathers the sharded leaves (and their
optimizer state) whole for a checkpoint, which so loads into one process
with ``strict=True``. The collectives are those gloo implements for CUDA
tensors too (``all_reduce`` and the list form of ``all_gather``), so the
same code runs over NCCL, over gloo on the CPU, and over gloo with several
ranks on one card.

``nn.GRU``'s leaves stay whole on every rank. The JAX package stores them
in torch's ``(3H, I)`` layout, so its rule would shard their input axis;
cuDNN's GRU takes whole weights. That is a difference of layout (and of
memory), not of numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dist

MIN_DIM = 128  # param_shardings' min_dim: a leaf is sharded from 128 * mp output channels


@dataclass(frozen=True)
class Shard:
    """A sharded layer's model group: its process group, its size and this rank's index."""

    group: object
    size: int
    rank: int


def model_shard(cfg) -> Optional[Shard]:
    """This rank's ``Shard`` at ``GPU.MODEL_PARALLEL`` above 1 in a process
    group, else None."""
    mp = dist.model_size(cfg)
    if mp == 1:
        return None
    return Shard(dist.model_group(cfg), mp, dist.model_rank(cfg))


def shardable(shape, mp: int) -> bool:
    """``param_shardings``' rule on a torch weight, whose output axis is dim 0."""
    return len(shape) >= 2 and shape[0] % mp == 0 and shape[0] >= MIN_DIM * mp


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "model_sharded", False)


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard: Shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return dist.all_reduce_sum(grad.contiguous().clone(), ctx.shard.group), None


class _GatherFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard: Shard, dim: int):
        ctx.shard, ctx.dim, ctx.n = shard, dim, y.shape[dim]
        return torch.cat(dist.all_gather(y, shard.group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.shard.rank * ctx.n, ctx.n).contiguous(), None, None


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A sharded bias-free ``conv``'s whole output, computed in ``dtype``. A
    grouped conv's block of output channels reads the input channels of its
    own groups."""
    shard = conv.shard
    x = _CopyToModelGroup.apply(x, shard)
    groups = conv.groups
    if groups > 1:
        groups //= shard.size
        per = x.shape[1] // shard.size
        x = x.narrow(1, shard.rank * per, per)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding,
                 conv.dilation, groups)
    return _GatherFromModelGroup.apply(y, shard, 1)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` from float32 parameters, its output
    gathered over the model group when ``layer`` is sharded."""
    shard = getattr(layer, "shard", None)
    if shard is None:
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    x = _CopyToModelGroup.apply(x, shard)
    y = F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    return _GatherFromModelGroup.apply(y, shard, y.dim() - 1)


def _keep_block(p: nn.Parameter, shard: Shard, optimizer) -> None:
    """``p`` (and its optimizer state) cut to this rank's block of dim 0, in place."""
    full = p.shape[0]
    n = full // shard.size
    lo = shard.rank * n
    p.data = p.data.narrow(0, lo, n).clone()
    p.model_sharded = True
    if optimizer is not None:
        st = optimizer.state.get(p, {})
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() and v.shape[0] == full:
                st[k] = v.narrow(0, lo, n).clone()


def _shardable_layers(model: nn.Module, mp: int) -> list:
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Linear)) and shardable(m.weight.shape, mp)]


def shard_names(model: nn.Module, mp: int) -> list:
    """The weights ``shard_model`` shards at mp ranks a model group."""
    return [f"{name}.weight" for name, _ in _shardable_layers(model, mp)]


def shard_model(model: nn.Module, cfg, optimizer=None) -> list:
    """Keeps this rank's block of every conv and dense weight that
    ``shardable`` picks, and of its bias, with the optimizer's state of both;
    returns the weights' names. Nothing at ``GPU.MODEL_PARALLEL`` 1."""
    shard = model_shard(cfg)
    if shard is None:
        return []
    layers = _shardable_layers(model, shard.size)
    for name, m in layers:
        if isinstance(m, nn.Conv2d) and m.groups > 1 and m.groups % shard.size:
            raise ValueError(f"{name}: {m.groups} conv groups do not split over "
                             f"GPU.MODEL_PARALLEL = {shard.size} ranks")
    for _, m in layers:
        for p in (m.weight, m.bias):
            if p is not None:
                _keep_block(p, shard, optimizer)
        m.shard = shard
    return [f"{name}.weight" for name, _ in layers]


def whole(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """A sharded leaf's (or its gradient's, or its optimizer state's) blocks
    of every rank of the model group, concatenated on dim 0."""
    return torch.cat(dist.all_gather(t, shard.group).unbind(0), dim=0)


def full_state_dicts(model: nn.Module, optimizer, shard: Optional[Shard]) -> tuple[dict, dict]:
    """``(model state dict on the CPU, optimizer state dict)`` with every
    sharded leaf and its optimizer state gathered whole over the model group
    (every rank of the group calls it, in the same order); as they are
    without a shard."""
    params = dict(model.named_parameters())
    model_state = {}
    for k, v in model.state_dict().items():
        p = params.get(k)
        if shard is not None and p is not None and is_sharded(p):
            v = whole(v, shard)
        model_state[k] = v.detach().cpu()
    opt_state = optimizer.state_dict()
    if shard is not None:
        order = [p for g in optimizer.param_groups for p in g["params"]]
        for i, st in opt_state["state"].items():
            if is_sharded(order[i]):
                opt_state["state"][i] = {k: whole(v, shard) if torch.is_tensor(v) and v.dim()
                                         else v for k, v in st.items()}
    return model_state, opt_state


def global_norm(tensors, sharded=None, shard: Optional[Shard] = None) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together. With
    a ``shard``, the tensors flagged in ``sharded`` are this rank's blocks:
    their squares are summed over the model group (one ``all_reduce``), each
    replicated one counted once. Nothing is read back to the host."""
    norms = torch._foreach_norm(list(tensors))
    if shard is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    flags = list(sharded)
    blocks = [n for n, f in zip(norms, flags) if f]
    whole = [n for n, f in zip(norms, flags) if not f]
    total = (torch.stack(blocks).square().sum().reshape(1) if blocks
             else norms[0].new_zeros(1))
    total = dist.all_reduce_sum(total, shard.group)[0]
    if whole:
        total = total + torch.stack(whole).square().sum()
    return total.sqrt()
