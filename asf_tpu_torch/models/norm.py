"""Batch normalisation of the port: ``batchnorm``, ``sub_batchnorm`` and ``sync_batchnorm``.

Counterpart of ``asf_tpu/models/norm.py:40-187``. Every type normalises
with the biased variance, eps 1e-5 and momentum 0.1, keeps its statistics
and parameters in float32 whatever the compute dtype (a bf16 input comes
back bf16), and has the leaves of ``nn.BatchNorm2d`` (``weight``,
``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``).

* ``batchnorm`` in one process, or at world size 1, is ``nn.BatchNorm2d``
  (cuDNN): the unbiased variance goes into ``running_var``. Across ranks
  the JAX package normalises over the whole logical batch (``:6``,
  ``:96-101``), so the port's ``batchnorm`` then takes its statistics over
  every rank (``GroupedBatchNorm2d`` with one split).
* ``sub_batchnorm`` cuts the global batch into ``BN.NUM_SPLITS`` contiguous
  splits, each normalised with its own statistics (``:76-95``); the running
  statistics aggregate them (the mean of the split means; the mean of the
  split variances plus the variance between the split means) and take the
  unbiased update with n the count of one split (``:95, 106-108``).
* ``sync_batchnorm`` normalises over groups of ``BN.NUM_SYNC_DEVICES``
  adjacent ranks: ``world / k`` splits (``sync_bn_splits``, ``:120-132``),
  aggregated as for ``sub_batchnorm`` into one running copy, equal on every
  rank, that stores the biased variance (``:47-53``, ``:183``).
  ``torch.nn.SyncBatchNorm`` keeps a copy a rank and stores the unbiased
  variance, so it is not used.

``GroupedBatchNorm2d`` runs both in one ``torch.autograd.Function``: each
rank's float32 ``torch.var_mean`` of its segments (two-pass, biased;
float64 for a float64 input), the
(mean, variance, count) of every segment gathered over the world (C-wide
vectors, one ``all_gather``) and merged in float64 by Chan's formula into
the statistics of each split; the backward sums ``dy`` and ``dy * x_hat``
over a split's ranks with one ``all_reduce``. The JAX package's one-pass
``E[x^2] - E[x]^2`` is the less accurate of the two where a channel's mean
dwarfs its spread (``ROADMAP.md`` §3, "BN variance in one pass").

``BN.FREEZE`` (``bn_stats_frozen`` in the JAX package,
``asf_tpu/models/layers.py:165-168, 200, 217, 230``): in train mode every
BN normalises with its running statistics and leaves them as they are
(no collective), except the s1 stems' and ``s1_fuse``'s, which the caller
exempts. ``momentum=None`` (precise BN) keeps the cumulative average.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist


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


def _segments(x: torch.Tensor, n_seg: int, dtype: torch.dtype) -> torch.Tensor:
    """(N, C, ...) -> (n_seg, N / n_seg, C, positions) in ``dtype``."""
    return x.to(dtype).reshape(n_seg, x.shape[0] // n_seg, x.shape[1], -1)


class _GroupedNorm(torch.autograd.Function):
    """Forward: ``(y, split means, split variances, split counts)``; the
    statistics are those of every split of the global batch (float64), for
    the running update, and carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, num_splits: int):
        world, rank = dist.world_size(), dist.rank()
        n_seg, span = dist.split_layout(num_splits, world)
        if x.shape[0] % n_seg:
            raise ValueError(f"SubBatchNorm: batch {x.shape[0]} on this rank not divisible by "
                             f"its {n_seg} splits")
        c = x.shape[1]
        xs = _segments(x, n_seg, torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xs, dim=(1, 3), unbiased=False)  # (n_seg, C) each
        count = torch.full((n_seg, 1), float(xs.shape[1] * xs.shape[3]), dtype=torch.float64,
                           device=x.device)
        seg = torch.cat([mean.double(), var.double(), count], dim=1)  # (n_seg, 2C + 1)
        if world > 1:
            seg = dist.all_gather(seg).reshape(-1, 2 * c + 1)  # every segment, in rank order
        # Chan's formula over the segments of each split
        seg = seg.reshape(num_splits, -1, 2 * c + 1)
        m, v, n = seg[..., :c], seg[..., c:2 * c], seg[..., 2 * c:]
        total = n.sum(dim=1)  # (splits, 1)
        split_mean = (n * m).sum(dim=1) / total
        split_var = ((n * v).sum(dim=1) + (n * (m - split_mean[:, None]) ** 2).sum(dim=1)) / total
        first = rank * n_seg // span  # this rank's first split
        mu = split_mean[first:first + n_seg].to(xs.dtype)[:, None, :, None]
        rstd = torch.rsqrt(split_var[first:first + n_seg].to(xs.dtype) + eps)[:, None, :, None]
        xhat = (xs - mu) * rstd
        y = xhat * weight[:, None] + bias[:, None]
        ctx.save_for_backward(x, weight, mu, rstd, total[first:first + n_seg].to(xs.dtype))
        ctx.layout = (num_splits, n_seg, span, first)
        ctx.mark_non_differentiable(split_mean, split_var, total)
        return y.reshape(x.shape).to(x.dtype), split_mean, split_var, total

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, mu, rstd, total = ctx.saved_tensors
        num_splits, n_seg, span, first = ctx.layout
        xhat = (_segments(x, n_seg, mu.dtype) - mu) * rstd
        dys = _segments(dy, n_seg, mu.dtype)
        sum_dy = dys.sum(dim=(1, 3))  # (n_seg, C)
        sum_dy_xhat = (dys * xhat).sum(dim=(1, 3))
        grad_weight = sum_dy_xhat.sum(dim=0)  # this rank's share; DDP averages the ranks'
        grad_bias = sum_dy.sum(dim=0)
        sums = torch.stack([sum_dy, sum_dy_xhat], dim=1)  # (n_seg, 2, C)
        if span > 1:  # a split spans ranks: its sums over them, as one all_reduce over the world
            rows = sums.new_zeros((num_splits,) + sums.shape[1:])
            rows[first:first + n_seg] = sums
            sums = dist.all_reduce_sum(rows)[first:first + n_seg]
        mean_dy = (sums[:, 0] / total)[:, None, :, None]
        mean_dy_xhat = (sums[:, 1] / total)[:, None, :, None]
        dx = (dys - mean_dy - xhat * mean_dy_xhat) * (rstd * weight[:, None])
        return dx.reshape(x.shape).to(x.dtype), grad_weight, grad_bias, None, None


class GroupedBatchNorm2d(BatchNorm2d):
    """Batch norm over ``num_splits`` contiguous splits of the global batch,
    which may span ranks or lie within one; ``unbiased_running`` picks the
    variance the running copy takes. Eval mode and ``stats_frozen`` use the
    running statistics as ``BatchNorm2d`` does."""

    def __init__(self, num_features, eps, momentum, stats_frozen=False, *, num_splits: int,
                 unbiased_running: bool):
        super().__init__(num_features, eps, momentum, stats_frozen)
        self.num_splits = num_splits
        self.unbiased_running = unbiased_running

    def forward(self, x):
        if not self.training or self.stats_frozen:
            return super().forward(x)
        y, split_mean, split_var, total = _GroupedNorm.apply(x, self.weight, self.bias, self.eps,
                                                            self.num_splits)
        with torch.no_grad():
            mean = split_mean.mean(dim=0)
            var = split_var.mean(dim=0) + ((split_mean - mean) ** 2).mean(dim=0)
            if self.unbiased_running:
                n = total[0]
                var = var * (n / (n - 1.0).clamp(min=1.0))
            self.num_batches_tracked.add_(1)
            factor = self.momentum
            if factor is None:  # the cumulative average (precise BN), on the device
                factor = self.num_batches_tracked.double().reciprocal()
            self.running_mean.copy_(self.running_mean * (1.0 - factor) + mean * factor)
            self.running_var.copy_(self.running_var * (1.0 - factor) + var * factor)
        return y


def make_norm(cfg):
    """Returns ``norm(num_features, freeze_exempt=False)`` for the cfg's BN
    options and this process's world (read when the model is built)."""
    norm_type = cfg.BN.NORM_TYPE
    momentum = cfg.BN.get("MOMENTUM_OVERRIDE", 0.1)
    freeze = bool(cfg.BN.FREEZE)
    if norm_type == "batchnorm":
        num_splits = None if dist.world_size() == 1 else 1
    elif norm_type == "sub_batchnorm":
        num_splits = int(cfg.BN.NUM_SPLITS)
    elif norm_type == "sync_batchnorm":
        dist.check_sync_bn_mesh(cfg)
        num_splits = dist.sync_bn_splits(cfg)
    else:
        raise NotImplementedError(f"BN.NORM_TYPE {norm_type!r}")
    if num_splits is not None:
        dist.split_layout(num_splits, dist.world_size())  # raises for splits that cross ranks

    def norm(num_features: int, freeze_exempt: bool = False) -> BatchNorm2d:
        frozen = freeze and not freeze_exempt
        if num_splits is None:
            return BatchNorm2d(num_features, eps=1e-5, momentum=momentum, stats_frozen=frozen)
        return GroupedBatchNorm2d(num_features, eps=1e-5, momentum=momentum,
                                  stats_frozen=frozen, num_splits=num_splits,
                                  unbiased_running=norm_type != "sync_batchnorm")

    return norm
