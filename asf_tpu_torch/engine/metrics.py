"""Top-k accuracies on the device.

Counterparts of ``asf_tpu/engine/metrics.py:24-62``: ``topks_correct``,
``topk_accuracies`` and the joint (every task right) multitask pair. Each
returns 0-d float32 tensors on the input's device, so the train step reads
nothing back to the host.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _top_idx(preds: torch.Tensor, max_k: int) -> torch.Tensor:
    """(N, C) -> (N, max_k) indices of the top-k scores."""
    return torch.topk(preds, max_k, dim=1).indices


def topks_correct(preds: torch.Tensor, labels: torch.Tensor, ks: Sequence[int]):
    """Number of correct top-k predictions for each k. preds (N, C), labels (N,)."""
    top = _top_idx(preds, max(ks))
    correct = top == labels[:, None]
    return [correct[:, :k].any(dim=1).sum().float() for k in ks]


def topk_accuracies(preds, labels, ks=(1, 5)):
    n = preds.shape[0]
    return [c / n * 100.0 for c in topks_correct(preds, labels, ks)]


def multitask_topks_correct(preds, labels, ks=(1,)):
    """A sample is correct at k iff every task's label is in that task's top-k."""
    max_k = int(max(ks))
    all_correct = 0
    for output, label in zip(preds, labels):
        all_correct = all_correct + (_top_idx(output, max_k).T == label[None, :]).int()
    task_count = len(preds)
    return [(all_correct[:k].sum(dim=0) >= task_count).float().sum() for k in ks]


def multitask_topk_accuracies(preds, labels, ks=(1, 5)):
    n = preds[0].shape[0]
    return [c / n * 100.0 for c in multitask_topks_correct(preds, labels, ks)]
