"""Loss functions: ``fn(logits_or_preds, labels) -> scalar`` tensors.

Counterparts of ``asf_tpu/models/losses.py:21-91``: the ``get_loss_func``
registry, ``masked_loss`` (0.5 * (BCE(|p|, |y|) + MSE on the +-1 entries),
-10 marks padding) and the dense per-window ``state_cross_entropy``. Every
loss computes in float32 whatever the dtype of its input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE with integer labels (``nn.CrossEntropyLoss``)."""
    return F.cross_entropy(logits.float(), labels.long())


def bce(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``nn.BCELoss`` on probabilities, clipped as the JAX package clips them."""
    p = preds.float().clamp(1e-12, 1.0 - 1e-7)
    y = labels.float()
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p)).mean()


def bce_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits.float(), labels.float())


def mse(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.square(preds.float() - labels.float()).mean()


def masked_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels in {-1, 0, 1}, -10 marking padded entries:
    0.5 * (BCE(|p|, |y|) over unmasked entries + MSE(p, y) where |y| == 1)."""
    preds = preds.float()
    labels = labels.float()
    keep = labels != -10.0

    abs_p = preds.abs().clamp(1e-12, 1.0 - 1e-7)
    abs_y = labels.abs()
    bce_el = -(abs_y * torch.log(abs_p) + (1.0 - abs_y) * torch.log1p(-abs_p))
    bce_term = torch.where(keep, bce_el, 0.0).sum() / keep.sum().clamp(min=1)

    pos = (abs_y == 1.0) & keep
    mse_el = torch.square(preds - labels)
    mse_term = torch.where(pos, mse_el, 0.0).sum() / pos.sum().clamp(min=1)
    return 0.5 * (bce_term + mse_term)


def state_cross_entropy(preds: torch.Tensor, labels: torch.Tensor,
                        divisor=None) -> torch.Tensor:
    """(B, N, P, 3) logits against one-hot labels whose padded windows are -1:
    CE over the class axis, kept where the label vector holds no -1, summed
    and divided by ``divisor(count of kept entries)``; by default the count
    itself, at least 1."""
    preds = preds.float()
    labels = labels.float()
    keep = (labels != -1.0).all(dim=-1)
    ce = -(labels * torch.log_softmax(preds, dim=-1)).sum(dim=-1)
    count = keep.sum()
    return torch.where(keep, ce, 0.0).sum() / (count.clamp(min=1) if divisor is None
                                               else divisor(count))


_LOSSES = {
    "cross_entropy": cross_entropy,
    "bce": bce,
    "bce_logit": bce_logit,
    "mse": mse,
    "masked_loss": masked_loss,
}


def get_loss_func(loss_name: str):
    if loss_name not in _LOSSES:
        raise NotImplementedError(f"Loss {loss_name} is not supported")
    return _LOSSES[loss_name]
