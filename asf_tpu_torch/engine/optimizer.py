"""Optimizer construction with the JAX package's update rules.

Counterpart of ``asf_tpu/engine/optimizer.py:27-139``, built on
``torch.optim`` param groups:

* the BN/non-BN split by ``"bn"`` in the dotted parameter name (``:31-34``):
  BN parameters decay by ``BN.WEIGHT_DECAY``, the others by
  ``SOLVER.WEIGHT_DECAY``; the decay is coupled, added to the gradient before
  momentum;
* SGD with momentum, dampening and nesterov (``:47-66``), Adam with torch's
  defaults (``:85-86``);
* ``BN.FREEZE``: the BN parameters other than the s1 stems' and ``s1_fuse``'s
  are left out of the optimizer, so they never move (the JAX chain zeroes
  their updates, ``:37-44, 95-99``);
* ``set_lr``/``get_lr`` (``:104-139``) write and read the LR of every group.

Neither ``torch.optim`` optimizer can be used as it stands. ``SGD`` seeds
the momentum buffer with the first gradient itself, where the JAX chain
starts from a zero trace and its first step moves by ``(1 - dampening) * g``;
and it refuses nesterov with a nonzero dampening, which the JAX chain
computes. ``Adam`` takes its bias corrections ``1 - beta**t`` in float64,
where optax rounds them to float32 (``1 - 0.999`` keeps only ~4 digits
there), which moves parameters ~1e-5 relative apart within a few steps.
``SGD`` and ``Adam`` below are the JAX chain's rules on
``torch.optim.Optimizer``; both update the parameters in place, as
multi-tensor ops. On a data x model grid (``parallel/tensor.py``) a
sharded parameter is this rank's block, and its optimizer state too: the
rules are elementwise, so they need no collective, and the decay groups go
by name, which sharding keeps.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_FREEZE_EXEMPT = ("s1.pathway0_stem.bn", "s1.pathway1_stem.bn", "s1_fuse.bn")


def is_bn_param(name: str) -> bool:
    """The reference's rule: any parameter whose dotted name contains 'bn'."""
    return "bn" in name


def is_frozen_bn_param(name: str) -> bool:
    """BN parameters that ``BN.FREEZE`` holds still: all but the s1 stems' and s1_fuse's."""
    return is_bn_param(name) and not any(e in name for e in _FREEZE_EXEMPT)


def _with_grads(group):
    """The group's parameters that have gradients, and their gradients plus
    the coupled weight decay."""
    params = [p for p in group["params"] if p.grad is not None]
    grads = [p.grad for p in params]
    if params and group["weight_decay"]:
        grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
    return params, grads


class SGD(torch.optim.Optimizer):
    """SGD as the JAX chain computes it, per param group:

        d   = g + weight_decay * p
        buf = momentum * buf + (1 - dampening) * d      (buf starts at zero)
        d   = d + momentum * buf   if nesterov   else   buf
        p   = p - lr * d

    ``lr`` is read from ``lr_tensors``, a 0-d tensor a group on its
    parameters' device and in their dtype, which ``set_lr`` writes with the
    groups' ``"lr"`` (``write_lr``): a step captured in
    a CUDA graph (``engine/graphs.py``) reads each step's LR there, and an
    eager step reads it there too, so that both compute ``lr * d`` and then
    ``p - lr * d`` alike. The rule reads no other host value that changes
    from step to step, so the optimizer is ``graphable``.
    """

    graphable = True

    def __init__(self, params, lr: float, momentum: float = 0.0, dampening: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening, nesterov=nesterov,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.lr_tensors = [torch.full((), group["lr"], dtype=group["params"][0].dtype,
                                      device=group["params"][0].device)
                           if group["params"] else torch.zeros(())
                           for group in self.param_groups]

    def write_lr(self) -> None:
        for group, lr in zip(self.param_groups, self.lr_tensors):
            lr.fill_(group["lr"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        for group, lr in zip(self.param_groups, self.lr_tensors):
            params, grads = _with_grads(group)
            if not params:
                continue
            m = group["momentum"]
            if m:
                states = [self.state[p] for p in params]
                for st, p in zip(states, params):
                    if "momentum_buffer" not in st:
                        st["momentum_buffer"] = torch.zeros_like(p)
                bufs = [st["momentum_buffer"] for st in states]
                torch._foreach_mul_(bufs, m)
                torch._foreach_add_(bufs, grads, alpha=1.0 - group["dampening"])
                grads = torch._foreach_add(grads, bufs, alpha=m) if group["nesterov"] else bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))


def _bias_correction(beta: float, t: int) -> float:
    """``1 - beta**t`` as optax computes it: the float32 power (XLA's is the
    correctly rounded one), then a float32 subtraction."""
    power = np.float32(np.float64(np.float32(beta)) ** t)
    return float(np.float32(1.0) - power)


class Adam(torch.optim.Optimizer):
    """Adam as the JAX chain computes it (``optax.scale_by_adam`` after the
    coupled decay), per param group:

        d = g + weight_decay * p
        m = b1 * m + (1 - b1) * d,   v = b2 * v + (1 - b2) * d**2,   t = t + 1
        p = p - lr * (m / c1) / (sqrt(v / c2) + eps),   c_i = 1 - b_i**t in float32
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for st, p in zip(states, params):
                if not st:
                    st.update(step=0, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            t = states[0]["step"]
            denom = torch._foreach_sqrt(torch._foreach_div(v, _bias_correction(b2, t)))
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(torch._foreach_div(m, _bias_correction(b1, t)), denom)
            torch._foreach_add_(params, update, alpha=-group["lr"])


def construct_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.SOLVER`` over ``model``'s parameters, in two
    groups: ``"bn"`` (decay ``BN.WEIGHT_DECAY``) and ``"non_bn"``
    (``SOLVER.WEIGHT_DECAY``)."""
    bn, non_bn = [], []
    for name, p in model.named_parameters():
        if cfg.BN.FREEZE and is_frozen_bn_param(name):
            continue
        (bn if is_bn_param(name) else non_bn).append(p)
    groups = [
        {"params": bn, "weight_decay": cfg.BN.WEIGHT_DECAY, "name": "bn"},
        {"params": non_bn, "weight_decay": cfg.SOLVER.WEIGHT_DECAY, "name": "non_bn"},
    ]
    method = cfg.SOLVER.OPTIMIZING_METHOD
    lr = cfg.SOLVER.BASE_LR
    if method == "sgd":
        return SGD(groups, lr=lr, momentum=cfg.SOLVER.MOMENTUM,
                   dampening=cfg.SOLVER.DAMPENING, nesterov=cfg.SOLVER.NESTEROV)
    if method == "adam":
        return Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    raise NotImplementedError(f"Does not support {method} optimizer")


def set_lr(optimizer: torch.optim.Optimizer, new_lr: float) -> None:
    """Writes ``new_lr`` into every param group (``asf_tpu/engine/optimizer.py:104-121``),
    and into ``SGD``'s LR tensors."""
    for group in optimizer.param_groups:
        group["lr"] = new_lr
    if isinstance(optimizer, SGD):
        optimizer.write_lr()


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return optimizer.param_groups[0]["lr"]
