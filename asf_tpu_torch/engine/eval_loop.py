"""Validation epoch.

Counterpart of ``asf_tpu/engine/eval_loop.py`` (``eval_epoch`` :78-160,
``_eval_legacy`` :313-376, ``build_val_meter`` :379-384) for the single-task
head: each batch's probabilities and top-1/top-5 accuracies stay on the
card, and the accuracies are read back once every ``LOG_PERIOD`` batches in
one copy. The last batch runs with its real rows only (the JAX package pads
it and masks the pad rows for XLA's static shapes). The plots, the JAX
package's ``DeviceValCache`` and its fused K-step path are not ported; the
verb/noun meters come with the EPIC slice.
"""

from __future__ import annotations

import torch

from ..data.prefetch import prefetch
from . import metrics
from .meters import ValMeter
from .steps import is_multitask


@torch.inference_mode()
def eval_epoch(val_loader, model, eval_step, val_meter, cur_epoch, cfg, device):
    """Returns ``(is_best, {"top1_acc": ...})`` from the val meter."""
    log_period = max(1, cfg.LOG_PERIOD)
    pending = []  # (iteration, (top1 acc, top5 acc) on the card, rows, host times)

    def flush():
        if not pending:
            return
        accs = torch.stack([a for _, a, _, _ in pending]).cpu().tolist()
        for (it, _, rows, times), (k1, k5) in zip(pending, accs):
            val_meter.update_stats(100.0 - k1, 100.0 - k5, rows)
            val_meter.log_iter_stats(cur_epoch, it, times)
        pending.clear()

    src = prefetch(val_loader, device)
    try:
        val_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            val_meter.data_toc()
            probs = eval_step(model, batch)
            labels = batch["labels"]["class_id"]
            accs = torch.stack(metrics.topk_accuracies(probs, labels, (1, 5)))
            val_meter.iter_toc()
            pending.append((cur_iter, accs, labels.shape[0], val_meter.iter_times()))
            if (cur_iter + 1) % log_period == 0:
                flush()
            val_meter.iter_tic()
        flush()
    finally:
        src.close()
    is_best, top1 = val_meter.log_epoch_stats(cur_epoch)
    val_meter.reset()
    return is_best, top1


def build_val_meter(cfg, max_iter: int):
    if is_multitask(cfg):
        raise NotImplementedError("the verb/noun val meter comes with the EPIC slice")
    return ValMeter(max_iter, cfg)
