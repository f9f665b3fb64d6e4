"""Validation epoch.

Counterpart of ``asf_tpu/engine/eval_loop.py`` (``eval_epoch`` :78-160,
``_eval_legacy`` :313-376, ``build_val_meter`` :379-384) for the single-task
and the verb/noun heads: each batch's probabilities and top-1/top-5
accuracies (verb, noun and action for verb/noun) stay on the card, and the
accuracies are read back once every ``LOG_PERIOD`` batches in one copy.
The last batch runs with its real rows only (the JAX package pads it and
masks the pad rows for XLA's static shapes). With the state head
(``:95-111, 208-210``) each batch's state output, its ``precs``/``posts``
labels and its lengths stay on the card too, and are read back with the
accuracies at the flush; there each batch's state labels are built
(``steps.prepare_state_labels``) and it is scored by the numpy
``metrics.state_metrics`` into the meter. The plots, the JAX package's
``DeviceValCache`` and its fused K-step path are not ported.
"""

from __future__ import annotations

import torch

from ..data.prefetch import prefetch
from . import metrics
from .meters import EPICValMeter, ValMeter
from .steps import has_state_head, is_multitask, prepare_state_labels, state_of


def _state_inputs(probs, batch: dict):
    """The state head's windows, ``precs``, ``posts`` and lengths of a batch,
    where they lie (a single clip: one window)."""
    x_s, lengths = state_of(probs, batch.get("lengths"))
    labels = batch["labels"]
    return x_s, labels["precs"], labels["posts"], lengths


def _score_state(val_meter, state) -> None:
    """``metrics.state_metrics`` of a batch's state inputs, read on the host."""
    x_s, precs, posts, lengths = (t.cpu() for t in state)
    labels = prepare_state_labels(precs, posts, lengths, x_s.shape[1])
    val_meter.update_state_metrics(
        metrics.state_metrics(x_s.numpy(), labels.numpy(), lengths.numpy(), split="Val"))


@torch.inference_mode()
def eval_epoch(val_loader, model, eval_step, val_meter, cur_epoch, cfg, device):
    """Returns ``(is_best, top-1 accuracies)`` from the val meter."""
    log_period = max(1, cfg.LOG_PERIOD)
    multitask = isinstance(val_meter, EPICValMeter)
    with_state = has_state_head(cfg)
    # (iteration, accuracies on the card, rows, host times, state inputs or None)
    pending = []

    def flush():
        if not pending:
            return
        accs = torch.stack([a for _, a, *_ in pending]).cpu().tolist()
        for (it, _, rows, times, state), acc in zip(pending, accs):
            if multitask:  # (verb, noun, action) top-1, then top-5
                val_meter.update_stats(acc[:3], acc[3:], rows)
            else:
                val_meter.update_stats(100.0 - acc[0], 100.0 - acc[1], rows)
            if state is not None:
                _score_state(val_meter, state)
            val_meter.log_iter_stats(cur_epoch, it, times)
        pending.clear()

    src = prefetch(val_loader, device)
    try:
        val_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            val_meter.data_toc()
            probs = eval_step(model, batch)
            accs = torch.stack(_accuracies(probs, batch["labels"], multitask))
            val_meter.iter_toc()
            state = _state_inputs(probs, batch) if with_state else None
            pending.append((cur_iter, accs, batch["n_valid"].shape[0], val_meter.iter_times(),
                            state))
            if (cur_iter + 1) % log_period == 0:
                flush()
            val_meter.iter_tic()
        flush()
    finally:
        src.close()
    is_best, top1 = val_meter.log_epoch_stats(cur_epoch)
    val_meter.reset()
    return is_best, top1


def _accuracies(probs, labels: dict, multitask: bool) -> list:
    """Top-1 and top-5 accuracies, 0-d tensors on the card: of ``class_id``,
    or verb, noun and action top-1 then top-5."""
    if not multitask:
        return metrics.topk_accuracies(probs, labels["class_id"], (1, 5))
    verb, noun = labels["verb"], labels["noun"]
    v1, v5 = metrics.topk_accuracies(probs[0], verb, (1, 5))
    n1, n5 = metrics.topk_accuracies(probs[1], noun, (1, 5))
    a1, a5 = metrics.multitask_topk_accuracies(probs[:2], (verb, noun), (1, 5))
    return [v1, n1, a1, v5, n5, a5]


def build_val_meter(cfg, max_iter: int):
    """The verb/noun meter for a verb/noun head, else the single-task one."""
    if is_multitask(cfg):
        return EPICValMeter(max_iter, cfg)
    return ValMeter(max_iter, cfg)
