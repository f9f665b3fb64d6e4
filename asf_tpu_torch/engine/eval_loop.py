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
``metrics.state_metrics`` into the meter. With a live TensorBoard writer
and ``TENSORBOARD.CONFUSION_MATRIX.ENABLE`` or ``HISTOGRAM.ENABLE``
(``:84-155``) each batch's real score rows (a verb/noun head's verb
scores) and labels are read back with the same flush, and after the epoch
the confusion matrix and the top-k histograms are added at ``global_step =
epoch``, with the class names of ``TENSORBOARD.CLASS_NAMES_PATH``. The JAX
package's ``DeviceValCache`` and its fused K-step path are not ported.

Across ranks each rank scores its rows of each host batch (a padded last
batch: its ``n_real`` real rows, none at times), the correct counts are
summed over the ranks on the card with one ``all_reduce`` and divided by
the global batch's real rows, so every rank's meter takes the numbers of
the JAX package's one program over the whole batch
(``asf_tpu/engine/eval_loop.py:313-376``). The state head's numpy metrics
do not add up over ranks: at the flush each batch's state inputs are
gathered from every rank and rank 0 scores the real rows; so are the
plots' rows, which every rank gathers when the config asks for plots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.prefetch import prefetch
from ..parallel import dist
from ..utils.misc import get_class_names
from . import metrics
from .meters import EPICValMeter, ValMeter
from .steps import has_state_head, is_multitask, prepare_state_labels, state_of


def _state_inputs(probs, batch: dict):
    """The state head's windows, ``precs``, ``posts`` and lengths of a batch,
    where they lie (a single clip: one window)."""
    x_s, lengths = state_of(probs, batch.get("lengths"))
    labels = batch["labels"]
    return x_s, labels["precs"], labels["posts"], lengths


def _gather_rows(tensors, host_rows: int, cfg):
    """A batch's row tensors (state inputs, plot rows) of every rank, their
    real rows in rank order: rank ``h * N + r`` holds rows ``[r * n, (r + 1)
    * n)`` of host ``h``'s batch of ``host_rows`` real rows (every host's is
    as long)."""
    per, gathered = dist.local_size(cfg), [dist.all_gather(t) for t in tensors]
    n = tensors[0].shape[0]
    keep = [max(0, min(n, host_rows - (g % per) * n)) for g in range(dist.world_size())]
    return tuple(torch.cat([t[g, :k] for g, k in enumerate(keep)]) for t in gathered)


def _score_state(val_meter, state) -> None:
    """``metrics.state_metrics`` of a batch's state inputs, read on the host."""
    x_s, precs, posts, lengths = (t.cpu() for t in state)
    labels = prepare_state_labels(precs, posts, lengths, x_s.shape[1])
    val_meter.update_state_metrics(
        metrics.state_metrics(x_s.numpy(), labels.numpy(), lengths.numpy(), split="Val"))


def add_plots(writer, preds, labels, cfg, cur_epoch: int) -> None:
    """The confusion matrix and the top-k histograms of the val epoch's score
    rows ``preds`` (N, classes) and ``labels`` (N,), at ``global_step =
    cur_epoch``."""
    names = None
    if cfg.TENSORBOARD.CLASS_NAMES_PATH:
        names, _, _ = get_class_names(cfg.TENSORBOARD.CLASS_NAMES_PATH)
    if cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE:
        writer.add_confusion_matrix(preds, labels, num_classes=preds.shape[-1],
                                    global_step=cur_epoch, class_names=names)
    if cfg.TENSORBOARD.HISTOGRAM.ENABLE:
        writer.add_topk_histograms(preds, labels, k=cfg.TENSORBOARD.HISTOGRAM.TOPK,
                                   global_step=cur_epoch, class_names=names)


@torch.inference_mode()
def eval_epoch(val_loader, model, eval_step, val_meter, cur_epoch, cfg, device,
               scalar_logger=None):
    """Returns ``(is_best, top-1 accuracies)`` from the val meter."""
    log_period = max(1, cfg.LOG_PERIOD)
    multitask = isinstance(val_meter, EPICValMeter)
    with_state = has_state_head(cfg)
    ranks = dist.world_size()
    writer = None if scalar_logger is None else scalar_logger.tb
    # the plots' rows: every rank gathers them (the config decides, the same
    # on every rank), the writer (rank 0's) plots
    tb = cfg.TENSORBOARD
    collect = bool(tb.ENABLE and (tb.CONFUSION_MATRIX.ENABLE or tb.HISTOGRAM.ENABLE)) and (
        writer is not None or ranks > 1)
    plot_rows = []  # (scores, labels) on the host, a batch each
    # (iteration, accuracies on the card, rows, host times, state inputs or None, host
    # rows, plot inputs or None)
    pending = []

    def flush():
        if not pending:
            return
        accs = torch.stack([a for _, a, *_ in pending]).cpu().tolist()
        if collect:  # the flush's rows in one copy each of the scores and the labels
            plots = [_gather_rows(p[6], p[5], cfg) if ranks > 1 else p[6] for p in pending]
            plot_rows.append(tuple(torch.cat(t).cpu().numpy() for t in zip(*plots)))
        for (it, _, rows, times, state, host_rows, _), acc in zip(pending, accs):
            if multitask:  # (verb, noun, action) top-1, then top-5
                val_meter.update_stats(acc[:3], acc[3:], rows)
            else:
                val_meter.update_stats(100.0 - acc[0], 100.0 - acc[1], rows)
            if state is not None:
                if ranks > 1:
                    state = _gather_rows(state, host_rows, cfg)
                if dist.is_primary():
                    _score_state(val_meter, state)
            val_meter.log_iter_stats(cur_epoch, it, times)
        pending.clear()

    src = prefetch(val_loader, device)
    try:
        val_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            val_meter.data_toc()
            probs = eval_step(model, batch)
            rows = batch["n_valid"].shape[0]
            host_rows, n_real = batch.get("host_rows", rows), batch.get("n_real", rows)
            real = probs[:n_real] if not multitask else [p[:n_real] for p in probs]
            counts = torch.stack(_correct(
                real, {k: v[:n_real] for k, v in batch["labels"].items()}, multitask))
            if ranks > 1:
                counts = dist.all_reduce_sum(counts)
                rows = host_rows * int(cfg.NUM_SHARDS)  # every host's batch is as long
            accs = counts / rows * 100.0
            val_meter.iter_toc()
            state = _state_inputs(probs, batch) if with_state else None
            plot = None
            if collect:
                scores = probs[0] if multitask else probs
                labels = batch["labels"]["verb" if multitask else "class_id"]
                plot = (scores, labels) if ranks > 1 else (scores[:n_real], labels[:n_real])
            pending.append((cur_iter, accs, rows, val_meter.iter_times(), state, host_rows,
                            plot))
            if (cur_iter + 1) % log_period == 0:
                flush()
            val_meter.iter_tic()
        flush()
    finally:
        src.close()
    if writer is not None and plot_rows:
        add_plots(writer, np.concatenate([p for p, _ in plot_rows]),
                  np.concatenate([l for _, l in plot_rows]), cfg, cur_epoch)
    is_best, top1 = val_meter.log_epoch_stats(cur_epoch)
    val_meter.reset()
    return is_best, top1


def _correct(probs, labels: dict, multitask: bool) -> list:
    """Top-1 and top-5 correct counts, 0-d tensors on the card: of
    ``class_id``, or verb, noun and action top-1 then top-5."""
    if not multitask:
        return metrics.topks_correct(probs, labels["class_id"], (1, 5))
    verb, noun = labels["verb"], labels["noun"]
    v1, v5 = metrics.topks_correct(probs[0], verb, (1, 5))
    n1, n5 = metrics.topks_correct(probs[1], noun, (1, 5))
    a1, a5 = metrics.multitask_topks_correct(probs[:2], (verb, noun), (1, 5))
    return [v1, n1, a1, v5, n5, a5]


def build_val_meter(cfg, max_iter: int):
    """The verb/noun meter for a verb/noun head, else the single-task one."""
    if is_multitask(cfg):
        return EPICValMeter(max_iter, cfg)
    return ValMeter(max_iter, cfg)
