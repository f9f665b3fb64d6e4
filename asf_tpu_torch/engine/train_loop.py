"""The training loop: ``train(cfg)``.

Counterpart of ``asf_tpu/engine/train_loop.py:48-527``: seed, build the
model and optimizer, resume or warm-start (``checkpoint/manager.py``), then
for each epoch: reshuffle, ``train_epoch``, precise BN, a periodic
checkpoint, and every ``EVAL_PERIOD`` epochs and at the last a val epoch,
with ``checkpoint_best`` saved when its top-1 error is the lowest yet (for
verb/noun: its action top-1 accuracy the highest). An EPIC-KITCHENS run
with ``EPICKITCHENS.TRAIN_PLUS_VAL`` trains on the ``train+val`` split.

The loop never waits for the card within an epoch. Each step's losses and
top-k statistics stay on the card; once every ``LOG_PERIOD`` steps they are
stacked and queued as one copy into pinned host memory with an event, and
the meter takes them (and the NaN check reads them) at a later flush once
that event has completed, as the JAX loop's metrics thread does (:95-139).
Each step's host times are taken at its ``iter_toc`` and logged with its
numbers; the flush itself falls between one iteration's ``iter_toc`` and
the next one's ``iter_tic``. The LR of each step is a host float from
``utils/lr_policy``.

With the state head each step also copies ``state_loss`` and
``state_pred_max_abs``, and at the flush ``check_state_alerts`` reads every
iteration's (the JAX package's ``:54-71``): all |state logits| at most 0.1
raises "State looking strange", a state loss of 40 or more the loss alert.
Without the observers their sink is ``AlertLog``, which logs a warning, as
the JAX package's ``ScalarLogger.alert`` does without W&B.

Not ported here: the observers (TensorBoard, W&B), the AOT warm-up, the
device store, the profiler window and the K-step dispatch.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
from torch import nn

from ..checkpoint import manager as cu
from ..data.loader import construct_loader, shuffle_dataset
from ..data.prefetch import prefetch
from ..models import build_model
from ..utils import lr_policy
from ..utils.logging import get_logger, setup_logging
from ..utils.misc import log_model_info
from ..utils.torch_setup import disable_tf32, resolve_device
from .eval_loop import build_val_meter, eval_epoch
from .meters import EPICTrainMeter, TrainMeter
from .steps import (
    apply_model,
    has_state_head,
    init_state,
    is_multitask,
    make_eval_step,
    make_train_step,
)

logger = get_logger(__name__)


def check_nan_losses(loss: float):
    if math.isnan(loss):
        raise RuntimeError(f"ERROR: Got NaN losses {loss}")


class AlertLog:
    """The alert sink without observers: each alert a warning."""

    def alert(self, title: str, text: str):
        logger.warning("%s: %s", title, text)


def check_state_alerts(parts_h: dict, stats_h: dict, sink) -> None:
    """The state head's alerts, with the reference's triggers: every
    |state logit| at most 0.1 (``state_pred_max_abs``) -> "State looking
    strange"; ``state_loss`` at least 40 -> "state_loss >= 40". Nothing
    without a state head or a sink."""
    if sink is None:
        return
    max_abs = stats_h.get("state_pred_max_abs")
    if max_abs is not None and max_abs <= 0.1:
        sink.alert("State looking strange",
                   f"State predictions < 0.1 (max |pred| = {max_abs:.4g})")
    state_loss = parts_h.get("state_loss")
    if state_loss is not None and state_loss >= 40.0:
        sink.alert("state_loss >= 40", f"Anomalous state loss: {state_loss:.4g}")


# The step's numbers each meter takes, in the order they are copied off the card.
_SINGLE = ("loss", "top1_err", "top5_err")
_MULTI = ("loss", "verb_loss", "noun_loss", "verb_top1", "noun_top1", "action_top1",
          "verb_top5", "noun_top5", "action_top5")
_STATE = _MULTI + ("state_loss", "state_pred_max_abs")


def _update(train_meter, values: dict, lr: float, rows: int) -> None:
    if isinstance(train_meter, EPICTrainMeter):
        train_meter.update_stats(
            tuple(values[f"{t}_top1"] for t in ("verb", "noun", "action")),
            tuple(values[f"{t}_top5"] for t in ("verb", "noun", "action")), values, lr, rows)
    else:
        train_meter.update_stats(values["top1_err"], values["top5_err"], values["loss"], lr, rows)


def train_epoch(train_loader, state, train_step, train_meter, cur_epoch, cfg, device):
    data_size = len(train_loader)
    log_period = max(1, cfg.LOG_PERIOD)
    cuda = torch.device(device).type == "cuda"
    names = _SINGLE
    if isinstance(train_meter, EPICTrainMeter):
        names = _STATE if has_state_head(cfg) else _MULTI
    alerts = AlertLog()
    pending = []  # (iteration, lr, rows, host times, the step's ``names`` on the card)
    fetches = []  # ([(iteration, lr, rows, host times)], host tensor, event or None)

    def apply_ready(block: bool):
        while fetches and (block or fetches[0][2] is None or fetches[0][2].query()):
            metas, host, event = fetches.pop(0)
            if event is not None:
                event.synchronize()
            for (it, lr, rows, times), row in zip(metas, host.tolist()):
                values = dict(zip(names, row))
                check_nan_losses(values["loss"])
                check_state_alerts(values, values, alerts)
                _update(train_meter, values, lr, rows)
                train_meter.log_iter_stats(cur_epoch, it, times)

    def flush(block: bool = False):
        if pending:
            host = torch.stack([v for *_, v in pending]).to("cpu", non_blocking=True)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            fetches.append(([tuple(m) for *m, _ in pending], host, event))
            pending.clear()
        apply_ready(block)

    src = prefetch(train_loader, device)
    try:
        train_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            train_meter.data_toc()
            lr = lr_policy.get_lr_at_epoch(cfg, cur_epoch + float(cur_iter) / data_size)
            parts, stats = train_step(state, batch, lr)
            values = torch.stack([{**parts, **stats}[k] for k in names])
            train_meter.iter_toc()
            pending.append((cur_iter, lr, batch["waveform"].shape[0], train_meter.iter_times(),
                            values))
            if len(pending) >= log_period:
                flush()
            train_meter.iter_tic()
        flush(block=True)
    finally:
        src.close()
    train_meter.log_epoch_stats(cur_epoch)
    train_meter.reset()


@torch.no_grad()
def precise_bn(cfg, state, loader, pipeline, device, num_iters: int) -> None:
    """Recomputes every BN's running statistics as the mean of their values
    over ``num_iters`` batches of ``loader`` (forward in train mode,
    SpecAugment off): with ``momentum=None`` after ``reset_running_stats()``
    PyTorch keeps the cumulative mean, which is what the JAX package's
    momentum-1 average computes (:284-342). ``BN.FREEZE`` is lifted for the
    pass; the momenta and the freeze are restored after it. A batch of
    window chains counts its padded windows too, as the JAX package's
    bucketed batches do."""
    if num_iters <= 0:
        return
    model, forward = state.model, apply_model(cfg)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(bn.momentum, getattr(bn, "stats_frozen", False)) for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
        bn.stats_frozen = False
    model.train()
    src = prefetch(loader, device)
    try:
        for batch in itertools.islice(src, num_iters):
            forward(model, pipeline(batch["waveform"], batch["n_valid"], train=False), batch)
    finally:
        src.close()
        for bn, (momentum, frozen) in zip(bns, saved):
            bn.momentum, bn.stats_frozen = momentum, frozen


def build_train_meter(cfg, epoch_iters: int):
    """The verb/noun meter (with ``state_loss`` for the state head) for a
    verb/noun head, else the single-task one."""
    if is_multitask(cfg):
        return EPICTrainMeter(epoch_iters, cfg, with_state=has_state_head(cfg))
    return TrainMeter(epoch_iters, cfg)


def _epoch_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(epoch)]).generate_state(1)[0])


def train(cfg, device=None):
    """Trains the model of ``cfg`` on ``TRAIN.DATASET``; returns the final
    ``steps.TrainState``.

    Runs on the current CUDA device unless ``device="cpu"``; raises when
    CUDA is absent and no device was given, and when ``NUM_SHARDS > 1``
    (data parallel across processes is not ported). Weights are drawn from
    ``torch.Generator().manual_seed(cfg.RNG_SEED)``, SpecAugment's generator
    is seeded with ``RNG_SEED``, and the global generators (the head's
    dropout) are seeded from ``(RNG_SEED, epoch)`` at each epoch, so that a
    resumed run repeats the epochs of an uninterrupted one.
    """
    if cfg.NUM_SHARDS > 1 or cfg.NUM_GPUS > 1:
        # The loader would split the data by SHARD_ID and the LR would scale
        # by NUM_SHARDS, but there is no process group and no gradient
        # all-reduce yet: each process would train alone on its share.
        raise NotImplementedError(
            f"NUM_SHARDS = {cfg.NUM_SHARDS}, NUM_GPUS = {cfg.NUM_GPUS}: train(cfg) runs on "
            "one device")
    device = resolve_device(device)
    disable_tf32()
    setup_logging(cfg.OUTPUT_DIR)
    for node in ("TENSORBOARD", "WANDB"):
        if cfg[node].ENABLE:
            logger.warning("%s.ENABLE: the observers are not ported; training goes on "
                           "without them", node)
    np.random.seed(cfg.RNG_SEED)
    logger.info("Train with config:\n%s", cfg.to_json())

    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    state = init_state(cfg, model)
    state.generator.manual_seed(cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        log_model_info(model)
    start_epoch = cu.load_train_checkpoint(cfg, state)

    plus_val = (cfg.TRAIN.DATASET.lower().startswith("epickitchens")
                and cfg.EPICKITCHENS.TRAIN_PLUS_VAL)
    train_loader = construct_loader(cfg, "train+val" if plus_val else "train")
    val_loader = construct_loader(cfg, "val")
    train_step = make_train_step(cfg, device)
    eval_step = make_eval_step(cfg, device)
    train_meter = build_train_meter(cfg, len(train_loader))
    val_meter = build_val_meter(cfg, len(val_loader))

    logger.info("Start epoch: %d", start_epoch + 1)
    try:
        for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
            shuffle_dataset(train_loader, cur_epoch)
            torch.manual_seed(_epoch_seed(cfg.RNG_SEED, cur_epoch))
            train_epoch(train_loader, state, train_step, train_meter, cur_epoch, cfg, device)
            if cfg.BN.USE_PRECISE_STATS:
                precise_bn(cfg, state, train_loader, train_step.pipeline, device,
                           min(cfg.BN.NUM_BATCHES_PRECISE, len(train_loader)))
            if cu.is_checkpoint_epoch(cfg, cur_epoch):
                cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
            if (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0 or (
                cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH
            ):
                is_best, top1 = eval_epoch(val_loader, model, eval_step, val_meter, cur_epoch,
                                           cfg, device)
                if is_best:
                    cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg,
                                       name="checkpoint_best")
                    logger.info("Saved best checkpoint at epoch %d: %s", cur_epoch + 1, top1)
    finally:
        train_loader.close()
        val_loader.close()
    return state
