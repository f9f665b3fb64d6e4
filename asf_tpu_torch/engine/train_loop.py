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

The observers (``engine/observers.py:ScalarLogger``, on rank 0 only, as
the JAX package's ``:483-527``): at the flush every ``LOG_PERIOD``-th
iteration logs ``Train/<part>`` (the loss parts, ``grad_norm``,
``param_norm``) and ``Train/lr`` at global step ``data_size * epoch + it``;
each eval logs ``Val/<key>`` at ``(epoch + 1) * len(train_loader)``, and
the val plots at ``epoch`` (``eval_loop.py``); with a live W&B run and
``GPU.WATCH_HISTOGRAMS`` the step's parameter and gradient histograms of
every ``LOG_PERIOD``-th step go to W&B, read at the flush with the step's
other numbers. The alerts go through the same logger, which always logs
them as warnings. ``GPU.PROFILE_DIR`` traces ``PROFILE_NUM_ITERS`` steps of
the first epoch with ``torch.profiler`` into a Chrome trace there (the JAX
package's ``TPU.PROFILE_DIR``, ``:83-85``).

In a process group (``tools/run_net.py``; ``parallel/dist.py``) every
rank trains the same model on its rows of each host batch: the model is
wrapped in ``DistributedDataParallel`` (``broadcast_buffers=False``: the
batch-norm statistics are made equal on every rank by the norms
themselves), the step averages the loss parts and accuracies over the
ranks on the card, precise BN runs on every rank, and only global rank 0
logs at INFO, observes and writes checkpoints, each checkpoint followed by
a barrier so that every rank finds the file an auto-resume reads.

Not ported here: the AOT warm-up, the device store and the K-step dispatch.
"""

from __future__ import annotations

import itertools
import math
import os

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..checkpoint import manager as cu
from ..data.loader import construct_loader, shuffle_dataset
from ..data.prefetch import prefetch
from ..models import build_model
from ..parallel import dist
from ..utils import lr_policy
from ..utils.logging import get_logger, setup_logging
from ..utils.misc import log_model_info
from ..utils.torch_setup import disable_tf32, resolve_device
from .eval_loop import build_val_meter, eval_epoch
from .meters import EPICTrainMeter, TrainMeter
from .observers import ScalarLogger
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


def _update(train_meter, values: dict, lr: float, rows: int) -> None:
    if isinstance(train_meter, EPICTrainMeter):
        train_meter.update_stats(
            tuple(values[f"{t}_top1"] for t in ("verb", "noun", "action")),
            tuple(values[f"{t}_top5"] for t in ("verb", "noun", "action")), values, lr, rows)
    else:
        train_meter.update_stats(values["top1_err"], values["top5_err"], values["loss"], lr, rows)


def _histograms(watch) -> dict:
    """The watch summary read at the flush as ``log_histograms`` takes it."""
    names, counts, ranges = watch
    return {name: {"counts": c, "lo": lo, "hi": hi}
            for name, c, (lo, hi) in zip(names, counts.numpy(), ranges.tolist())}


class _Profile:
    """``GPU.PROFILE_DIR``: a ``torch.profiler`` window over ``PROFILE_NUM_ITERS``
    steps from ``PROFILE_START_ITER`` (at most the epoch's second-to-last) of
    the first epoch, written as a Chrome trace into that directory."""

    def __init__(self, cfg, cur_epoch: int, data_size: int, device):
        self.dir = cfg.GPU.PROFILE_DIR if cur_epoch == 0 and dist.is_primary() else ""
        self.start = min(int(cfg.GPU.PROFILE_START_ITER), max(0, data_size - 2))
        self.n = max(1, int(cfg.GPU.PROFILE_NUM_ITERS))
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def before(self, cur_iter: int) -> None:
        if self.dir and self.prof is None and cur_iter >= self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.first = self.last = cur_iter

    def after(self, cur_iter: int) -> None:
        if self.prof is not None:
            self.last = cur_iter
            if cur_iter + 1 >= self.first + self.n:
                self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.cuda:  # the window's last step may still run on the card
            torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"train_trace_iters_{self.first}-{self.last}.json")
        self.prof.export_chrome_trace(path)
        logger.info("Saved profiler trace to %s", path)
        self.prof, self.dir = None, ""


def train_epoch(train_loader, state, train_step, train_meter, cur_epoch, cfg, device,
                scalar_logger=None):
    data_size = len(train_loader)
    log_period = max(1, cfg.LOG_PERIOD)
    cuda = torch.device(device).type == "cuda"
    profile = _Profile(cfg, cur_epoch, data_size, device)
    # (iteration, lr, rows, host times, names, the step's numbers on the card, watch)
    pending = []
    fetches = []  # (metas, host numbers, host watches, event or None)

    def apply_ready(block: bool):
        while fetches and (block or fetches[0][3] is None or fetches[0][3].query()):
            metas, host, watches, event = fetches.pop(0)
            if event is not None:
                event.synchronize()
            for (it, lr, rows, times, (part_names, names)), row, watch in zip(
                    metas, host.tolist(), watches):
                values = dict(zip(names, row))
                global_step = data_size * cur_epoch + it
                if watch is not None and scalar_logger is not None:
                    scalar_logger.log_histograms(_histograms(watch), global_step=global_step)
                check_nan_losses(values["loss"])
                check_state_alerts(values, values, scalar_logger)
                _update(train_meter, values, lr, rows)
                train_meter.log_iter_stats(cur_epoch, it, times)
                if scalar_logger is not None and it % log_period == 0:
                    scalars = {f"Train/{k}": values[k] for k in part_names}
                    scalars["Train/lr"] = lr
                    scalar_logger.log(scalars, global_step=global_step)

    def flush(block: bool = False):
        if pending:
            host = torch.stack([p[5] for p in pending]).to("cpu", non_blocking=True)
            watches = [None if p[6] is None else
                       (p[6][0], *(t.to("cpu", non_blocking=True) for t in p[6][1:]))
                       for p in pending]
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            fetches.append(([p[:5] for p in pending], host, watches, event))
            pending.clear()
        apply_ready(block)

    src = prefetch(train_loader, device)
    try:
        train_meter.iter_tic()
        for cur_iter, batch in enumerate(src):
            profile.before(cur_iter)
            train_meter.data_toc()
            lr = lr_policy.get_lr_at_epoch(cfg, cur_epoch + float(cur_iter) / data_size)
            parts, stats = train_step(state, batch, lr)
            watch = parts.pop("watch", None)
            values = torch.stack([*parts.values(), *stats.values()])
            train_meter.iter_toc()
            # the global batch's rows, as the JAX package's meter counts them
            pending.append((cur_iter, lr, batch["waveform"].shape[0] * dist.world_size(),
                            train_meter.iter_times(), (tuple(parts), (*parts, *stats)),
                            values, watch))
            profile.after(cur_iter)
            if len(pending) >= log_period:
                flush()
            train_meter.iter_tic()
        flush(block=True)
    finally:
        src.close()
        profile.stop()
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
    bucketed batches do. Across ranks every rank runs the same batches,
    its rows of each, and its norms take their statistics over the ranks."""
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


def _epoch_seed(seed: int, epoch: int, rank: int = 0) -> int:
    """The global generators' seed of ``epoch`` on global rank ``rank``
    (rank 0's is the seed of a run without ranks)."""
    key = [int(seed), int(epoch)] + ([int(rank)] if rank else [])
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def train(cfg, device=None):
    """Trains the model of ``cfg`` on ``TRAIN.DATASET``; returns the final
    ``steps.TrainState``.

    Runs on the current CUDA device unless ``device="cpu"``; raises when
    CUDA is absent and no device was given. With ``NUM_SHARDS > 1`` or
    ``NUM_GPUS > 1`` it is one rank of a process group that ``run_net``
    started (``tools/run_net.py:launch_job``), and raises without one.
    Weights are drawn from ``torch.Generator().manual_seed(cfg.RNG_SEED)``,
    SpecAugment's generator is seeded with ``RNG_SEED`` (on every rank),
    and the global generators (the head's dropout) are seeded from
    ``(RNG_SEED, epoch, global rank)`` at each epoch, so that a resumed run
    repeats the epochs of an uninterrupted one.
    """
    dist.check_world(cfg, "train")
    device = resolve_device(device)
    disable_tf32()
    setup_logging(cfg.OUTPUT_DIR, is_primary=dist.is_primary())
    dist.check_sync_bn_mesh(cfg)
    dist.check_batch_divisibility(cfg, int(cfg.TRAIN.BATCH_SIZE), "TRAIN")
    np.random.seed(cfg.RNG_SEED)
    logger.info("Train with config:\n%s", cfg.to_json())

    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    state = init_state(cfg, model)
    state.generator.manual_seed(cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        log_model_info(model)
    start_epoch = cu.load_train_checkpoint(cfg, state)
    if dist.is_initialized():
        state.ddp = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)

    plus_val = (cfg.TRAIN.DATASET.lower().startswith("epickitchens")
                and cfg.EPICKITCHENS.TRAIN_PLUS_VAL)
    train_loader = construct_loader(cfg, "train+val" if plus_val else "train")
    val_loader = construct_loader(cfg, "val")
    scalar_logger = ScalarLogger(cfg) if dist.is_primary() else None
    watch = bool(cfg.WANDB.ENABLE and cfg.GPU.WATCH_HISTOGRAMS and scalar_logger is not None
                 and scalar_logger.wandb_run is not None)
    train_step = make_train_step(cfg, device, watch=watch)
    eval_step = make_eval_step(cfg, device)
    train_meter = build_train_meter(cfg, len(train_loader))
    val_meter = build_val_meter(cfg, len(val_loader))

    logger.info("Start epoch: %d", start_epoch + 1)
    try:
        for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
            shuffle_dataset(train_loader, cur_epoch)
            torch.manual_seed(_epoch_seed(cfg.RNG_SEED, cur_epoch, dist.rank()))
            train_epoch(train_loader, state, train_step, train_meter, cur_epoch, cfg, device,
                        scalar_logger)
            if cfg.BN.USE_PRECISE_STATS:
                precise_bn(cfg, state, train_loader, train_step.pipeline, device,
                           min(cfg.BN.NUM_BATCHES_PRECISE, len(train_loader)))
            if cu.is_checkpoint_epoch(cfg, cur_epoch):
                cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
            if (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0 or (
                cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH
            ):
                is_best, top1 = eval_epoch(val_loader, model, eval_step, val_meter, cur_epoch,
                                           cfg, device, scalar_logger)
                if top1 and scalar_logger is not None:
                    scalar_logger.log({f"Val/{k}": float(v) for k, v in top1.items()},
                                      global_step=(cur_epoch + 1) * len(train_loader))
                if is_best:
                    cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg,
                                       name="checkpoint_best")
                    logger.info("Saved best checkpoint at epoch %d: %s", cur_epoch + 1, top1)
    finally:
        train_loader.close()
        val_loader.close()
        if scalar_logger is not None:
            scalar_logger.close()
    return state
