"""Meters: windowed scalars and the train and val epoch stats.

Counterpart of ``asf_tpu/engine/meters.py:29-245`` (``Timer``,
``ScalarMeter``, ``TrainMeter``, ``ValMeter``, ``mem_stats``), with the same
``json_stats`` records (``_type``, ``epoch``, ``iter``, ``dt``, ``dt_data``,
``dt_net``, ``eta``, ``top1_err``, ``top5_err``, ``loss``, ``lr``) and the same
best-epoch rule; ``val_iter`` records also carry ``dt`` and ``dt_data``.
Memory: the card's peak allocation (``gpu_mem``, the upstream name) and the
host's resident set. The verb/noun, state and test meters come with their
slices.

The loops log an iteration's stats at a later flush, once its numbers are
off the card, so they take the iteration's times (``iter_times()``) at its
``iter_toc`` and hand them to ``log_iter_stats``; without them a record
reads the timers as they stand when it is logged.
"""

from __future__ import annotations

import datetime
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.logging import log_json_stats
from ..utils.misc import gpu_mem_gb, host_mem_gb


def mem_stats() -> Dict[str, str]:
    used, total = host_mem_gb()
    out = {"RAM": f"{used:.2f}/{total:.2f} GB"}
    gpu = gpu_mem_gb()
    if gpu is not None:
        out["gpu_mem"] = f"{gpu:.2f} GB"
    return out


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused: Optional[float] = None
        self._total = 0.0

    def pause(self):
        if self._paused is None:
            self._total += time.perf_counter() - self._start
            self._paused = time.perf_counter()

    def seconds(self) -> float:
        if self._paused is None:
            return self._total + (time.perf_counter() - self._start)
        return self._total


class ScalarMeter:
    """The median of a scalar over its last ``window_size`` values."""

    def __init__(self, window_size: int):
        self.deque = deque(maxlen=window_size)

    def reset(self):
        self.deque.clear()

    def add_value(self, value: float):
        self.deque.append(value)

    def get_win_median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0


def _eta(seconds_per_iter: float, iters_left: int) -> str:
    return str(datetime.timedelta(seconds=int(seconds_per_iter * max(iters_left, 0))))


class _BaseEpochMeter:
    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_epoch = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def iter_times(self) -> Tuple[float, float, float]:
        """(iteration, data wait, net) seconds of the current iteration."""
        return (self.iter_timer.seconds(), self.data_timer.seconds(),
                self.net_timer.seconds())


class TrainMeter(_BaseEpochMeter):
    def __init__(self, epoch_iters: int, cfg):
        super().__init__(epoch_iters, cfg)
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_total = 0.0
        self.lr = 0.0
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = self.num_top5_mis = self.num_samples = 0

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch, cur_iter, times=None):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        dt, dt_data, dt_net = times or self.iter_times()
        log_json_stats({
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": dt,
            "dt_data": dt_data,
            "dt_net": dt_net,
            "eta": _eta(
                dt,
                self.max_epoch - (cur_epoch * self.epoch_iters + cur_iter + 1),
            ),
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
            **mem_stats(),
        })

    def log_epoch_stats(self, cur_epoch):
        log_json_stats({
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "dt": self.iter_timer.seconds(),
            "top1_err": self.num_top1_mis / max(self.num_samples, 1),
            "top5_err": self.num_top5_mis / max(self.num_samples, 1),
            "loss": self.loss_total / max(self.num_samples, 1),
            "lr": self.lr,
        })


class ValMeter(_BaseEpochMeter):
    """Single-task val meter; an epoch is best when its top-1 error is
    below every earlier epoch's."""

    def __init__(self, max_iter: int, cfg):
        super().__init__(max_iter, cfg)
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.min_top1_err = 100.0

    def reset(self):
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = self.num_top5_mis = self.num_samples = 0

    def update_stats(self, top1_err, top5_err, mb_size):
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch, cur_iter, times=None):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        dt, dt_data, _ = times or self.iter_times()
        log_json_stats({
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": dt,
            "dt_data": dt_data,
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
        })

    def log_epoch_stats(self, cur_epoch):
        top1 = self.num_top1_mis / max(self.num_samples, 1)
        top5 = self.num_top5_mis / max(self.num_samples, 1)
        is_best = top1 < self.min_top1_err
        self.min_top1_err = min(self.min_top1_err, top1)
        log_json_stats({
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "top1_err": top1,
            "top5_err": top5,
            "min_top1_err": self.min_top1_err,
        })
        return is_best, {"top1_acc": 100.0 - top1}
