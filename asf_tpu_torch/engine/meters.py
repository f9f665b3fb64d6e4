"""Meters: windowed scalars and the train and val epoch stats.

Counterpart of ``asf_tpu/engine/meters.py:29-245`` (``ScalarMeter``,
``TrainMeter``, ``ValMeter``, ``mem_stats``), of its single-task
``TestMeter`` (:393-460) and of the verb/noun meters (``EPICTrainMeter``,
``EPICValMeter``, ``EPICTestMeter``, :245-537, with their state-head
parts), with the same ``json_stats`` records
(``_type``, ``epoch``, ``iter``, ``dt``, ``dt_data``, ``dt_net``, ``eta``,
``top1_err``, ``top5_err``, ``loss``, ``lr``; ``test_iter`` with
``cur_iter`` and ``time_diff``, ``test_final`` with ``top1_acc`` and
``top5_acc``) and the same best-epoch rule; ``val_iter`` records also carry
``dt`` and ``dt_data``, ``test_iter`` records ``dt_data``, and a test
iteration is logged every ``LOG_PERIOD`` (the JAX package: every 20).
Memory: the card's peak allocation (``gpu_mem``, the upstream name) and the
host's resident set. The verb/noun meters keep ``verb``, ``noun`` and
``action`` (both right) top-1 and top-5 accuracies; an EPIC val epoch is
best when its action top-1 is above every earlier epoch's. With the state
head the train meter (``with_state``) also keeps ``state_loss``, and the
val meter each batch's ``state_metrics`` that the loop hands it, whose
means over the batches its ``val_epoch`` record carries.
``EPICTestMeterSlide`` (:540-617) scores sliding windows over untrimmed
videos, each window's scores summed into its slot.

The loops log an iteration's stats at a later flush, once its numbers are
off the card, so they take the iteration's times (``iter_times()``) at its
``iter_toc`` and hand them to ``log_iter_stats``; without them a record
reads the times as they stand when it is logged. The times are the spans
``loop.data_wait`` (``dt_data``) and ``loop.step`` (``dt_net``) that
``iter_tic``, ``data_toc`` and ``iter_toc`` begin and end, so that one
clock serves the meters and the spans (the span stands for the JAX
package's ``Timer``); ``dt`` is their sum.
"""

from __future__ import annotations

import datetime
from collections import deque
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.logging import log_json_stats
from . import metrics
from ..utils.misc import gpu_mem_gb, host_mem_gb
from ..utils.spans import span


def mem_stats() -> Dict[str, str]:
    used, total = host_mem_gb()
    out = {"RAM": f"{used:.2f}/{total:.2f} GB"}
    gpu = gpu_mem_gb()
    if gpu is not None:
        out["gpu_mem"] = f"{gpu:.2f} GB"
    return out


class _IterationSpans:
    """An iteration's host times, as the program's spans (``utils/spans.py``):
    ``iter_tic`` begins ``loop.data_wait``, ``data_toc`` ends it and begins
    ``loop.step``, ``iter_toc`` ends whichever is open. A time whose span is
    still open reads to now."""

    _wait = _step = None

    def iter_tic(self):
        self.iter_toc()
        self._wait, self._step = span("loop.data_wait").begin(), None

    def data_toc(self):
        _end(self._wait)
        self._step = span("loop.step").begin()

    def iter_toc(self):
        _end(self._step)
        _end(self._wait)

    def _times(self) -> Tuple[float, float, float]:
        wait = self._wait.seconds() if self._wait is not None else 0.0
        step = self._step.seconds() if self._step is not None else 0.0
        return wait + step, wait, step


def _end(s) -> None:
    if s is not None and s.end_ns is None:
        s.end()


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


class _BaseEpochMeter(_IterationSpans):
    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_epoch = cfg.SOLVER.MAX_EPOCH * epoch_iters

    def iter_times(self) -> Tuple[float, float, float]:
        """(iteration, data wait, net) seconds of the current iteration."""
        return self._times()


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
            "dt": self.iter_times()[0],
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


class _TestIterations(_IterationSpans):
    """A test meter's iteration times and its ``test_iter`` record every
    ``log_period`` iterations."""

    def __init__(self, log_period: int):
        self.log_period = max(1, int(log_period))
        self.stats = {}

    def iter_times(self) -> Tuple[float, float]:
        """(iteration, data wait) seconds of the current iteration."""
        return self._times()[:2]

    def log_iter_stats(self, cur_iter: int, times=None):
        if (cur_iter + 1) % self.log_period != 0:
            return
        dt, dt_data = times or self.iter_times()
        log_json_stats({"_type": "test_iter", "cur_iter": f"{cur_iter + 1}",
                        "time_diff": dt, "dt_data": dt_data})


class TestMeter(_TestIterations):
    """Multi-view ensembling of a single-task test set: the scores of clip
    ``clip_id // num_clips``'s views are summed or maxed
    (``DATA.ENSEMBLE_METHOD``), in the order they arrive, into float64 rows;
    every view of a clip must carry the clip's label."""

    def __init__(self, num_audios: int, num_clips: int, num_cls: int, overall_iters: int,
                 ensemble_method: str = "sum", log_period: int = 20):
        if ensemble_method not in ("sum", "max"):
            raise NotImplementedError(ensemble_method)
        super().__init__(log_period)
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.ensemble_method = ensemble_method
        self.audio_preds = np.zeros((num_audios, num_cls), np.float64)
        self.audio_labels = np.zeros((num_audios,), np.int64)
        self.clip_count = np.zeros((num_audios,), np.int64)

    def update_stats(self, preds, labels, clip_ids):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        vid = np.asarray(clip_ids) // self.num_clips
        seen = self.clip_count[vid] > 0
        self.audio_labels[vid[~seen]] = labels[~seen]
        if not (self.audio_labels[vid] == labels).all():
            raise AssertionError("the views of a clip carry different labels")
        if self.ensemble_method == "sum":
            np.add.at(self.audio_preds, vid, preds)
        else:
            np.maximum.at(self.audio_preds, vid, preds)
        np.add.at(self.clip_count, vid, 1)

    def _warn_incomplete(self):
        if not np.all(self.clip_count == self.num_clips):
            log_json_stats({"_type": "test_warn", "msg": "clip count incomplete",
                            "incomplete": int((self.clip_count != self.num_clips).sum())})

    def finalize_metrics(self, ks=(1, 5)):
        """Logs the ``test_final`` top-k accuracies (and a ``test_warn`` record
        when a clip lacks views); returns (ensembled scores, labels)."""
        self._warn_incomplete()
        accs = metrics.topk_accuracies(torch.from_numpy(self.audio_preds),
                                       torch.from_numpy(self.audio_labels), ks)
        self.stats = {"_type": "test_final"}
        for k, acc in zip(ks, accs):
            self.stats[f"top{k}_acc"] = f"{float(acc):.2f}"
        log_json_stats(self.stats)
        return self.audio_preds.copy(), self.audio_labels.copy()


_TASKS = ("verb", "noun", "action")
_ACCS = tuple(f"{t}_top{k}" for t in _TASKS for k in (1, 5))


class _EPICAccuracies:
    """Windowed and summed verb, noun and action top-1/top-5 accuracies."""

    def _init_accs(self, window: int):
        self.accs = {k: ScalarMeter(window) for k in _ACCS}
        self.correct = {k: 0.0 for k in _ACCS}
        self.num_samples = 0

    def _reset_accs(self):
        for m in self.accs.values():
            m.reset()
        for k in self.correct:
            self.correct[k] = 0.0
        self.num_samples = 0

    def _add_accs(self, top1_acc, top5_acc, mb_size):
        """top1_acc, top5_acc: (verb, noun, action) accuracies in percent."""
        for i, name in enumerate(_TASKS):
            self.accs[f"{name}_top1"].add_value(top1_acc[i])
            self.accs[f"{name}_top5"].add_value(top5_acc[i])
            self.correct[f"{name}_top1"] += top1_acc[i] * mb_size
            self.correct[f"{name}_top5"] += top5_acc[i] * mb_size
        self.num_samples += mb_size


class EPICTrainMeter(_BaseEpochMeter, _EPICAccuracies):
    """Verb/noun/action train meter: the windowed accuracies and the
    ``loss``, ``verb_loss`` and ``noun_loss`` (with the state head also
    ``state_loss``) of each iteration, their means over the epoch."""

    def __init__(self, epoch_iters: int, cfg, with_state: bool = False):
        super().__init__(epoch_iters, cfg)
        self._init_accs(cfg.LOG_PERIOD)
        self.lr = 0.0
        self.loss_names = ("loss", "verb_loss", "noun_loss") + ("state_loss",) * with_state
        self.losses = {n: ScalarMeter(cfg.LOG_PERIOD) for n in self.loss_names}
        self.loss_totals = {n: 0.0 for n in self.loss_names}

    def reset(self):
        self._reset_accs()
        for m in self.losses.values():
            m.reset()
        for k in self.loss_totals:
            self.loss_totals[k] = 0.0

    def update_stats(self, top1_acc, top5_acc, losses: Dict[str, float], lr, mb_size):
        """``losses`` may hold more (``grad_norm``); the meter takes its own."""
        self.lr = lr
        for k in self.loss_names:
            self.losses[k].add_value(losses[k])
            self.loss_totals[k] += losses[k] * mb_size
        self._add_accs(top1_acc, top5_acc, mb_size)

    def log_iter_stats(self, cur_epoch, cur_iter, times=None):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        dt, dt_data, dt_net = times or self.iter_times()
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": dt,
            "dt_data": dt_data,
            "dt_net": dt_net,
            "eta": _eta(dt, self.max_epoch - (cur_epoch * self.epoch_iters + cur_iter + 1)),
            "lr": self.lr,
        }
        for k, m in self.accs.items():
            stats[f"{k}_acc"] = m.get_win_median()
        for k, m in self.losses.items():
            stats[k] = m.get_win_median()
        log_json_stats({**stats, **mem_stats()})

    def log_epoch_stats(self, cur_epoch):
        n = max(self.num_samples, 1)
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "lr": self.lr,
        }
        for k, v in self.correct.items():
            stats[f"{k}_acc"] = v / n
        for k, v in self.loss_totals.items():
            stats[k] = v / n
        log_json_stats(stats)


class EPICValMeter(_BaseEpochMeter, _EPICAccuracies):
    """Verb/noun/action val meter; an epoch is best when its action top-1
    accuracy is above every earlier epoch's. With the state head it keeps
    each batch's ``metrics.state_metrics`` (``update_state_metrics``)."""

    def __init__(self, max_iter: int, cfg):
        super().__init__(max_iter, cfg)
        self._init_accs(cfg.LOG_PERIOD)
        self.max_top1_acc = {name: 0.0 for name in _TASKS}
        self.state_stats: Dict[str, list] = {}

    def reset(self):
        self._reset_accs()
        self.state_stats = {}

    def update_stats(self, top1_acc, top5_acc, mb_size):
        self._add_accs(top1_acc, top5_acc, mb_size)

    def update_state_metrics(self, metrics_dict: Dict[str, float]):
        for k, v in metrics_dict.items():
            self.state_stats.setdefault(k, []).append(v)

    def log_iter_stats(self, cur_epoch, cur_iter, times=None):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        dt, dt_data, _ = times or self.iter_times()
        stats = {
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": dt,
            "dt_data": dt_data,
        }
        for k, m in self.accs.items():
            stats[f"{k}_acc"] = m.get_win_median()
        log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch):
        n = max(self.num_samples, 1)
        top1 = {name: self.correct[f"{name}_top1"] / n for name in _TASKS}
        top5 = {name: self.correct[f"{name}_top5"] / n for name in _TASKS}
        is_best = top1["action"] > self.max_top1_acc["action"]
        for name in _TASKS:
            self.max_top1_acc[name] = max(self.max_top1_acc[name], top1[name])
        stats = {"_type": "val_epoch", "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}"}
        for name in _TASKS:
            stats[f"{name}_top1_acc"] = top1[name]
            stats[f"{name}_top5_acc"] = top5[name]
            stats[f"max_{name}_top1_acc"] = self.max_top1_acc[name]
        for k, v in self.state_stats.items():
            stats[k] = float(np.mean(v))
        log_json_stats(stats)
        return is_best, {f"{k}_top1_acc": v for k, v in top1.items()}


class EPICTestMeter(TestMeter):
    """Multi-view ensembling of a verb/noun test set: each clip's verb and
    noun scores summed or maxed into float64 rows, its labels and its
    narration id kept."""

    def __init__(self, num_audios: int, num_clips: int, num_cls, overall_iters: int,
                 ensemble_method: str = "sum", log_period: int = 20):
        super().__init__(num_audios, num_clips, num_cls[0], overall_iters, ensemble_method,
                         log_period)
        self.verb_preds = self.audio_preds
        self.noun_preds = np.zeros((num_audios, num_cls[1]), np.float64)
        self.verb_labels = self.audio_labels
        self.noun_labels = np.zeros((num_audios,), np.int64)
        self.metadata = np.empty(num_audios, dtype=object)

    def update_stats(self, preds, labels, metadata, clip_ids):
        """preds, labels: (verb, noun) pairs; metadata: the batch's, with
        ``narration_id`` (or None)."""
        vid = np.asarray(clip_ids) // self.num_clips
        verb_l, noun_l = np.asarray(labels[0]), np.asarray(labels[1])
        seen = self.clip_count[vid] > 0
        self.noun_labels[vid[~seen]] = noun_l[~seen]
        if not (self.noun_labels[vid] == noun_l).all():
            raise AssertionError("the views of a clip carry different noun labels")
        if metadata is not None and "narration_id" in metadata:
            self.metadata[vid] = np.asarray(metadata["narration_id"], dtype=object)
        combine = np.add.at if self.ensemble_method == "sum" else np.maximum.at
        combine(self.noun_preds, vid, np.asarray(preds[1]))
        super().update_stats(preds[0], verb_l, clip_ids)  # verb scores, labels and the count

    def finalize_metrics(self, ks=(1, 5)):
        """Logs the ``test_final`` verb, noun and action top-k accuracies (and
        a ``test_warn`` record when a clip lacks views); returns ((verb,
        noun) scores, (verb, noun) labels, narration ids)."""
        self._warn_incomplete()
        verb = metrics.topk_accuracies(torch.from_numpy(self.verb_preds),
                                       torch.from_numpy(self.verb_labels), ks)
        noun = metrics.topk_accuracies(torch.from_numpy(self.noun_preds),
                                       torch.from_numpy(self.noun_labels), ks)
        action = metrics.multitask_topk_accuracies(
            (torch.from_numpy(self.verb_preds), torch.from_numpy(self.noun_preds)),
            (torch.from_numpy(self.verb_labels), torch.from_numpy(self.noun_labels)), ks)
        self.stats = {"_type": "test_final"}
        for k, v, n, a in zip(ks, verb, noun, action):
            self.stats[f"verb_top{k}_acc"] = f"{float(v):.2f}"
            self.stats[f"noun_top{k}_acc"] = f"{float(n):.2f}"
            self.stats[f"action_top{k}_acc"] = f"{float(a):.2f}"
        log_json_stats(self.stats)
        return ((self.verb_preds.copy(), self.noun_preds.copy()),
                (self.verb_labels.copy(), self.noun_labels.copy()), self.metadata.copy())


class EPICTestMeterSlide(_TestIterations):
    """Sliding-window test meter: each window's verb and noun scores summed
    into its slot (float64), its labels ((L,) a window: 4 in whole-video
    mode, else 1) and ``narration_id`` kept. The ``test_final`` record
    scores the windows seen and annotated (first label not -1) with the
    slide metrics, each window alike (the loader scores a window once), and
    carries ``num_windows_eval``."""

    def __init__(self, num_windows: int, num_cls, per_action_instance: bool,
                 log_period: int = 20):
        super().__init__(log_period)
        self.per_action_instance = per_action_instance
        self.verb_preds = np.zeros((num_windows, num_cls[0]), np.float64)
        self.noun_preds = np.zeros((num_windows, num_cls[1]), np.float64)
        label_w = 1 if per_action_instance else 4
        self.verb_labels = np.full((num_windows, label_w), -1, np.int64)
        self.noun_labels = np.full((num_windows, label_w), -1, np.int64)
        self.metadata = np.empty(num_windows, dtype=object)
        self.seen = np.zeros((num_windows,), bool)

    def update_stats(self, preds, labels, metadata, clip_ids):
        """preds: (verb, noun) (B, C) scores; labels: (verb, noun), each (B,)
        or (B, L); metadata: the batch's, with ``narration_id`` (or None)."""
        cid = np.asarray(clip_ids)
        verb_l, noun_l = np.asarray(labels[0]), np.asarray(labels[1])
        if verb_l.ndim == 1:
            verb_l, noun_l = verb_l[:, None], noun_l[:, None]
        np.add.at(self.verb_preds, cid, np.asarray(preds[0]))
        np.add.at(self.noun_preds, cid, np.asarray(preds[1]))
        self.verb_labels[cid, : verb_l.shape[1]] = verb_l
        self.noun_labels[cid, : noun_l.shape[1]] = noun_l
        if metadata is not None and "narration_id" in metadata:
            self.metadata[cid] = np.asarray(metadata["narration_id"], dtype=object)
        self.seen[cid] = True

    def finalize_metrics(self, ks=(1, 5)):
        """Logs the ``test_final`` record; returns ((verb, noun) scores,
        (verb, noun) labels, narration ids) of the windows scored."""
        keep = self.seen & (self.verb_labels[:, 0] != -1)
        vp, np_ = self.verb_preds[keep], self.noun_preds[keep]
        vl, nl = self.verb_labels[keep], self.noun_labels[keep]
        if self.per_action_instance:
            vl, nl = vl[:, 0], nl[:, 0]
        verb = metrics.topk_accuracies_slide(vp, vl, ks, self.per_action_instance)
        noun = metrics.topk_accuracies_slide(np_, nl, ks, self.per_action_instance)
        action = metrics.multitask_topk_accuracies_slide(
            (vp, np_), (vl, nl), ks, self.per_action_instance)
        self.stats = {"_type": "test_final", "num_windows_eval": int(keep.sum())}
        for k, v, n, a in zip(ks, verb, noun, action):
            self.stats[f"verb_top{k}_acc"] = f"{float(v):.2f}"
            self.stats[f"noun_top{k}_acc"] = f"{float(n):.2f}"
            self.stats[f"action_top{k}_acc"] = f"{float(a):.2f}"
        log_json_stats(self.stats)
        return (vp, np_), (vl, nl), self.metadata[keep].copy()
