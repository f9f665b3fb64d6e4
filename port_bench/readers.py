"""What the per-layer metrics' readers (``metrics/<name>.py``) compute from a
``cells.Run``. Each returns None where the run has nothing to read (no trace,
no peak for the card, no such kernel), and the harness then leaves the
metric out; a share of a peak or a roofline is never made up as 0.

* ``idle``: 100 * (1 - busy / window) over the traced stretch.
* ``mfu``: 100 * the least time of the window's untraced steps before the
  traced stretch at the card's dense peaks (``flops.py``: the model's
  convolutions, linear layers and GRU, 3 passes a training step, and the
  log-mel's least time) over those steps' time on the card (CUDA events).
* ``logmel_roofline``: 100 * the log-mel kernel's mean least time over the
  traced steps (its rows) over its launches' mean time in the trace (K1's
  slice reduction, where a launch has one, counted in); the trace loses a
  launch at times, so the means, not the sums.
* ``device_ms``: device ms a traced step in kernels whose names hold one of
  the given patterns, or launched under the given operators.
* ``pad_share``: 100 * padded windows over windows computed in the window.
* ``host_ms``: the median host ms inside a step's call, or from a call's
  return to the next call, over the window's untraced steps.
"""

from __future__ import annotations

import statistics

import numpy as np

from . import flops

BN_PATTERNS = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_")
GRU_OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward")


def idle(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _untraced(run):
    first = min(run.traced) if run.traced else None
    return [j for j, i in enumerate(run.window_calls) if first is None or i < first]


def mfu(run):
    if run.peaks is None or not run.gaps_s:
        return None
    js = _untraced(run)
    wall = sum(run.gaps_s[j] for j in js)
    if wall <= 0:
        return None
    return 100.0 * sum(run.ideal_s(run.window_calls[j]) for j in js) / wall


def logmel_roofline(run):
    t = run.trace
    if t is None or run.peaks is None or not t["logmel"]:
        return None
    traced = [i for i in sorted(run.traced) if i < len(run.spans.calls)]
    bound = np.mean([flops.logmel_bound_s(run.m, run.spans.calls[i][2], run.peaks)
                     for i in traced])
    per_launch = (sum(t["logmel"]) + t["logmel_reduce_s"]) / len(t["logmel"])
    return 100.0 * float(bound) / per_launch


def device_ms(run, patterns=(), ops=()):
    t = run.trace
    if t is None or not t["steps"]:
        return None
    s = sum(v for k, v in t["kernels"].items() if any(p in k.lower() for p in patterns))
    s += sum(t["ops"].get(op, 0.0) for op in ops)
    if s <= 0:
        return None
    return 1e3 * s / t["steps"]


def pad_share(run):
    calls = [run.spans.calls[i] for i in run.window_calls]
    rows = sum(c[2] for c in calls)
    if not rows:
        return None
    return 100.0 * sum(c[2] - c[5] for c in calls) / rows


def host_ms(run, between: bool = False):
    calls = run.spans.calls
    idx = [i for i in run.window_calls if i not in run.traced]
    if between:
        ms = [(calls[b][0] - calls[a][1]) * 1e3 for a, b in zip(idx, idx[1:]) if b == a + 1]
    else:
        ms = [(calls[i][1] - calls[i][0]) * 1e3 for i in idx]
    return statistics.median(ms) if ms else None
