"""What the per-layer metrics that read the program's own spans compute.

The program records spans (``asf_tpu_torch/utils/spans.py``) on the host's
``perf_counter`` clock, the clock of the harness's ``Spans.calls``, and
while the profiler runs it also puts them on the profiler's timeline, where
``trace.summarize`` counts the device time of the kernels launched under
each (``ops``). A program without the recorder (a checkout before it) gives
nothing to read, and every reader here returns None.

* ``median_ms`` / ``mean_ms``: host ms a step in spans of a name (a name
  ending in "." stands for every name it begins), the median or the mean
  over the window's untraced steps, a step without such a span counting 0.
  A step holds the records of the loop's thread (the one that recorded
  ``loop.step``) that started after the previous call returned and no later
  than its own call returned: the flush or meter that followed the previous
  step, its data wait, and the step's call with the spans inside it. The
  traced steps are left out, so the profiler's overhead never enters. None
  with fewer than ``MIN_STEPS`` steps.
* ``device_ms``: device ms a traced step in the kernels launched under a
  span on its own thread (the backward's kernels are launched from
  autograd's thread, under none of the program's spans); None where the
  trace holds none.
"""

from __future__ import annotations

import bisect
import statistics

MIN_STEPS = 20


def _records():
    try:
        from asf_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records()


def _steps(run):
    """[[(name, ns), ...] a step] over the window's untraced steps, or None."""
    if not hasattr(run, "_program_steps"):
        run._program_steps = _gather(run)
    return run._program_steps


def _gather(run):
    recs = _records()
    if not recs or run.spans is None:
        return None
    loop = [r[1] for r in recs if r[0] == "loop.step"]
    if not loop:
        return None
    tid = loop[-1]
    calls = run.spans.calls
    ends = [c[1] * 1e9 for c in calls]
    keep = {i: [] for i in run.window_calls if i not in run.traced and i > 0}
    if len(keep) < MIN_STEPS:
        return None
    for name, thread, start, end, _parent in recs:
        if thread != tid:
            continue
        i = bisect.bisect_left(ends, start)  # the first call returning at or after it
        if i in keep:
            keep[i].append((name, end - start))
    return list(keep.values())


def _totals_ms(run, name: str):
    steps = _steps(run)
    if steps is None:
        return None

    def match(n):
        return n == name or (name.endswith(".") and n.startswith(name))

    return [sum(ns for n, ns in step if match(n)) / 1e6 for step in steps]


def median_ms(run, name: str):
    ms = _totals_ms(run, name)
    return statistics.median(ms) if ms else None


def mean_ms(run, name: str):
    ms = _totals_ms(run, name)
    return statistics.fmean(ms) if ms else None


def device_ms(run, name: str):
    t = run.trace
    if t is None or not t["steps"]:
        return None
    s = t["ops"].get(name, 0.0)
    return 1e3 * s / t["steps"] if s > 0 else None
