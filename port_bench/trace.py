"""Reading a ``torch.profiler`` trace of a stretch of the window.

``summarize(prof, main_tid, steps)`` reduces the profiler's events to what the
per-layer readers need:

* ``busy_s``: the union of the device's kernel, copy and set intervals;
  ``window_s``: the span from the trace's first event to its last
  (``chip_smoke.py``'s ``trace_idle`` and ``tools/profile_forward.py``'s
  ``busy_us``, copied);
* ``kernels``: device seconds by kernel name; ``logmel``: the durations of
  the log-mel kernel's launches (K1's ``logmel_f32_kernel``, the float32
  front end, or K2's ``logmel_tc_kernel``, the bf16 one), and
  ``logmel_reduce_s``: the device seconds of K1's slice reduction, which
  a launch split over frequency slices adds;
* ``ops``: device seconds of the kernels each CPU operator launched
  (``key_averages()``), by operator name;
* ``idle_gaps``: the device's idle time inside the span, each gap named by
  the innermost operator the main thread was running at its middle.
"""

from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType

LOGMEL = ("logmel_f32_kernel", "logmel_tc_kernel")
LOGMEL_REDUCE = "logmel_f32_reduce_kernel"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals):
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _device_us(avg) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(avg, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def summarize(prof, main_tid: int, steps: int) -> dict:
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    if not device or not spans:
        return {"steps": steps, "busy_s": 0.0, "window_s": 0.0, "kernels": {}, "logmel": [],
                "logmel_reduce_s": 0.0,
                "ops": {}, "idle_gaps": {}, "device_events": 0}
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    lo = min(s for s, _ in spans)
    hi = max(e for _, e in spans)
    kernels = collections.Counter()
    for e in device:
        kernels[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    logmel = [(e.time_range.end - e.time_range.start) / 1e6 for e in device
              if any(k in e.name for k in LOGMEL)]
    logmel_reduce = sum((e.time_range.end - e.time_range.start) / 1e6 for e in device
                        if LOGMEL_REDUCE in e.name)
    ops = {a.key: _device_us(a) / 1e6 for a in prof.key_averages()}
    main = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                   if e.thread == main_tid), key=lambda x: x[0]) or \
        sorted(((e.time_range.start, e.time_range.end, e.name) for e in host), key=lambda x: x[0])
    starts = [h[0] for h in main]
    gaps = collections.Counter()
    for s, e in _gaps(intervals):
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: Python, no operator"
        for j in range(i, max(-1, i - 4000), -1):  # the latest-starting op that holds mid
            if main[j][1] >= mid:
                name = main[j][2]
                break
        gaps[name] += (e - s) / 1e6
    return {"steps": steps, "busy_s": busy_us(intervals) / 1e6, "window_s": (hi - lo) / 1e6,
            "kernels": dict(kernels), "logmel": logmel,
            "logmel_reduce_s": logmel_reduce, "ops": ops, "idle_gaps": dict(gaps),
            "device_events": len(device)}


def short_name(name: str) -> str:
    """A kernel's name without its template and call arguments."""
    name = name[5:] if name.startswith("void ") else name
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:min(cut, 96)]


def breakdown(summary: dict) -> dict:
    kernels = collections.Counter()
    for n, s in summary["kernels"].items():
        kernels[short_name(n)] += s
    top = kernels.most_common(10)
    gaps = collections.Counter(summary["idle_gaps"]).most_common(10)
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}
