"""Spans: named intervals of the host's work, on ``time.perf_counter_ns``.

``with span("step.forward"): ...`` stamps the clock at enter and at exit and
appends the span to the process's ring, the last ``CAPACITY`` spans.
``records()`` gives them as ``(name, thread id, start_ns, end_ns, parent)``,
``parent`` being the name of the innermost span that encloses it on the same
thread (None at the top), and ``clear()`` empties the ring. The recorder is
always on. A span costs about a microsecond of host time: the parent is
found from the intervals when ``records()`` is read, not kept as a stack on
the way in.

While a ``torch.profiler`` runs, a span also opens a record function of its
name at FUNCTION scope (``torch._C._profiler._RecordFunctionFast``): a host
event on the profiler's timeline, the clock the kernels are on, whose
operators are its children and whose kernels its device time counts. It is
never a user annotation (``torch.profiler.record_function``), which the
profiler also copies onto the device's timeline as one interval from its
first kernel to its last. Where a torch lacks ``_RecordFunctionFast`` the
profiler gets nothing.

A span that does not fit a ``with`` block (the meters' ``loop.data_wait``
and ``loop.step``) is ``begin()``-ed and ``end()``-ed.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
    _profiling = torch._C._autograd._profiler_enabled
except ImportError:  # an older torch: the spans stay off the profiler's timeline
    def _profiling() -> bool:
        return False

# 65,536 spans hold a 51 s test window of ~2,200 batches at ~10 spans each.
CAPACITY = 1 << 16

_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_append = _ring.append
_now = time.perf_counter_ns
_thread = threading.get_ident


class span:
    """``with span(name):`` records the block as a span of ``name``."""

    __slots__ = ("name", "start_ns", "end_ns", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = None

    def __enter__(self) -> "span":
        if _profiling():
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.start_ns = _now()
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None) -> None:
        self.end_ns = end = _now()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _append((self.name, _thread(), self.start_ns, end))

    begin = __enter__
    end = __exit__

    def seconds(self) -> float:
        """Seconds from the span's start to its end, or to now while it is open."""
        return ((_now() if self.end_ns is None else self.end_ns) - self.start_ns) / 1e9


def records() -> list:
    """The ring's spans, in the order they ended: (name, thread id, start_ns,
    end_ns, parent). Copying a deque of tuples runs without giving up the
    interpreter lock, so a thread that records meanwhile cannot tear it."""
    ring = list(_ring)
    parents = {}
    by_thread = collections.defaultdict(list)
    for i, r in enumerate(ring):
        by_thread[r[1]].append(i)
    for idx in by_thread.values():
        stack = []  # the enclosing spans of the one in hand, outermost first
        for i in sorted(idx, key=lambda i: (ring[i][2], -ring[i][3])):
            start, end = ring[i][2], ring[i][3]
            while stack and not (ring[stack[-1]][2] <= start and end <= ring[stack[-1]][3]):
                stack.pop()
            parents[i] = ring[stack[-1]][0] if stack else None
            stack.append(i)
    return [(*r, parents[i]) for i, r in enumerate(ring)]


def clear() -> None:
    """Empties the ring."""
    _ring.clear()
