"""The share of a window's steps that the program ran as a CUDA graph.

``share(run)``: 100 * the untraced window steps (``program_spans``' steps:
what the loop's thread recorded in and before each call) whose call holds a
``step.replay`` span, over those steps; 0 where no step replayed, as in a
program that runs no graph. None where ``program_spans`` finds no steps to
read: a program without the recorder, or too few steps.
"""

from __future__ import annotations

from port_bench import program_spans

REPLAY = "step.replay"


def share(run):
    steps = program_spans._steps(run)
    if not steps:
        return None
    return 100.0 * sum(any(n == REPLAY for n, _ in step) for step in steps) / len(steps)
