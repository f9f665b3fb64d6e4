"""``graph_share.*`` on fabricated runs: the share of untraced window steps
whose call holds a ``step.replay`` span, 0 where the program ran no graph,
and None on a program without the recorder or with too few steps."""

from __future__ import annotations

import types

import pytest

from port_bench import graph_share, program_spans, spec
from port_bench.tests.test_port_bench_program_spans import MAIN, MS, _run


def _replayed(recs, every: int):
    """``recs`` with a ``step.replay`` span inside every ``every``-th call's forward."""
    out = list(recs)
    for i, r in enumerate(r for r in recs if r[0] == "step.forward"):
        if i % every == 0:
            out.append(("step.replay", MAIN, r[2], r[2] + MS, "loop.step"))
    return out


@pytest.mark.parametrize("name", ["graph_share.train", "graph_share.test"])
def test_reads_the_share_of_steps_that_replayed(monkeypatch, name):
    run, recs = _run(30, traced=range(11, 19))
    monkeypatch.setattr(program_spans, "_records", lambda: _replayed(recs, 2))
    # calls 0, 2, ..., 30 replayed; of the 22 untraced window calls (1-10, 19-30) 11 are even
    assert spec.reader(name)(run) == pytest.approx(100.0 * 11 / 22)
    run, recs = _run(30)
    monkeypatch.setattr(program_spans, "_records", lambda: recs)
    assert spec.reader(name)(run) == 0.0  # no step replayed, as on a program without graphs


def test_none_without_the_recorder_or_with_too_few_steps(monkeypatch):
    run, recs = _run(25)
    monkeypatch.setattr(program_spans, "_records", lambda: _replayed(recs, 1))
    assert graph_share.share(run) == 100.0
    few, recs = _run(program_spans.MIN_STEPS - 2)
    monkeypatch.setattr(program_spans, "_records", lambda: _replayed(recs, 1))
    assert graph_share.share(few) is None
    monkeypatch.setattr(program_spans, "_records", lambda: None)  # no recorder
    assert graph_share.share(_run(25)[0]) is None
    assert graph_share.share(types.SimpleNamespace(spans=None)) is None
