"""The readers of the program's spans (``program_spans.py``) on fabricated runs:
which records a step holds, the medians and means they give, the traced steps
and other threads left out, and None where there is too little to read."""

from __future__ import annotations

import types

import pytest

from port_bench import program_spans, spec

MS = 1_000_000  # ns
MAIN, WORKER = 1, 2


def _run(steps: int, traced=(), ops=None):
    """``steps`` window calls of 10 ms, one every 20 ms, after one set-up call;
    each slot holds a data wait of 1 + i % 3 ms, the call's forward (4 ms) and
    a 2 ms wait inside it, a 5 ms flush after every 10th call, and a worker's
    upload; the records as the program's ring gives them."""
    calls, recs = [], []
    for i in range(steps + 1):
        t_in = (20 * i + 8) * MS
        calls.append((t_in / 1e9, (t_in + 10 * MS) / 1e9, 4, 4, 1, 4, "window" if i else "setup"))
        recs += [("loop.data_wait", MAIN, t_in - (2 + i % 3) * MS, t_in - MS, None),
                 ("loop.step", MAIN, t_in - MS // 2, t_in + 10 * MS + MS // 2, None),
                 ("step.forward", MAIN, t_in + MS, t_in + 5 * MS, "loop.step"),
                 ("wait.slow_index", MAIN, t_in + 5 * MS, t_in + 7 * MS, "loop.step"),
                 ("prefetch.upload", WORKER, t_in, t_in + 3 * MS, None)]
        if i % 10 == 0:
            recs.append(("loop.flush", MAIN, t_in + 11 * MS, t_in + 16 * MS, None))
    run = types.SimpleNamespace(spans=types.SimpleNamespace(calls=calls),
                                window_calls=list(range(1, steps + 1)), traced=set(traced),
                                trace=None if ops is None else {"steps": 8, "ops": ops})
    return run, recs


def _with(monkeypatch, recs):
    monkeypatch.setattr(program_spans, "_records", lambda: recs)


def test_host_readers_take_each_step_its_slot(monkeypatch):
    run, recs = _run(30, traced=range(11, 19))
    _with(monkeypatch, recs)
    # the 22 untraced steps: waits of 1, 2, 3 ms by i % 3
    waits = sorted(1 + i % 3 for i in range(1, 31) if not 11 <= i < 19)
    assert program_spans.median_ms(run, "loop.data_wait") == pytest.approx(
        (waits[10] + waits[11]) / 2)
    assert program_spans.median_ms(run, "step.forward") == pytest.approx(4.0)
    assert program_spans.median_ms(run, "wait.") == pytest.approx(2.0)
    # the flushes after calls 0, 10, 20 and 30 fall in the slots of calls 1, 11 (traced),
    # 21 and none
    assert program_spans.mean_ms(run, "loop.flush") == pytest.approx(2 * 5.0 / 22)
    assert program_spans.median_ms(run, "prefetch.upload") == 0.0  # the worker's thread


def test_host_readers_need_twenty_steps_and_the_recorder(monkeypatch):
    run, recs = _run(19)
    _with(monkeypatch, recs)
    assert program_spans.median_ms(run, "step.forward") is None
    run, _ = _run(25)
    _with(monkeypatch, None)  # a program without the recorder
    assert program_spans.median_ms(run, "step.forward") is None
    assert program_spans.mean_ms(run, "loop.flush") is None


def test_device_reader_reads_the_spans_ops_a_traced_step():
    run, _ = _run(25, ops={"step.update": 0.016, "aten::mm": 1.0})
    assert program_spans.device_ms(run, "step.update") == pytest.approx(2.0)
    assert program_spans.device_ms(run, "step.frontend") is None
    run, _ = _run(25)
    assert program_spans.device_ms(run, "step.update") is None


@pytest.mark.parametrize("name", ["data_wait_ms.train", "flush_host_ms.train",
                                  "sync_wait_ms.test", "frontend_ms.test", "update_ms.train"])
def test_each_span_metric_reads_nothing_from_a_program_without_spans(monkeypatch, name):
    run, _ = _run(25, ops={"aten::mm": 1.0})
    _with(monkeypatch, None)
    assert spec.reader(name)(run) is None
