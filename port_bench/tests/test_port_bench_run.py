"""Whole runs of tiny cells on the CPU, past the harness's look for a card:
the result's keys, a sound run judged correct, each fault the cell can have
judged not correct, and the float8 control reading above the program. On a card,
one short run of every cell at its own size."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench import run as bench_run
from port_bench import spec
from port_bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, faults=None, trace=False, seed=2**33 + 5):
    return bench_run.run_once(tiny.cell(name), seed, 0.5, trace, "cpu", time.perf_counter(),
                              faults=faults)


def unchanged(step):
    """A step that returns its state as it found it."""
    def faulty(state, batch, lr):
        params = [p.detach().clone() for p in state.model.parameters()]
        bufs = {id(p): {k: v.clone() for k, v in st.items()}
                for p, st in state.optimizer.state.items()}
        out = step(state, batch, lr)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(q)
        for p in list(state.optimizer.state):
            if id(p) in bufs:
                state.optimizer.state[p] = bufs[id(p)]
            else:
                del state.optimizer.state[p]
        return out
    return faulty


def frozen_params(step):
    """A step whose update never reaches the parameters: the optimizer's
    buffers move as they should, the parameters stay as they were."""
    def faulty(state, batch, lr):
        params = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, batch, lr)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(q)
        return out
    return faulty


def wrong_lr(step):
    """A step at twice the learning rate the schedule gives."""
    def faulty(state, batch, lr):
        return step(state, batch, 2.0 * lr)
    return faulty


def _rows(x, n):
    if isinstance(x, dict):
        return {k: _rows(v, n) for k, v in x.items()}
    if isinstance(x, (torch.Tensor, list)) and len(x) > n:
        return x[:n]
    return x


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def faulty(state, batch, lr):
        return step(state, _rows(batch, batch["waveform"].shape[0] // 2), lr)
    return faulty


def altered_logits(step):
    """The step's answer altered where it is produced: the verb logits
    doubled as the model gives them."""
    def faulty(state, batch, lr):
        hook = state.model.register_forward_hook(
            lambda _mod, _args, out: (out[0] * 2.0, *out[1:]))
        try:
            return step(state, batch, lr)
        finally:
            hook.remove()
    return faulty


def altered_scores(step):
    """Every view's verb scores altered where they are produced."""
    def faulty(model, batch):
        verb, noun = step(model, batch)
        return verb * 1.1, noun
    return faulty


@pytest.mark.parametrize("name", ["epic-train-b128", "epic-gru-train-b16",
                                  "epic-test-b128-10view"])
def test_sound_run(name):
    result, lines = _run(name, trace=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = spec.cell(name)
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert lines[-len(result["checks"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]
    json.dumps(result)


def test_untraced_run_reports_the_end_to_end_metrics():
    result, _ = _run("epic-train-b128")
    assert list(result) == KEYS
    assert {"train_samples_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in ("epic-train-b128", "epic-gru-train-b16")
    for fault in (unchanged, frozen_params, wrong_lr, half_batch, altered_logits)],
    ids=lambda x: getattr(x, "__name__", x))
def test_train_fault_is_not_correct(name, fault):
    result, lines = _run(name, {"train_step": fault})
    assert not result["correct"], lines


def test_test_fault_is_not_correct():
    result, lines = _run("epic-test-b128-10view", {"eval_step": altered_scores})
    assert not result["correct"], lines


@pytest.mark.parametrize("name", ["epic-train-b128", "epic-gru-train-b16",
                                  "epic-test-b128-10view"])
def test_float8_control_reads_above_the_program(name):
    """The control, the reference in float8 in the program's place, reads a
    compared number at least three times the program's (the card's readings
    and limits are in PERF.md)."""
    from port_bench import cells

    cell = tiny.cell(name)
    out, _ = cells.run_cell(cell, 2**33 + 9, 0.3, False, "cpu", time.perf_counter(),
                            controls=True)
    fp8 = out["info"]["fp8"]
    assert any(fp8[k] >= 3 * out["checks"][k] for k in cell.limits if k in fp8), (fp8, out)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "epic-train-b128",
                           "--seed", "1", "--seconds", "1"], cwd=spec.ROOT,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name, "--seed",
                           str(2**32 + 3), "--seconds", "3"], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
