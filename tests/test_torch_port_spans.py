"""The program's spans (``asf_tpu_torch/utils/spans.py``) on the CPU.

The ring keeps the last ``CAPACITY`` spans and finds each one's parent on
its own thread; under ``torch.profiler`` a span is a host event at FUNCTION
scope with the operators it ran as its children, and without a profiler it
goes to the ring alone. A tiny ``train_epoch`` (the depth-26 verb/noun
SlowFast of ``test_torch_port_epic.py``, 4 steps of B = 4, a flush every 2,
``GPU.PROFILE_DIR`` over iteration 1) and a tiny ``perform_test`` (6 clips
in 3 views, 5 batches), each fed from a device store, record every span of
their path once a call, the step's spans inside ``loop.step``, and no
``wait.slow_index`` (the slow pathway's index stays on the device, so no
step waits for it); every name they record is in ``NAMES``. On the
CPU no step runs as a CUDA graph (``step.capture``, ``step.replay``). The
meter's ``dt_data`` is the ``loop.data_wait`` span's own time.
"""

import collections
import json
import os
import threading

import pytest
import torch

from asf_tpu_torch.data import loader
from asf_tpu_torch.data.device_store import DeviceSegmentStore
from asf_tpu_torch.engine import meters
from asf_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from asf_tpu_torch.engine.test_loop import perform_test
from asf_tpu_torch.engine.train_loop import build_train_meter, train_epoch
from asf_tpu_torch.models import build_model
from asf_tpu_torch.utils import spans
from asf_tpu_torch.utils.spans import span
from test_torch_port_epic import CLASSES, VIEWS, epic_cfgs, epic_root  # noqa: F401  (fixture)
from test_torch_port_loop import _model_cfg

BUDGET = 64 << 20
STEP_SPANS = ("step.frontend", "step.forward", "step.backward", "step.update", "step.stats")
# Every span the program records (``span``, ``begin``/``end``).
NAMES = ("loop.data_wait", "loop.step", "loop.flush", "loop.meter", *STEP_SPANS,
         "step.capture", "step.replay", "prefetch.upload", "store.gather", "store.read",
         "store.upload")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _names(recs):
    return collections.Counter(r[0] for r in recs)


def test_the_ring_is_bounded_and_spans_nest_on_their_thread():
    spans.clear()
    for i in range(spans.CAPACITY + 3):
        with span(f"s{i}"):
            pass
    recs = spans.records()
    assert len(recs) == spans.CAPACITY and recs[0][0] == "s3"
    assert all(r[2] <= r[3] for r in recs)

    spans.clear()
    with span("a"):
        with span("b"):
            with span("c"):
                t = threading.Thread(target=lambda: span("t").begin().end())
                t.start()
                t.join(timeout=10)
        with span("d"):
            pass
    with span("e"):
        pass
    assert not t.is_alive()
    recs = spans.records()
    assert [r[0] for r in recs] == ["t", "c", "b", "d", "a", "e"]
    assert {r[0]: r[4] for r in recs} == {"a": None, "b": "a", "c": "b", "d": "a", "e": None,
                                          "t": None}
    assert len({r[1] for r in recs}) == 2


def test_under_the_profiler_a_span_is_a_function_event_and_else_the_ring_alone():
    spans.clear()
    x = torch.ones(8, 8)
    with span("before"):
        x.add(1)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with span("inside"):
            x.mul(2)
    finally:
        prof.stop()
    events = {e.name: e for e in prof.events()}
    assert "before" not in events
    inside = events["inside"]
    assert inside.device_type == torch.autograd.DeviceType.CPU
    assert inside.is_user_annotation is False
    assert "aten::mul" in [c.name for c in inside.cpu_children]
    assert [r[0] for r in spans.records()] == ["before", "inside"]


@pytest.fixture(scope="module")
def train_run(epic_root, tmp_path_factory):  # noqa: F811
    """One ``train_epoch`` from the device store: the ring's spans, each
    iteration's times as the meter handed them to its records, and the
    ``GPU.PROFILE_DIR`` trace."""
    _, cfg = epic_cfgs(epic_root)
    _model_cfg(cfg, False)
    cfg.MODEL.NUM_CLASSES = list(CLASSES)
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.LOG_PERIOD = 2
    cfg.GPU.PROFILE_DIR = str(tmp_path_factory.mktemp("profile"))
    cfg.GPU.PROFILE_START_ITER = 1
    cfg.GPU.PROFILE_NUM_ITERS = 1
    ld = loader.construct_loader(cfg, "train")
    ld.attach_store(DeviceSegmentStore.try_build(ld.dataset, BUDGET, "cpu"))
    state = init_state(cfg, build_model(cfg, "cpu", torch.Generator().manual_seed(1)))
    meter = build_train_meter(cfg, len(ld))
    times = []
    log_iter_stats = meter.log_iter_stats
    meter.log_iter_stats = lambda epoch, it, t=None: (times.append(t),
                                                      log_iter_stats(epoch, it, t))
    spans.clear()
    try:
        train_epoch(ld, state, make_train_step(cfg, "cpu"), meter, 0, cfg, "cpu")
    finally:
        ld.close()
    (trace,) = os.listdir(cfg.GPU.PROFILE_DIR)
    with open(os.path.join(cfg.GPU.PROFILE_DIR, trace)) as f:
        events = json.load(f)["traceEvents"]
    return spans.records(), times, events, len(ld)


def test_train_epoch_records_each_span_of_its_path(train_run):
    recs, _, _, steps = train_run
    assert steps == 4
    assert _names(recs) == {"loop.data_wait": steps + 1, "loop.step": steps,
                            **{n: steps for n in STEP_SPANS},
                            "loop.flush": steps // 2 + 1, "prefetch.upload": steps,
                            "store.gather": steps}
    assert "wait.slow_index" not in _names(recs)
    assert set(_names(recs)) <= set(NAMES)
    parents = {(r[0], r[4]) for r in recs}
    assert {(n, "loop.step") for n in STEP_SPANS} <= parents
    assert {p for n, p in parents if n == "store.gather"} == {"prefetch.upload"}
    assert {p for n, p in parents if n.startswith("loop.")} == {None}


def test_dt_data_is_the_data_wait_span(train_run):
    recs, times, _, steps = train_run
    waits = [(r[3] - r[2]) / 1e9 for r in recs if r[0] == "loop.data_wait"]
    nets = [(r[3] - r[2]) / 1e9 for r in recs if r[0] == "loop.step"]
    assert len(times) == steps
    for (dt, dt_data, dt_net), wait, net in zip(times, waits, nets):
        assert dt_data == pytest.approx(wait, abs=1e-6)
        assert dt_net == pytest.approx(net, abs=1e-6)
        assert dt == pytest.approx(wait + net, abs=1e-6)


def test_the_profile_dir_trace_holds_the_step_spans(train_run):
    _, _, events, _ = train_run
    cats = {e.get("name"): e.get("cat") for e in events}
    for name in ("loop.step", *STEP_SPANS):
        assert cats.get(name) == "cpu_op", name


def test_perform_test_records_each_span_of_its_path(epic_root):  # noqa: F811
    _, cfg = epic_cfgs(epic_root)
    _model_cfg(cfg, False)
    cfg.MODEL.NUM_CLASSES = list(CLASSES)
    cfg.DATA_LOADER.NUM_WORKERS = 0
    ld = loader.construct_loader(cfg, "test")
    ld.attach_store(DeviceSegmentStore.try_build(ld.dataset, BUDGET, "cpu"))
    ds = ld.dataset
    meter = meters.EPICTestMeter(len(ds) // VIEWS, VIEWS, CLASSES, len(ld))
    spans.clear()
    try:
        perform_test(ld, build_model(cfg, "cpu"), make_eval_step(cfg, "cpu"), meter, "cpu")
    finally:
        ld.close()
    recs = spans.records()
    steps = len(ld)
    assert steps == 5
    assert _names(recs) == {"loop.data_wait": steps + 1, "loop.step": steps,
                            "step.frontend": steps, "step.forward": steps,
                            "loop.meter": steps, "prefetch.upload": steps,
                            "store.gather": steps}
    assert set(_names(recs)) <= set(NAMES)
    parents = {(r[0], r[4]) for r in recs}
    assert {("step.frontend", "loop.step"), ("step.forward", "loop.step"),
            ("loop.meter", None)} <= parents
