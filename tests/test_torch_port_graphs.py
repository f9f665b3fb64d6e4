"""The train and eval steps as CUDA graphs (``engine/graphs.py``) and the slow
pathway's index kept on the device (``engine/pipeline.py``).

On the CPU: the signature, the rule that decides whether a graph may run a
step, the first batch of a signature run eagerly, the second captured and
replayed, a new owner dropping the graphs, and ``pack_pathways`` copying its
index to the device once for a given (frames, alpha, device).

On the card (marked ``cuda``, skipped elsewhere; imports no JAX): single-clip
train steps (the verb/noun model with plain and with sub-batch norms, and the
state head) and eval batches through their graphs against the same steps
forced eager, from the same weights and seeds, bit for bit, with a ragged
batch between the replays; a GRU batch and a CPU model never graphed; no
prefetcher's stream is the one captures run on.

    python -m pytest tests/test_torch_port_graphs.py -q --noconftest
"""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data.prefetch import Prefetcher
from asf_tpu_torch.engine import graphs, steps
from asf_tpu_torch.engine.optimizer import SGD, Adam
from asf_tpu_torch.engine.pipeline import pack_pathways
from asf_tpu_torch.entry import clip_samples, epic_cfg, epic_gru_cfg, epic_state_cfg
from asf_tpu_torch.models import build_model
from asf_tpu_torch.utils import spans


def _batch(b, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"waveform": torch.zeros(b, 16, dtype=torch.int16, device=device),
            "n_valid": torch.full((b,), 16, dtype=torch.int32, device=device),
            "labels": {"verb": torch.randint(0, 9, (b,), generator=g).to(device),
                       "noun": torch.randint(0, 9, (b,), generator=g).to(device)},
            "index": torch.arange(b, device=device), "host_rows": b}


def _paths(b, frames=32):
    return [torch.zeros(b, 1, frames // 4, 8), torch.zeros(b, 1, frames, 8)]


# -- on the CPU --------------------------------------------------------------

def test_the_signature_is_the_shapes_dtypes_and_train_flag():
    sig = graphs.signature(_paths(4), _batch(4), True)
    assert sig == graphs.signature(_paths(4), _batch(4, seed=1), True)  # values do not count
    assert sig != graphs.signature(_paths(4), _batch(4), False)
    assert sig != graphs.signature(_paths(4, frames=64), _batch(4), True)
    assert sig != graphs.signature(_paths(3), _batch(3), True)
    ints = _batch(4)
    ints["labels"]["verb"] = ints["labels"]["verb"].int()
    assert sig != graphs.signature(_paths(4), ints, True)
    assert sig != graphs.signature(_paths(4), {**_batch(4), "lengths": torch.ones(4)}, True)
    # a graph reads only what the work after the front end reads of the batch
    assert set(graphs.after_frontend(_batch(4))) == {"labels"}
    gru = {**_batch(4), "lengths": torch.ones(4), "noun_embedding": torch.zeros(4, 2)}
    assert set(graphs.after_frontend(gru)) == {"labels", "lengths", "noun_embedding"}
    assert set(graphs.after_frontend(gru, graphs.EVAL_READS)) == {"lengths", "noun_embedding"}


def test_a_graph_engages_only_where_the_step_can_observe_it_may(monkeypatch):
    model = torch.nn.Linear(2, 2)
    sgd, adam = SGD(model.parameters(), lr=0.1), Adam(model.parameters(), lr=0.1)
    cuda = torch.device("cuda")
    assert graphs.engages(cuda, _batch(4), sgd)
    assert graphs.engages(cuda, _batch(4))  # an eval step has no optimizer
    assert not graphs.engages("cpu", _batch(4), sgd)
    assert not graphs.engages(cuda, {**_batch(4), "host_lengths": [1, 2, 1, 1]}, sgd)
    assert not graphs.engages(cuda, _batch(4), adam)  # its step count is a host value
    assert not graphs.engages(cuda, _batch(4), torch.optim.SGD(model.parameters(), lr=0.1))
    monkeypatch.setattr(graphs.dist, "is_initialized", lambda: True)
    assert not graphs.engages(cuda, _batch(4), sgd)
    assert not graphs.engages(cuda, _batch(4))


class _FakeGraph:
    """Stands in for a captured graph on the CPU: counts captures and replays."""

    made = []

    def __init__(self, fn, paths, batch, params=None):
        self.fn, self.replays = fn, 0
        _FakeGraph.made.append(self)

    def replay(self, paths, batch):
        self.replays += 1
        return ("replayed", self.fn(paths, batch))


def test_the_first_batch_of_a_signature_runs_eagerly_the_second_captures(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _FakeGraph)
    _FakeGraph.made = []
    runner = graphs.StepGraphs()
    model = object()

    def fn(paths, batch):
        return "eager"

    def run(key, owner=(model,)):
        return runner.run(owner, key, fn, [key], {})

    spans.clear()
    assert [run("a"), run("b")] == ["eager", "eager"]
    assert not _FakeGraph.made
    assert run("a") == ("replayed", "eager")  # captured, then replayed
    assert run("a")[0] == "replayed" and run("b")[0] == "replayed"
    assert len(_FakeGraph.made) == 2 and [g.replays for g in _FakeGraph.made] == [2, 1]
    names = collections.Counter(r[0] for r in spans.records())
    assert names == {"step.capture": 2, "step.replay": 3}
    # another model (a resume rebuilt it): every graph and every signature seen is dropped
    assert run("a", owner=(object(),)) == "eager"
    assert run("a", owner=(model,)) == "eager"
    assert len(_FakeGraph.made) == 2


def test_pack_pathways_copies_the_slow_index_once_per_frames_and_alpha():
    cfg = get_cfg()
    cfg.MODEL.ARCH = "slowfast"
    cfg.SLOWFAST.ALPHA = 4

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.__name__)
            return func(*args, **(kwargs or {}))

    def copies(frames):
        spec = torch.empty(2, frames, 8, device="meta")  # a device the index must reach
        mode = Ops()
        mode.ops = []
        with mode:
            slow, fast = pack_pathways(cfg, spec)
        assert slow.shape == (2, 1, frames // cfg.SLOWFAST.ALPHA, 8)
        assert fast.shape == (2, 1, frames, 8)
        return sum(op.startswith(("_to_copy", "copy")) for op in mode.ops)

    first = copies(56)
    assert first == 1 and copies(56) == 0 and copies(56) == 0
    assert copies(60) == 1 and copies(60) == 0
    cfg.SLOWFAST.ALPHA = 2
    assert copies(56) == 1


# -- on the card ---------------------------------------------------------------

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()", reason="CUDA graphs need a GPU")


N_ATTRIBUTES = 5  # the state head's PDDL attributes in the card tests


def _card_cfg(gru=False, kind="batchnorm"):
    """The EPIC models with SpecAugment, from their initialisation: BN unfrozen,
    so that the untrained trunk's activations stay normalised. ``kind``:
    ``batchnorm``, ``sub_batchnorm`` (two splits of the batch) or ``state``
    (the single-clip state head over ``N_ATTRIBUTES`` attributes)."""
    cfg = epic_gru_cfg() if gru else epic_state_cfg() if kind == "state" else epic_cfg()
    cfg.GPU.SPEC_AUGMENT = True
    cfg.BN.FREEZE = False
    if kind == "sub_batchnorm":
        cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = "sub_batchnorm", 2
    if kind == "state":
        cfg.MODEL.NUM_CLASSES = [*cfg.MODEL.NUM_CLASSES, N_ATTRIBUTES]
    if gru:
        cfg.MODEL.GRU_HIDDEN_SIZE = 32
        cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS = 2
    return cfg


def _card_batch(cfg, b, seed, chains=None, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    s = clip_samples(cfg)
    shape = (b, s) if chains is None else (b, chains, s)
    verbs, nouns = cfg.MODEL.NUM_CLASSES[:2]
    batch = {"waveform": (torch.randn(shape, generator=g) * 3000).to(torch.int16),
             "n_valid": torch.full(shape[:-1], s, dtype=torch.int32),
             "labels": {"verb": torch.randint(0, verbs, (b,), generator=g),
                        "noun": torch.randint(0, nouns, (b,), generator=g)},
             "index": torch.arange(b)}
    if chains is not None:
        batch["lengths"] = torch.full((b,), chains, dtype=torch.int64)
    if len(cfg.MODEL.NUM_CLASSES) > 2:
        for key in ("precs", "posts"):
            batch["labels"][key] = torch.randint(-1, 2, (b, N_ATTRIBUTES), generator=g).float()
    batch = graphs._map(batch, lambda t: t.to(device))
    if chains is not None:
        batch["host_lengths"] = [chains] * b
    return batch


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, so that two eager runs of a step
    agree bit for bit, and a graphed run must agree with them."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = was


def _span_names():
    names = collections.Counter(r[0] for r in spans.records())
    spans.clear()
    return names


def _train_run(cfg, sizes, graphed, monkeypatch, device="cuda", chains=None):
    """Train steps of batches of ``sizes`` rows from seeded weights: each
    step's (parts, stats), the state, each step's span names."""
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(graphs, "engages", lambda *a, **k: False)
        model = build_model(cfg, device, torch.Generator().manual_seed(1))
        state = steps.init_state(cfg, model)
        state.generator.manual_seed(3)
        step = steps.make_train_step(cfg, device)
        torch.manual_seed(5)  # the head's dropout
        spans.clear()
        outs, names = [], []
        for i, b in enumerate(sizes):
            outs.append(step(state, _card_batch(cfg, b, 10 + i, chains, device),
                             0.002 * (1 + i / 10)))
            names.append(_span_names())
        if device == "cuda":
            torch.cuda.synchronize()
    return outs, state, names


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(a, b), (what, (a.double() - b.double()).abs().max().item())


def _momenta(state):
    opt = state.optimizer
    return {n: opt.state[p]["momentum_buffer"] for n, p in state.model.named_parameters()
            if p in opt.state}


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("kind", ["batchnorm", "sub_batchnorm", "state"])
def test_graphed_train_steps_equal_eager_ones_bit_for_bit(monkeypatch, deterministic, kind):
    """Six steps at B = 8 with a ragged B = 6 fourth: eager, captured and
    replayed, replayed, eager (a signature seen once), replayed, replayed;
    against the six steps eager. Every step's numbers, and after the last
    the parameters, gradients, momenta and BN statistics, are equal."""
    cfg = _card_cfg(kind=kind)
    sizes = [8, 8, 8, 6, 8, 8]
    g_out, g_state, g_names = _train_run(cfg, sizes, True, monkeypatch)
    e_out, e_state, e_names = _train_run(cfg, sizes, False, monkeypatch)
    graphed = [("step.replay" in n, "step.capture" in n) for n in g_names]
    assert graphed == [(False, False), (True, True), (True, False), (False, False),
                       (True, False), (True, False)]
    norms = {type(m).__name__ for m in g_state.model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)}
    assert norms == {"GroupedBatchNorm2d" if kind == "sub_batchnorm" else "BatchNorm2d"}
    assert ("state_loss" in g_out[1][0]) == (kind == "state")
    assert all("step.forward" in n for i, n in enumerate(g_names) if i in (0, 3))
    assert not any("step.replay" in n or "step.capture" in n for n in e_names)
    for i, ((gp, gs), (ep, es)) in enumerate(zip(g_out, e_out)):
        assert set(gp) == set(ep) and set(gs) == set(es)
        assert bool(torch.isfinite(ep["loss"])), f"step {i + 1} diverged"
        for k in ep:
            _same(gp[k], ep[k], f"step {i + 1} {k}")
        for k in es:
            _same(gs[k], es[k], f"step {i + 1} {k}")
    # the graphed steps' losses are their own tensors, which no later replay overwrote
    losses = [g_out[i][0]["loss"] for i in (1, 2, 4, 5)]
    assert len({t.data_ptr() for t in losses}) == 4 and len({float(t) for t in losses}) == 4
    g_named = dict(g_state.model.named_parameters())
    e_named = dict(e_state.model.named_parameters())
    for n, p in e_named.items():
        _same(g_named[n].detach(), p.detach(), n)
        if p.grad is not None:
            _same(g_named[n].grad, p.grad, f"{n}.grad")
    g_bufs = dict(g_state.model.named_buffers())
    for n, buf in e_state.model.named_buffers():
        _same(g_bufs[n], buf, n)
    assert all(bool(buf.abs().sum() > 0) for n, buf in e_state.model.named_buffers()
               if n.endswith("running_mean"))
    g_mom, e_mom = _momenta(g_state), _momenta(e_state)
    assert set(g_mom) == set(e_mom) and e_mom
    for n in e_mom:
        _same(g_mom[n], e_mom[n], f"{n} momentum")


@pytest.mark.cuda
@needs_cuda
def test_graphed_eval_batches_equal_eager_ones_bit_for_bit(monkeypatch, deterministic):
    cfg = _card_cfg()
    sizes = [8, 8, 8, 5]

    def run(graphed):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(graphs, "engages", lambda *a, **k: False)
            model = build_model(cfg, "cuda", torch.Generator().manual_seed(1))
            step = steps.make_eval_step(cfg, "cuda")
            spans.clear()
            outs, names = [], []
            for i, b in enumerate(sizes):
                outs.append(step(model, _card_batch(cfg, b, 20 + i)))
                names.append(_span_names())
            torch.cuda.synchronize()
        return outs, names

    g_out, g_names = run(True)
    e_out, e_names = run(False)
    assert [("step.replay" in n, "step.capture" in n) for n in g_names] == \
        [(False, False), (True, True), (True, False), (False, False)]
    assert not any("step.replay" in n for n in e_names)
    for i, (g, e) in enumerate(zip(g_out, e_out)):
        for task, (a, b) in enumerate(zip(g, e)):
            _same(a, b, f"batch {i + 1} task {task}")
    assert g_out[1][0].data_ptr() != g_out[2][0].data_ptr()


@pytest.mark.cuda
@needs_cuda
def test_a_gru_batch_and_a_cpu_model_run_eagerly(monkeypatch):
    gru = _card_cfg(gru=True)
    for device in ("cuda", "cpu"):
        cfg, chains = (gru, 2) if device == "cuda" else (_card_cfg(), None)
        _, state, names = _train_run(cfg, [2, 2, 2], True, monkeypatch, device, chains)
        assert state.step == 3
        for n in names:
            assert "step.forward" in n and "step.replay" not in n and "step.capture" not in n


@pytest.mark.cuda
@needs_cuda
def test_no_prefetcher_draws_the_stream_captures_run_on():
    """torch hands out its streams round-robin, 32 a priority: a capture on a
    stream of default priority would share it with a later prefetcher, whose
    thread's copies the capture would take in. None of 64 prefetchers' streams
    is the one every capture runs on."""
    capture = graphs.capture_stream("cuda")
    assert capture is graphs.capture_stream(torch.device("cuda", 0))
    drawn = {Prefetcher(iter(()), "cuda", depth=0)._stream.cuda_stream for _ in range(64)}
    assert len(drawn) < 64 and capture.cuda_stream not in drawn  # the pool came round
