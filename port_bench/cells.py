"""One run of a cell: set-up, the measured window, and the check against the reference.

Set-up (timed as ``setup_s``, from the process's start to the window's):
the split is generated from the seed into a temporary directory under
``TMPDIR``; the port's objects are built as ``train(cfg)`` / ``test(cfg)``
build them (``build_model``, ``init_state``, ``make_train_step`` or
``make_eval_step``, ``construct_loader``, ``DeviceSegmentStore.try_build``
and ``attach_store``, the meter), the seed's weights are loaded; then the
window's own loop (``train_epoch`` or ``perform_test``, fed by the loader
with the store attached) runs the traffic's check steps, whose results the
reference judges after the window, and its warm-up steps (for chains, one
batch of every window bucket the split holds).

The window: the same loop over the batches that follow, until ``seconds``
have passed (the loader then stops handing out batches; the batches already
copied ahead still run), ending with ``torch.cuda.synchronize()``. A train
window that reaches the end of an epoch goes on with the next, as
``train(cfg)`` does, without precise BN, checkpoints or a val epoch; a test
window that reaches the end of the split scores it again into a new meter.

The harness's spans sit at the calls it passes in: ``Spans`` wraps
``train_step`` / ``eval_step`` (host time in and between calls, the rows and
chain lengths of each batch) and records a CUDA event after each call.
With ``trace``, ``torch.profiler`` records a stretch of steps from 40 % of
the window on.
"""

from __future__ import annotations

import gc
import os
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from . import flops, traffic, weights
from . import trace as trace_mod
from .reference import frontend, inputs, slowfast, steps as ref_steps

TRACE_AT = 0.4  # the traced stretch starts this far into the window
TRACE_STEPS = {"train": 8, "test": 24}
CALIBRATION_ROWS = 16
TEST_SAMPLE_CLIPS = 64
REF_BLOCK = 128  # views a reference eval forward takes at once


def sub_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([int(seed) % (2**63), k]).generate_state(1)[0])


# -- the program's side ------------------------------------------------------

def port_cfg(cfg_dict: dict, split, root: str):
    """The port's config: its defaults, then the configuration as run, then
    the generated split's paths."""
    from asf_tpu_torch.config import get_cfg
    from asf_tpu_torch.config.cfg_node import CfgNode

    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(cfg_dict))
    c = cfg.EPICKITCHENS
    c.AUDIO_DATA_FILE = split.archive
    c.ANNOTATIONS_DIR = root
    c.PROCESSED_TRAIN_LIST = c.PROCESSED_VAL_LIST = c.PROCESSED_TEST_LIST = \
        os.path.basename(split.annotations)
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    cfg.LOG_MODEL_INFO = False
    return cfg


class Feed:
    """``loader``'s batches from the ``skip``-th on: ``take`` of them, or until
    ``deadline`` (a ``perf_counter`` time) has passed."""

    def __init__(self, loader, skip: int = 0, take: int | None = None, deadline=None):
        self.loader, self.skip, self.take, self.deadline = loader, skip, take, deadline
        self.device_store = loader.device_store

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):  # the loader's other attributes (its ranks)
        return getattr(self.loader, name)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i < self.skip:
                continue
            if self.take is not None and i >= self.skip + self.take:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            yield batch


class Chunks:
    """A loader-like feed of given row chunks, as offset batches of ``loader``'s store."""

    def __init__(self, loader, chunks: list):
        from asf_tpu_torch.data.device_store import offset_batch

        self.loader, self.chunks, self._offset = loader, chunks, offset_batch
        self.device_store = loader.device_store
        ds = loader.dataset
        self._bases = np.asarray([self.device_store.base(k) for k in ds.ref_seg_keys()],
                                 np.int64)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        ds = self.loader.dataset
        for rows in self.chunks:
            yield self._offset(ds.ref_batch(0, np.asarray(rows)), self._bases,
                               self.device_store, self.loader.max_windows)


class Spans:
    """Wraps the step the loop calls: host seconds in and between calls, rows,
    chain lengths, a CUDA event after each call; ``check`` captures what the
    reference judges; ``profile`` traces a stretch of calls."""

    def __init__(self, fn, kind: str, cuda: bool):
        self.fn, self.kind, self.cuda = fn, kind, cuda
        self.pipeline = getattr(fn, "pipeline", None)
        self.calls = []  # (t_in, t_out, rows, chains B, windows Nb, sum of lengths, phase)
        self.lengths = []  # each call's chain lengths (None for single clips)
        self.events = []
        self.outputs = []  # per call of the window: the loss (train)
        self.phase = "setup"
        self.check = None
        self.profile = None

    def __call__(self, *args):
        if self.profile is not None:
            self.profile.before(len(self.calls))
        batch = args[1]
        t_in = time.perf_counter()
        out = self.fn(*args)
        t_out = time.perf_counter()
        wave = batch["waveform"]
        lengths = batch.get("host_lengths")
        b, nb = (wave.shape[0], wave.shape[1]) if wave.dim() == 3 else (wave.shape[0], 1)
        self.calls.append((t_in, t_out, b * nb, b, nb,
                           sum(lengths) if lengths is not None else b, self.phase))
        self.lengths.append(list(lengths) if lengths is not None else None)
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        if self.phase == "window" and self.kind == "train":
            self.outputs.append(out[0]["loss"])
        if self.check is not None:
            self.check(args, out)
        if self.profile is not None:
            self.profile.after(len(self.calls))
        return out


class Profile:
    """``torch.profiler`` over ``n`` calls from the first call made after
    ``start_time``."""

    def __init__(self, start_time: float, n: int, cuda: bool):
        self.start_time, self.n, self.cuda = start_time, n, cuda
        self.prof, self.first, self.done = None, None, False
        self.tid = threading.get_native_id()

    def before(self, call: int):
        if self.done or self.prof is not None or time.perf_counter() < self.start_time:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.first = call

    def after(self, calls: int):
        if self.prof is not None and not self.done and calls - self.first >= self.n:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def stop(self):
        if self.prof is not None and not self.done:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
            self.done = True


def warm_profiler(cuda: bool) -> None:
    """Starts and stops the profiler once, so that the window's trace does
    not pay its first start (the device tracer's set-up)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
        _sync(cuda)


class TrainCheck:
    """Captures the first ``k`` train steps: inputs, losses, the momentum
    buffers after the first step, the parameters after the last."""

    def __init__(self, model, optimizer, k: int):
        self.k, self.model, self.optimizer = k, model, optimizer
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.batches, self.losses, self.bufs, self.params = [], [], None, None

    def __call__(self, args, out):
        if len(self.batches) >= self.k:
            return
        batch = args[1]
        self.batches.append({
            "wave": batch["waveform"].detach().clone(), "n_valid": batch["n_valid"].clone(),
            "verb": batch["labels"]["verb"].clone(), "noun": batch["labels"]["noun"].clone(),
            "index": batch["index"].clone(), "lr": float(args[2]),
            "lengths": list(batch["host_lengths"]) if "host_lengths" in batch else None})
        self.losses.append(out[0]["loss"].detach().clone())
        if len(self.batches) == 1:
            self.bufs = {self.names[id(p)]: st["momentum_buffer"].detach().clone()
                         for p, st in self.optimizer.state.items() if "momentum_buffer" in st}
        if len(self.batches) == self.k:
            self.params = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def to_host(self):
        move = (lambda t: t.cpu() if isinstance(t, torch.Tensor) else t)
        self.batches = [{k: move(v) for k, v in b.items()} for b in self.batches]
        self.losses = [float(x) for x in self.losses]
        self.bufs = {k: v.cpu() for k, v in self.bufs.items()}
        self.params = {k: v.cpu() for k, v in self.params.items()}


# -- the run -------------------------------------------------------------------

class Run:
    """What a run measured; the per-layer readers read it."""

    def __init__(self, m: dict, kind: str, peaks):
        self.m, self.kind, self.peaks = m, kind, peaks
        self.phases = {}  # set-up phase -> seconds
        self._t = time.perf_counter()
        self.spans = None
        self.window_s = 0.0
        self.window_calls = []  # indices into spans.calls
        self.gaps_s = []  # device seconds between consecutive window steps
        self.traced = set()  # call indices under the profiler
        self.trace = None
        self.passes = 3 if kind == "train" else 1

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = now - self._t
        self._t = now

    def step_flops(self, i: int) -> dict:
        _t0, _t1, rows, b, nb, _lsum, _ = self.spans.calls[i]
        if self.m["gru_layers"]:
            return flops.model_flops(self.m, rows, (b, nb), self.spans.lengths[i])
        return flops.model_flops(self.m, rows)

    def ideal_s(self, i: int) -> float:
        """The step's least time: the model's operations and the log-mel
        kernel's least time, over the real windows only."""
        real = self.spans.calls[i][5]
        s = flops.ideal_s(self.step_flops(i), self.peaks, self.m, self.passes)
        return s + flops.logmel_bound_s(self.m, real, self.peaks)


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def _close_window(run: Run, spans: Spans, start_event, t0: float, device, cuda: bool) -> int:
    """Ends the window at a synchronize; fills ``run`` with its steps, their
    gaps on the card and the traced stretch's summary; returns the memory
    peak, read before anything else runs on the card."""
    _sync(cuda)
    run.window_s = time.perf_counter() - t0
    idx = [i for i, c in enumerate(spans.calls) if c[6] == "window"]
    run.window_calls = idx
    if cuda and idx:
        times = [start_event.elapsed_time(spans.events[i]) / 1e3 for i in idx]
        run.gaps_s = list(np.diff([0.0] + times))
    prof = spans.profile
    if prof is not None and prof.prof is not None:
        run.traced = set(range(prof.first, min(prof.first + prof.n, len(spans.calls))))
        run.trace = trace_mod.summarize(prof.prof, prof.tid, len(run.traced))
    return torch.cuda.max_memory_allocated(device) if cuda else 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             faults: dict | None = None, controls: bool = False) -> dict:
    """One run; returns the result's parts (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``) and the
    ``Run``. ``faults`` wraps the program's step (``train_step`` or
    ``eval_step``: a function of the step that returns the faulty one).
    ``info`` holds what is reported beside the checks and, with
    ``controls``, the same numbers with the reference in the program's
    place, one precision below the configuration's (the control: a float8
    trunk, a bf16 front end under a float32 one) and with a planted fault."""
    from asf_tpu_torch.utils.torch_setup import disable_tf32
    from .peaks import peaks as peak_table

    faults = faults or {}
    device = torch.device(device)
    cuda = device.type == "cuda"
    disable_tf32()
    cfg_dict, m, t = cell.cfg, cell.m, cell.traffic
    run = Run(m, t["kind"], peak_table(device_name(device)))
    run.phases["start"] = time.perf_counter() - t_start  # interpreter, imports, the card
    tmp = tempfile.TemporaryDirectory(prefix="port_bench-")
    try:
        split = traffic.write(t, m, seed, tmp.name, int(cfg_dict["RNG_SEED"]),
                              tuple(m["num_classes"]))
        run.bytes_written = split.bytes_written
        run.mark("split")
        cfg = port_cfg(cfg_dict, split, tmp.name)
        w0 = weights.draw(m, seed, device)
        cal_rows = np.arange(min(CALIBRATION_ROWS, len(split.start)))
        wave, n_valid = inputs.clips(split, cal_rows, int(round(m["sampling_rate"] * m["clip_s"])),
                                     lambda *_: 0)
        weights.calibrate(w0, m, torch.from_numpy(wave).to(device).float() / 32768.0,
                          torch.from_numpy(n_valid).to(device))
        run.mark("weights")
        if t["kind"] == "train":
            out = _train(cell, cfg, m, t, split, w0, seed, seconds, trace, device, cuda, run,
                         t_start, faults, controls)
        else:
            out = _test(cell, cfg, m, t, split, w0, seed, seconds, trace, device, cuda, run,
                        t_start, faults, controls)
    finally:
        tmp.cleanup()
    return out, run


def _solver(cfg) -> dict:
    s = cfg.SOLVER
    steps = list(s.STEPS) + [s.MAX_EPOCH]
    ind = max(i for i, st in enumerate(steps) if st <= 0)
    return {"lr": float(s.LRS[ind] * s.BASE_LR), "momentum": float(s.MOMENTUM),
            "dampening": float(s.DAMPENING), "nesterov": bool(s.NESTEROV),
            "weight_decay": float(s.WEIGHT_DECAY), "bn_weight_decay": float(cfg.BN.WEIGHT_DECAY)}


def _bucket_chunks(loader, m: dict, seen: set, batch: int) -> list:
    """One chunk of rows for each window bucket of the split not yet in ``seen``:
    its longest chain in that bucket, the rest of one window."""
    ds = loader.dataset
    n = np.asarray(ds.chain_windows(np.arange(len(ds))))
    buckets = {}
    for r in np.argsort(n, kind="stable"):
        buckets.setdefault(frontend.bucket(int(n[r]), m["max_windows"]), int(r))
    short = [int(r) for r in np.flatnonzero(n == n.min())[: batch - 1]]
    return [[buckets[b]] + short for b in sorted(buckets) if b not in seen]


def _train(cell, cfg, m, t, split, w0, seed, seconds, trace, device, cuda, run, t_start, faults,
           controls):
    from asf_tpu_torch.data.device_store import DeviceSegmentStore
    from asf_tpu_torch.data.loader import construct_loader, shuffle_dataset
    from asf_tpu_torch.engine.steps import init_state, make_train_step
    from asf_tpu_torch.engine.train_loop import build_train_meter, train_epoch
    from asf_tpu_torch.models import build_model

    np.random.seed(cfg.RNG_SEED)
    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    model.load_state_dict(w0, strict=True)
    state = init_state(cfg, model)
    spec_seed, drop_seed = sub_seed(seed, 1), sub_seed(seed, 2)
    state.generator.manual_seed(spec_seed)
    loader = construct_loader(cfg, "train")
    store = DeviceSegmentStore.try_build(loader.dataset,
                                         int(cfg.GPU.TRAIN_DEVICE_CACHE_MB) << 20, device)
    if store is None:
        raise RuntimeError("the train split did not go into the device store")
    loader.attach_store(store)
    run.mark("build")
    step = make_train_step(cfg, device)
    if "train_step" in faults:
        step = faults["train_step"](step)
    meter = build_train_meter(cfg, len(loader))
    spans = Spans(step, "train", cuda)
    run.spans = spans
    k = int(t["check_steps"])
    check = TrainCheck(model, state.optimizer, k)
    spans.check = check
    torch.manual_seed(drop_seed)
    shuffle_dataset(loader, 0)
    train_epoch(Feed(loader, 0, take=k), state, spans, meter, 0, cfg, device)
    spans.check = None
    _sync(cuda)
    check.to_host()
    run.mark("check_steps")
    done = k
    if m["gru_layers"]:
        seen = {frontend.bucket(max(b["lengths"]), m["max_windows"]) for b in check.batches}
        chunks = _bucket_chunks(loader, m, seen, int(cfg.TRAIN.BATCH_SIZE))
        if chunks:
            train_epoch(Chunks(loader, chunks), state, spans, meter, 0, cfg, device)
    warm = int(t["warmup_steps"])
    train_epoch(Feed(loader, done, take=warm), state, spans, meter, 0, cfg, device)
    done += warm
    if trace:
        warm_profiler(cuda)
    _sync(cuda)
    run.mark("warm_up")

    spans.phase = "window"
    start_event = torch.cuda.Event(enable_timing=True) if cuda else None
    t0 = time.perf_counter()
    if cuda:
        start_event.record()
    deadline = t0 + seconds
    if trace:
        spans.profile = Profile(t0 + TRACE_AT * seconds, TRACE_STEPS["train"], cuda)
    epoch = 0
    error = None
    try:
        while True:
            train_epoch(Feed(loader, done, deadline=deadline), state, spans, meter, epoch, cfg,
                        device)
            if time.perf_counter() >= deadline:
                break
            epoch, done = epoch + 1, 0
            shuffle_dataset(loader, epoch)
            torch.manual_seed(sub_seed(drop_seed, epoch))
    except Exception as e:  # the window's failure, counted and reported
        error = e
        traceback.print_exc()
    finally:
        if spans.profile is not None:
            spans.profile.stop()
    peak = _close_window(run, spans, start_event, t0, device, cuda)
    setup_s = t0 - t_start
    losses = torch.stack(spans.outputs).float().cpu().numpy() if spans.outputs else np.zeros(0)
    failed = int((~np.isfinite(losses)).sum()) + (1 if error is not None else 0)
    attempted = len(run.window_calls) + (1 if error is not None else 0)
    samples = sum(spans.calls[i][3] for i in run.window_calls)
    loader.close()
    del model, state, store, loader, step, meter
    spans.fn = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, ctl = judge_train(check, w0, split, m, cfg, spec_seed, drop_seed, device, controls)
    return {"setup_s": setup_s, "samples": samples, "peak": peak, "attempted": attempted,
            "failed": failed, "checks": checks, "error": error, "info": ctl}


def _cpu(t):
    return t.detach().float().cpu()


def judge_train(check: TrainCheck, w0: dict, split, m: dict, cfg, spec_seed: int,
                drop_seed: int, device, controls: bool = False) -> tuple[dict, dict]:
    """The numbers compared: the step's inputs against the reference's own
    reading of the split (samples, valid counts, classes that differ), each
    step's loss, the first gradient as the optimizer got it, and each leaf's
    change over the steps, against the plain reference in float32."""
    sr = int(m["sampling_rate"])
    clip_size = int(round(sr * m["clip_s"]))
    bsz = int(cfg.TRAIN.BATCH_SIZE)
    rng_seed = int(cfg.RNG_SEED)
    ref_batches, mismatch = [], 0
    for k, got in enumerate(check.batches):
        rows = inputs.train_rows(len(split.start), bsz, rng_seed, 0, k)
        if m["gru_layers"]:
            wave, n_valid, lengths = inputs.chains(split, rows, m)
            b, nb = wave.shape[:2]
            ref = {"wave": wave.reshape(b * nb, -1), "n_valid": n_valid.reshape(-1),
                   "chains": (b, nb), "lengths": lengths}
            mismatch += int(list(got["lengths"]) != list(lengths))
        else:
            wave, n_valid = inputs.train_clips(split, rows, clip_size, rng_seed, 0)
            ref = {"wave": wave, "n_valid": n_valid}
        got_wave = got["wave"].numpy().reshape(ref["wave"].shape) \
            if got["wave"].numel() == ref["wave"].size else None
        if got_wave is None:
            mismatch += ref["wave"].size
        else:
            mismatch += int((got_wave != ref["wave"]).sum())
            mismatch += int((got["n_valid"].numpy().reshape(-1) != ref["n_valid"]).sum())
        mismatch += int((got["verb"].numpy() != split.verb[rows]).sum())
        mismatch += int((got["noun"].numpy() != split.noun[rows]).sum())
        ref.update(verb=torch.from_numpy(split.verb[rows]).to(device),
                   noun=torch.from_numpy(split.noun[rows]).to(device),
                   wave=torch.from_numpy(ref["wave"]).to(device),
                   n_valid=torch.from_numpy(ref["n_valid"]).to(device))
        ref_batches.append(ref)
    solver = _solver(cfg)
    reference = reference_train(w0, ref_batches, m, solver, spec_seed, drop_seed, device)
    program = {"losses": check.losses,
               "grads1": {n: b - solver_wd(n, solver) * _cpu(w0[n]) for n, b in check.bufs.items()},
               "params": check.params}
    checks = {"data_mismatch": float(mismatch), **compare_train(program, reference, w0)}
    ctl = {"worst_leaf": checks.pop("_worst")}
    if controls:
        for tag, kw in (("fp8", {"quant": ref_steps.fp8}), ("half_batch", {"half_batch": True})):
            placed = reference_train(w0, ref_batches, m, solver, spec_seed, drop_seed, device, **kw)
            ctl[tag] = compare_train(placed, reference, w0)
            ctl[tag + "_worst_leaf"] = ctl[tag].pop("_worst")
    return checks, ctl


def solver_wd(name: str, solver: dict) -> float:
    return solver["bn_weight_decay"] if "bn" in name else solver["weight_decay"]


def reference_train(w0: dict, batches: list, m: dict, solver: dict, spec_seed: int,
                    drop_seed: int, device, quant=None, half_batch: bool = False) -> dict:
    """The reference's steps in float32 (TF32 off), the head's dropout masks
    drawn as the program's step draws them (the default generator seeded with
    ``drop_seed``, one mask of the compute type a step, in order)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if m["compute_dtype"] == "bfloat16" else torch.float32

    def mask(shape):
        return F.dropout(torch.ones(shape, dtype=dtype, device=device), m["dropout"],
                         True).float()

    try:
        torch.manual_seed(drop_seed)
        w = {k: v.float() if v.is_floating_point() else v for k, v in w0.items()}
        out = ref_steps.train(w, batches, m, solver, spec_seed, mask, quant, half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"losses": out["losses"], "grads1": {k: _cpu(v) for k, v in out["grads1"].items()},
            "params": {k: _cpu(v) for k, v in out["params"].items()}}


def compare_train(program: dict, reference: dict, w0: dict) -> dict:
    """Loss: the largest relative gap of a step's loss. Gradient and change:
    for each of the optimizer's leaves, the gap between the program's norm and
    the reference's over the larger of the reference's norm of that leaf and
    of the median leaf, and the median of these over the leaves (the largest
    and other quantiles go to ``_worst``); the change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's.
    ``head_grad_diff``: over the output layer's weights, the largest norm of
    the first gradient's difference over the reference's norm; the loss
    reaches them through one product, before the backward's amplification
    through the trunk, so a rounding error shows there as itself.
    ``*_diff``: the median leaf's norm of the difference (reported)."""
    lp, lr = program["losses"], reference["losses"]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lp, lr))
    names = sorted(set(reference["grads1"]) & set(reference["params"]))  # the optimizer's
    # a leaf with no momentum buffer after the first step got no update from it
    gp = {n: float(program["grads1"][n].norm()) if n in program["grads1"] else 0.0
          for n in names}
    gr = {n: float(reference["grads1"][n].norm()) for n in names}
    med_g = float(np.median(list(gr.values())))
    grad = {n: abs(gp[n] - gr[n]) / max(gr[n], med_g) for n in names}
    moved = [n for n in names if gr[n] >= 1e-3 * med_g]
    cp = {n: float((program["params"][n].float() - _cpu(w0[n])).norm()) for n in moved}
    cr = {n: float((reference["params"][n] - _cpu(w0[n])).norm()) for n in moved}
    med_c = float(np.median(list(cr.values())))
    change = {n: abs(cp[n] - cr[n]) / max(cr[n], med_c) for n in moved}
    # the norm of the difference, which a rounding error moves where it
    # barely moves a norm, over the same denominators
    grad_d = {n: float((_g(program, n) - reference["grads1"][n]).norm()) / max(gr[n], med_g)
              for n in names}
    change_d = {n: float((program["params"][n].float() - reference["params"][n]).norm())
                / max(cr[n], med_c) for n in moved}

    def spread(gaps: dict) -> dict:
        v = np.asarray(list(gaps.values()))
        worst = max(gaps, key=gaps.get)
        return {"p10": float(np.quantile(v, 0.1)), "p25": float(np.quantile(v, 0.25)),
                "p75": float(np.quantile(v, 0.75)), "p90": float(np.quantile(v, 0.9)),
                "max": gaps[worst], "worst": worst}

    head = [n for n in names if n in slowfast.OUTPUT_LEAVES]
    head_d = max(float((_g(program, n) - reference["grads1"][n]).norm()) / gr[n] for n in head)
    return {"loss_gap": loss_gap, "grad_gap": float(np.median(list(grad.values()))),
            "change_gap": float(np.median(list(change.values()))), "head_grad_diff": head_d,
            "grad_diff": float(np.median(list(grad_d.values()))),
            "change_diff": float(np.median(list(change_d.values()))),
            "_worst": {"grad_gap": spread(grad), "change_gap": spread(change),
                       "grad_diff": spread(grad_d), "change_diff": spread(change_d)}}


def _g(program: dict, name: str) -> torch.Tensor:
    g = program["grads1"].get(name)
    return g.float() if g is not None else torch.zeros(())


def _test(cell, cfg, m, t, split, w0, seed, seconds, trace, device, cuda, run, t_start, faults,
          controls):
    from asf_tpu_torch.data.device_store import DeviceSegmentStore
    from asf_tpu_torch.data.loader import construct_loader
    from asf_tpu_torch.engine.meters import EPICTestMeter
    from asf_tpu_torch.engine.steps import make_eval_step
    from asf_tpu_torch.engine.test_loop import perform_test
    from asf_tpu_torch.models import build_model

    np.random.seed(cfg.RNG_SEED)
    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    model.load_state_dict(w0, strict=True)
    step = make_eval_step(cfg, device)
    if "eval_step" in faults:
        step = faults["eval_step"](step)
    loader = construct_loader(cfg, "test")
    store = DeviceSegmentStore.try_build(loader.dataset,
                                         int(cfg.GPU.TEST_DEVICE_CACHE_MB) << 20, device)
    if store is None:
        raise RuntimeError("the test split did not go into the device store")
    loader.attach_store(store)
    ds = loader.dataset
    views = ds._num_clips

    def new_meter():
        return EPICTestMeter(num_audios=len(ds) // views, num_clips=views,
                             num_cls=cfg.MODEL.NUM_CLASSES, overall_iters=len(loader),
                             ensemble_method=cfg.DATA.ENSEMBLE_METHOD, log_period=cfg.LOG_PERIOD)

    spans = Spans(step, "test", cuda)
    run.spans = spans
    warm = int(t["warmup_steps"])
    run.mark("build")
    perform_test(Feed(loader, 0, take=warm), model, spans, new_meter(), device)
    if trace:
        warm_profiler(cuda)
    _sync(cuda)
    run.mark("warm_up")
    spans.phase = "window"
    meter = new_meter()
    start_event = torch.cuda.Event(enable_timing=True) if cuda else None
    t0 = time.perf_counter()
    if cuda:
        start_event.record()
    deadline = t0 + seconds
    if trace:
        spans.profile = Profile(t0 + TRACE_AT * seconds, TRACE_STEPS["test"], cuda)
    error = None
    try:
        perform_test(Feed(loader, warm, deadline=deadline), model, spans, meter, device)
        while time.perf_counter() < deadline:
            perform_test(Feed(loader, 0, deadline=deadline), model, spans, new_meter(), device)
    except Exception as e:  # the window's failure, counted and reported
        error = e
        traceback.print_exc()
    finally:
        if spans.profile is not None:
            spans.profile.stop()
    peak = _close_window(run, spans, start_event, t0, device, cuda)
    setup_s = t0 - t_start
    samples = sum(spans.calls[i][2] for i in run.window_calls)
    scores = (meter.verb_preds, meter.noun_preds, meter.clip_count.copy())
    loader.close()
    del model, store, loader, step
    spans.fn = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, ctl = judge_test(scores, w0, split, m, views, seed, device, controls)
    failed = (1 if error is not None else 0)
    attempted = len(run.window_calls) + failed
    return {"setup_s": setup_s, "samples": samples, "peak": peak, "attempted": attempted,
            "failed": failed, "checks": checks, "error": error, "info": ctl}


def clip_gaps(got: dict, ref: dict) -> np.ndarray:
    """Each clip's largest gap of a class's ensembled score over its largest
    reference score, the larger of the two tasks."""
    return np.max([np.abs(got[t] - ref[t]).max(axis=1) / ref[t].max(axis=1)
                   for t in ("verb", "noun")], axis=0)


def clip_mean_gaps(got: dict, ref: dict) -> np.ndarray:
    """Each clip's mean gap of a class's ensembled score over its largest
    reference score, the larger of the two tasks."""
    return np.max([np.abs(got[t] - ref[t]).mean(axis=1) / ref[t].max(axis=1)
                   for t in ("verb", "noun")], axis=0)


def score_gap(got: dict, ref: dict) -> float:
    """The largest of ``clip_gaps`` over the clips."""
    return float(clip_gaps(got, ref).max())


def judge_test(scores, w0: dict, split, m: dict, views: int, seed: int, device,
               controls: bool = False) -> tuple[dict, dict]:
    """The ensembled verb and noun scores of a seeded sample of the clips
    whose every view the window scored, against the reference's: the widest
    gap over the sample (``score_gap``), the median clip's widest gap
    (``clip_gap_median``) and the mean clip's mean gap (``clip_mean_gap``)."""
    verb_p, noun_p, count = scores
    complete = np.flatnonzero(count == views)
    if len(complete) == 0:
        return {k: float("inf") for k in ("score_gap", "clip_gap_median", "clip_mean_gap")}, {}
    rng = np.random.default_rng([int(seed) % (2**63), 11])
    clips = np.sort(rng.choice(complete, size=min(TEST_SAMPLE_CLIPS, len(complete)),
                               replace=False))
    ref = reference_test(w0, split, m, views, clips, device)
    got = {"verb": verb_p[clips], "noun": noun_p[clips]}

    def stats(scores):
        return {"score_gap": score_gap(scores, ref),
                "clip_gap_median": float(np.median(clip_gaps(scores, ref))),
                "clip_mean_gap": float(np.mean(clip_mean_gaps(scores, ref)))}

    checks, ctl = stats(got), {}
    if controls:
        for tag, kw in (("fp8", {"quant": ref_steps.fp8}), ("shifted_answer", {"shift": 1})):
            ctl[tag] = stats(reference_test(w0, split, m, views, clips, device, **kw))
    return checks, ctl


def reference_test(w0: dict, split, m: dict, views: int, clips: np.ndarray, device,
                   quant=None, shift: int = 0) -> dict:
    """Each clip's views summed (``DATA.ENSEMBLE_METHOD`` sum) by the reference;
    ``shift`` (a planted fault) scores each view with the item ``shift``
    places on in its place."""
    clip_size = int(round(m["sampling_rate"] * m["clip_s"]))
    items = ((clips[:, None] * views + np.arange(views)[None, :]).reshape(-1) + shift) \
        % (len(split.start) * views)
    w = {k: v.float() if v.is_floating_point() else v for k, v in w0.items()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    outs = {"verb": [], "noun": []}
    try:
        for lo in range(0, len(items), REF_BLOCK):
            wave, n_valid = inputs.test_views(split, items[lo:lo + REF_BLOCK], views, clip_size)
            batch = {"wave": torch.from_numpy(wave).to(device),
                     "n_valid": torch.from_numpy(n_valid).to(device)}
            verb, noun = ref_steps.eval_scores(w, batch, m, quant)
            outs["verb"].append(verb.double().cpu().numpy())
            outs["noun"].append(noun.double().cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {k: np.concatenate(v).reshape(len(clips), views, -1).sum(axis=1)
            for k, v in outs.items()}
