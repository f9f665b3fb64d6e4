"""The port's training loop against the JAX package's: meters, checkpoints,
precise BN and ``train(cfg)`` itself.

``train(cfg)`` and ``asf_tpu.engine.train`` start from the same ``.pyth``
(``CHECKPOINT_EPOCH_RESET``) and train the tiny VGG-Sound SlowFast
(float32, the HIGHEST front end, K1 in interpret mode on the JAX side,
SpecAugment and dropout off, precise BN on) for one epoch of 3 steps, then
validate on 10 clips in batches of 4, 4 and 2. The JAX side runs with
``ASF_MAXPOOL_SAS_BWD=1``, as ``tests/test_torch_port_train.py`` explains,
and with TensorBoard and the val plots on, so that the port's observers are
held to its event files.
"""

import json
import logging
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from torch import nn

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.checkpoint.pyth_converter import flax_to_torch_state
from asf_tpu.engine import meters as jax_meters
from asf_tpu.engine import steps as jax_steps
from asf_tpu.engine import train as jax_train
from asf_tpu.engine import train_loop as jax_train_loop
from asf_tpu.parallel.mesh import make_mesh
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.checkpoint.pyth_names import load_into, torch_state_to_flax
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data import loader
from asf_tpu_torch.data import prefetch as prefetch_mod
from asf_tpu_torch.engine import meters, train
from asf_tpu_torch.engine import train_loop
from asf_tpu_torch.engine.steps import TrainState, init_state, make_train_step
from asf_tpu_torch.entry import train_entry
from asf_tpu_torch.models import build_model
from asf_tpu_torch.utils import misc
from test_torch_port_data import vgg_cfgs, vgg_root  # noqa: F401  (fixture)
from test_torch_port_entry import tiny

ROOT = Path(__file__).resolve().parents[1]
# Host timings and memory gauges differ from run to run; the rest of a record must agree.
_UNTIMED = {"dt", "dt_data", "dt_net", "eta", "RAM", "hbm", "gpu_mem"}


class _JsonStats(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.stats, self.warnings, self.messages = [], [], []

    def emit(self, record):
        msg = record.getMessage()
        self.messages.append(msg)
        if msg.startswith("json_stats: "):
            self.stats.append(json.loads(msg[len("json_stats: "):]))
        elif record.levelno >= logging.WARNING:
            self.warnings.append(msg)


@contextmanager
def captured(name):
    """The messages, ``json_stats`` records and warnings logged under ``name``."""
    log, handler = logging.getLogger(name), _JsonStats()
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def _untimed(records):
    return [{k: v for k, v in r.items() if k not in _UNTIMED} for r in records]


# One jitted ``model.init`` a model definition: the nodes of the config that
# ``asf_tpu/models`` reads, the model's class and dtype, and init's keywords.
_JITTED_INITS: dict = {}


def jitted_init(model, cfg, **kwargs):
    """``model.init`` as one compiled program, shared by every model of the
    same definition in this process (a train and a test of one config
    compile it once)."""
    nodes = tuple(cfg[k].dump() for k in ("MODEL", "RESNET", "SLOWFAST", "AUDIO_DATA", "BN"))
    key = (type(model), str(model.dtype), nodes, cfg.TPU.COMPUTE_DTYPE,
           tuple(sorted(kwargs.items())))
    if key not in _JITTED_INITS:
        _JITTED_INITS[key] = jax.jit(lambda *a: model.init(*a, **kwargs))
    return _JITTED_INITS[key]


def _jitted_init_state(cfg, model, tx, rng, example):
    """``asf_tpu.engine.steps.init_state`` with ``model.init`` compiled as
    one program (``jitted_init``): the same variables as its op-by-op eager
    init (35 s of compiles on this CPU for the GRU model, 8 s jitted), which
    the start ``.pyth`` then overwrites leaf for leaf."""

    class Jitted:
        @staticmethod
        def init(*args, **kwargs):
            return jitted_init(model, cfg, **kwargs)(*args)

    return jax_steps.init_state(cfg, Jitted(), tx, rng, example)


@pytest.fixture
def jitted_jax_init(monkeypatch):
    """The JAX train and test loops' ``init_state`` jitted (``_jitted_init_state``)."""
    from asf_tpu.engine import test_loop as jax_test_loop

    for mod in (jax_train_loop, jax_test_loop):
        monkeypatch.setattr(mod, "init_state", _jitted_init_state)


# --------------------------------------------------------------------------
# meters
# --------------------------------------------------------------------------

def _meter_cfgs():
    from asf_tpu.config import get_cfg as jax_get_cfg

    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.LOG_PERIOD = 2
        cfg.SOLVER.MAX_EPOCH = 3
    return jcfg, pcfg


def test_meters_log_the_jax_records():
    jcfg, pcfg = _meter_cfgs()
    rng = np.random.default_rng(0)
    updates = [(float(rng.uniform(0, 100)), float(rng.uniform(0, 50)), float(rng.uniform(0, 6)),
                float(rng.uniform(0, 0.1)), int(rng.integers(2, 9))) for _ in range(7)]
    out = {}
    for name, mod, cfg in (("asf_tpu", jax_meters, jcfg), ("asf_tpu_torch", meters, pcfg)):
        with captured(name) as log:
            train_m, val_m = mod.TrainMeter(7, cfg), mod.ValMeter(3, cfg)
            bests = []
            for epoch in range(3):
                train_m.iter_tic()
                for it, (top1, top5, loss, lr, rows) in enumerate(updates):
                    train_m.data_toc()
                    train_m.update_stats(top1 - 10 * epoch, top5, loss, lr, rows)
                    train_m.log_iter_stats(epoch, it)
                    train_m.iter_toc()
                    train_m.iter_tic()
                train_m.log_epoch_stats(epoch)
                train_m.reset()
                for it in range(3):  # epoch 1 is the best, epoch 2 ties it
                    val_m.update_stats([60.0, 40.0, 40.0][epoch] + it, 10.0 * it, 4)
                    val_m.log_iter_stats(epoch, it)
                bests.append(val_m.log_epoch_stats(epoch))
                val_m.reset()
        out[name] = (_untimed(log.stats), bests)
    (want, want_best), (got, got_best) = out["asf_tpu"], out["asf_tpu_torch"]
    assert len(got) == len(want) == 3 * (3 + 1 + 1 + 1)
    assert got == want
    assert got_best == want_best and [b for b, _ in got_best] == [True, True, False]
    train_iter = [r for r in got if r["_type"] == "train_iter"]
    assert {"loss", "lr", "top1_err", "top5_err", "iter"} <= set(train_iter[0])


def test_meter_times_and_memory_gauges():
    """A record logged after its iteration carries the times taken at its
    ``iter_toc``, not those of the timers still running."""
    _, pcfg = _meter_cfgs()
    m = meters.TrainMeter(2, pcfg)
    m.iter_tic()
    time.sleep(0.02)
    m.data_toc()
    m.iter_toc()
    times = m.iter_times()
    assert times[0] >= times[1] >= 0.02 and times[2] >= 0
    m.iter_tic()
    time.sleep(0.05)
    m.update_stats(10.0, 5.0, 1.0, 0.1, 4)
    with captured("asf_tpu_torch") as log:
        m.log_iter_stats(0, 1, times)
    (rec,) = log.stats
    assert (rec["dt"], rec["dt_data"]) == tuple(float(f"{t:.5f}") for t in times[:2])
    gauges = meters.mem_stats()
    used, total = (float(x) for x in gauges["RAM"].split()[0].split("/"))
    assert 0 < used < total


def test_model_info_counts_the_jax_parameters():
    from asf_tpu.utils.misc import params_count as jax_params_count

    model = build_model(tiny(get_cfg()), "cpu")
    variables = torch_state_to_flax(model.state_dict())
    assert misc.params_count(model) == jax_params_count(variables["params"]) > 0
    assert misc.buffers_count(model) == jax_params_count(variables["batch_stats"]) > 0
    with captured("asf_tpu_torch") as log:
        misc.log_model_info(model)
    assert f"Params: {misc.params_count(model):,}" in log.messages


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _mini_state(val: float) -> TrainState:
    model = nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.fill_(val)
    return TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                      generator=torch.Generator().manual_seed(0))


def test_get_last_checkpoint_ordering(tmp_path):
    cfg = get_cfg()
    out = str(tmp_path / "job")
    assert cu.get_last_checkpoint(out) is None and not cu.has_checkpoint(out)
    cu.save_checkpoint(out, _mini_state(1.0), 0, cfg)
    cu.save_checkpoint(out, _mini_state(2.0), 3, cfg)
    cu.save_checkpoint(out, _mini_state(3.0), 1, cfg, name="checkpoint_best")
    last = cu.get_last_checkpoint(out)
    assert last is not None and last.endswith("checkpoint_epoch_00004.pyth")  # epoch + 1
    cfg.SOLVER.MAX_EPOCH, cfg.TRAIN.CHECKPOINT_PERIOD = 7, 3
    assert [cu.is_checkpoint_epoch(cfg, e) for e in range(7)] == \
        [False, False, True, False, False, True, True]


def test_test_checkpoint_precedence(tmp_path):
    cfg = get_cfg()
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    path_a = cu.save_checkpoint(out_a, _mini_state(5.0), 0, cfg)
    cu.save_checkpoint(out_b, _mini_state(7.0), 0, cfg)

    def loaded():
        state = _mini_state(0.25)
        cu.load_test_checkpoint(cfg, state.model)
        return state.model.weight[0, 0].item()

    cfg.TEST.CHECKPOINT_FILE_PATH, cfg.OUTPUT_DIR = path_a, out_b
    assert loaded() == 5.0  # 1) TEST.CHECKPOINT_FILE_PATH first
    cfg.TEST.CHECKPOINT_FILE_PATH = ""
    assert loaded() == 7.0  # 2) then the last checkpoint in OUTPUT_DIR
    cfg.OUTPUT_DIR, cfg.TRAIN.CHECKPOINT_FILE_PATH = str(tmp_path / "empty"), path_a
    assert loaded() == 5.0  # 3) then TRAIN.CHECKPOINT_FILE_PATH
    cfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    assert loaded() == 0.25  # 4) then the weights as they are


def _tiny_train_state(seed):
    pcfg = tiny(get_cfg())
    pcfg.GPU.COMPUTE_DTYPE = "float32"
    step, (state, example) = train_entry(batch=2, dsp_precision="HIGHEST", device="cpu", cfg=pcfg)
    state.model.load_state_dict(build_model(pcfg, "cpu", torch.Generator().manual_seed(seed))
                                .state_dict())
    return pcfg, step, state, example


def test_save_then_load_restores_the_train_state(tmp_path):
    """Model, momentum buffers, step, epoch and SpecAugment's generator come
    back; the next step of the loaded state equals the saved state's."""
    pcfg, step, state, example = _tiny_train_state(1)
    for lr in (0.05, 0.04):
        step(state, example, lr)
    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    cu.save_checkpoint(cfg.OUTPUT_DIR, state, 4, cfg)

    _, _, fresh, _ = _tiny_train_state(2)
    assert cu.load_train_checkpoint(cfg, fresh) == 5
    assert fresh.step == state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for p, q in zip(state.optimizer.param_groups[0]["params"],
                    fresh.optimizer.param_groups[0]["params"]):
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        assert a.keys() == b.keys() and a
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    step(state, example, 0.03)
    step(fresh, example, 0.03)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k

    cfg.TRAIN.AUTO_RESUME = False  # the same file through CHECKPOINT_FILE_PATH
    cfg.TRAIN.CHECKPOINT_FILE_PATH = cu.get_last_checkpoint(cfg.OUTPUT_DIR)
    _, _, other, _ = _tiny_train_state(3)
    assert cu.load_train_checkpoint(cfg, other) == 5 and other.step == 2
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    _, _, other, _ = _tiny_train_state(3)
    assert cu.load_train_checkpoint(cfg, other) == 0 and other.step == 0
    assert not other.optimizer.state  # fresh moments


def test_pyth_names_map_is_the_jax_one():
    """The port's copy of ``torch_state_to_flax`` gives the JAX package's tree."""
    from asf_tpu.checkpoint.pyth_converter import torch_state_to_flax as jax_map

    sd = build_model(tiny(get_cfg()), "cpu").state_dict()
    sd["extra.weight"] = torch.zeros(2, 2, 2)  # a 3-D weight has no place
    got, want = torch_state_to_flax(sd, ("s1.",)), jax_map(sd, ("s1.",))
    assert got["_skipped_keys"] == want["_skipped_keys"] == ["extra.weight"]
    flat = jax.tree_util.tree_leaves_with_path
    gl, wl = flat({k: got[k] for k in ("params", "batch_stats")}), \
        flat({k: want[k] for k in ("params", "batch_stats")})
    assert [p for p, _ in gl] == [p for p, _ in wl]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(gl, wl))


# --------------------------------------------------------------------------
# precise BN and train(cfg)
# --------------------------------------------------------------------------

def _model_cfg(cfg, jax_side):
    cfg.MODEL.MODEL_NAME = "AudioSlowFast"
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = [6]
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.RESNET.DEPTH = 26
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.RESNET.FREQUENCY_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.FREQUENCY_DILATIONS = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.SLOWFAST.ALPHA = 4
    cfg.AUDIO_DATA.N_FFT = 256
    cfg.AUDIO_DATA.NUM_FRAMES = 64
    cfg.AUDIO_DATA.NUM_FREQUENCIES = 32
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    if jax_side:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.DSP_PRECISION = "HIGHEST"
        cfg.TPU.USE_PALLAS_DSP = True  # K1 in interpret mode
        cfg.TPU.SPEC_AUGMENT = False
        cfg.TPU.DATA_PARALLEL = 1
        cfg.TPU.STEPS_PER_DISPATCH = 1
        cfg.TPU.TRAIN_DEVICE_CACHE_MB = 0
        cfg.TPU.VAL_DEVICE_CACHE_MB = 0
        cfg.TPU.WARM_COMPILE_ON_START = False
        cfg.TPU.AUTO_WARM_ON_COLD_CACHE = False
        cfg.TENSORBOARD.ENABLE = False
    else:
        cfg.GPU.COMPUTE_DTYPE = "float32"
        cfg.GPU.DSP_PRECISION = "HIGHEST"
        cfg.GPU.SPEC_AUGMENT = False
    return cfg


def _train_cfgs(root, out):
    """(JAX cfg, port cfg): 15 train clips (3 steps of 4), 10 val (4, 4, 2)."""
    jcfg, pcfg = vgg_cfgs(root)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
    return jcfg, pcfg


@pytest.fixture(scope="module")
def start_pyth(tmp_path_factory):
    """The shared start: the port's seeded initial weights as a reference ``.pyth``."""
    cfg = _model_cfg(get_cfg(), False)
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(5)).state_dict()
    path = str(tmp_path_factory.mktemp("start") / "start.pyth")
    torch.save({"model_state": sd, "epoch": 9}, path)
    return path


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_precise_bn_matches_jax(vgg_root, start_pyth, tmp_path):  # noqa: F811
    jcfg, pcfg = _train_cfgs(vgg_root, str(tmp_path))
    ld = loader.construct_loader(pcfg, "train")
    try:
        batches = list(ld)
    finally:
        ld.close()
    for b in batches:
        b.pop("metadata")

    model = build_model(pcfg, "cpu")
    model.load_state_dict(torch.load(start_pyth)["model_state"])
    variables = jax.tree.map(np.asarray, {k: v for k, v in torch_state_to_flax(
        model.state_dict()).items() if k in ("params", "batch_stats")})
    jstate = jax_steps.TrainState(params=variables["params"],
                                  batch_stats=variables["batch_stats"], opt_state=None,
                                  step=jnp.zeros((), jnp.int32))

    class _Loader(list):
        batch_size = 4

    jnew = jax_train_loop.precise_bn(jcfg, jstate, _Loader(batches), make_mesh(jcfg), 2)
    pstate = TrainState(model=model, optimizer=None, generator=None)
    train_loop.precise_bn(pcfg, pstate, batches, make_train_step(pcfg, "cpu").pipeline, "cpu", 2)
    want = flax_variables_to_torch_state({"batch_stats": jax.tree.map(np.asarray,
                                                                      jnew.batch_stats)})
    got = model.state_dict()
    n = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel_l2(got[k], w) <= 1e-5, (k, _rel_l2(got[k], w))
            n += 1
    assert n == 2 * sum(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    assert all(m.momentum == 0.1 for m in model.modules() if isinstance(m, nn.BatchNorm2d))


def _observed(cfg, root):
    """TensorBoard on, with the val confusion matrix and top-k histograms
    under the class names of ``root/class_names.json``."""
    names = os.path.join(root, "class_names.json")
    with open(names, "w") as f:
        json.dump({f"class{i}": i for i in range(6)}, f)
    cfg.TENSORBOARD.ENABLE = True
    cfg.TENSORBOARD.CLASS_NAMES_PATH = names
    cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
    cfg.TENSORBOARD.HISTOGRAM.ENABLE = True
    cfg.TENSORBOARD.HISTOGRAM.TOPK = 3
    return cfg


def _scalars(log_dir):
    """{tag: [(step, value)]} of the event files in ``log_dir``."""
    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _images(log_dir):
    acc = EventAccumulator(log_dir, size_guidance={"images": 0})
    acc.Reload()
    return {tag: [e.step for e in acc.Images(tag)] for tag in acc.Tags()["images"]}


@pytest.fixture(scope="module")
def jax_run(vgg_root, start_pyth, tmp_path_factory):  # noqa: F811
    """``asf_tpu.engine.train`` from ``start.pyth``, with TensorBoard and the
    val plots on (``_observed``): its cfg, the variables of its last
    checkpoint (Orbax) and its ``json_stats`` records."""
    root = str(tmp_path_factory.mktemp("jax_run"))
    jcfg, _ = _train_cfgs(vgg_root, root)
    jcfg.TRAIN.CHECKPOINT_FILE_PATH = start_pyth
    jcfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    _observed(jcfg, root)
    with pytest.MonkeyPatch.context() as mp, captured("asf_tpu") as log:
        mp.setenv("ASF_MAXPOOL_SAS_BWD", "1")  # see the module docstring
        jax_train(jcfg)
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    assert int(payload["step"]) == 3
    return jcfg, jax.tree.map(np.asarray, payload["model_state"]), log.stats


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


def test_train_matches_jax_train(vgg_root, start_pyth, jax_run, tmp_path):  # noqa: F811
    _, pcfg = _train_cfgs(vgg_root, str(tmp_path))
    pcfg.TRAIN.CHECKPOINT_FILE_PATH = start_pyth
    pcfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    with captured("asf_tpu_torch") as plog:
        state = train(pcfg, device="cpu")
    assert state.step == 3
    _, variables, jstats = jax_run

    # 3.7e-5 read at the worst leaf (s2's fast-pathway b_bn bias)
    want = flax_variables_to_torch_state(variables)
    got = state.model.state_dict()
    assert set(got) == set(want)
    start = torch.load(start_pyth)["model_state"]
    worst = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        worst[k] = _rel_l2(got[k], w)
        assert not torch.equal(got[k], start[k]), k  # every parameter and statistic moved
    assert max(worst.values()) <= 1e-4, max(worst.items(), key=lambda kv: kv[1])

    (jep,), (pep,) = _records(jstats, "train_epoch"), _records(plog.stats, "train_epoch")
    assert abs(pep["loss"] - jep["loss"]) <= 1e-4
    (jval,), (pval,) = _records(jstats, "val_epoch"), _records(plog.stats, "val_epoch")
    for k in ("top1_err", "top5_err", "min_top1_err"):
        assert pval[k] == jval[k], (k, pval[k], jval[k])
    for kind in ("train_iter", "val_iter"):
        assert len(_records(plog.stats, kind)) == len(_records(jstats, kind)) == 3
    for name in ("checkpoint_epoch_00001.pyth", "checkpoint_best.pyth"):
        assert os.path.exists(os.path.join(pcfg.OUTPUT_DIR, "checkpoints", name))


LOSS_TOL = 1e-4  # Train/loss against the JAX run: test_train_matches_jax_train's bound
NORM_TOL = 1e-4  # Train/grad_norm and Train/param_norm, relative: the same 3 steps


def test_train_logs_the_jax_scalars_plots_histograms_and_a_trace(
        vgg_root, start_pyth, jax_run, tmp_path, monkeypatch):  # noqa: F811
    """``train(cfg)`` with TensorBoard and a stand-in W&B against the JAX
    run's event files: ``Train/*`` at iterations 0-2 (``LOG_PERIOD`` 1) and
    ``Val/top1_acc`` at step 3, the same tags and steps, ``Train/loss``
    within LOSS_TOL, the norms within NORM_TOL, ``Train/lr`` and ``Val/*``
    equal; the same val figures at step 0 (the epoch); the watch histograms
    at steps 0-2, named by the JAX tree, each leaf's counts summing to its
    size; and a Chrome trace of iteration 1 in ``GPU.PROFILE_DIR``."""
    from chip_smoke import WandbStandIn

    wandb = WandbStandIn()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    _, pcfg = _train_cfgs(vgg_root, str(tmp_path))
    _observed(pcfg, str(tmp_path))
    pcfg.TRAIN.CHECKPOINT_FILE_PATH = start_pyth
    pcfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    pcfg.WANDB.ENABLE = True
    pcfg.GPU.PROFILE_DIR = str(tmp_path / "profile")
    pcfg.GPU.PROFILE_START_ITER = 1
    pcfg.GPU.PROFILE_NUM_ITERS = 1
    with captured("asf_tpu_torch") as log:
        state = train(pcfg, device="cpu")
    assert not [w for w in log.warnings if "disabled" in w or "not ported" in w], log.warnings
    jcfg = jax_run[0]
    jax_dir = os.path.join(jcfg.OUTPUT_DIR, "runs-Vggsound")
    port_dir = os.path.join(pcfg.OUTPUT_DIR, "runs-Vggsound")

    want, got = _scalars(jax_dir), _scalars(port_dir)
    assert set(got) == set(want) == {"Train/loss", "Train/grad_norm", "Train/param_norm",
                                     "Train/lr", "Val/top1_acc"}
    for tag, series in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in series], tag
    assert [s for s, _ in got["Train/loss"]] == [0, 1, 2] and got["Val/top1_acc"][0][0] == 3
    for (_, g), (_, w) in zip(got["Train/loss"], want["Train/loss"]):
        assert abs(g - w) <= LOSS_TOL, (g, w)
    for tag in ("Train/grad_norm", "Train/param_norm"):
        for (_, g), (_, w) in zip(got[tag], want[tag]):
            assert abs(g - w) <= NORM_TOL * abs(w), (tag, g, w)
    assert got["Train/lr"] == want["Train/lr"] and got["Val/top1_acc"] == want["Val/top1_acc"]
    images = _images(port_dir)
    assert images == _images(jax_dir)
    assert "Confusion Matrix" in images and "Val/topk_hist/class0" in images

    hist_logs = [(payload, step) for kind, *rest in wandb.calls if kind == "log"
                 for payload, step in [rest] if any(k.startswith("gradients/") for k in payload)]
    assert [step for _, step in hist_logs] == [0, 1, 2]
    sd = state.model.state_dict()
    tree = torch_state_to_flax({k: v.numpy() for k, v in sd.items()})["params"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sizes = {jax_steps._watch_name(p): int(np.prod(np.shape(leaf))) for p, leaf in flat}
    for payload, _ in hist_logs:
        assert set(payload) == {f"{kind}/{p}" for kind in ("parameters", "gradients")
                                for p in sizes}
        for name, hist in payload.items():
            counts, edges = hist.np_histogram
            assert counts.sum() == sizes[name.split("/", 1)[1]] and len(edges) == 65

    traces = os.listdir(pcfg.GPU.PROFILE_DIR)
    assert traces == ["train_trace_iters_1-1.json"]
    with open(os.path.join(pcfg.GPU.PROFILE_DIR, traces[0])) as f:
        assert json.load(f)["traceEvents"]


def test_reference_pyth_loads_into_the_port(vgg_root, jax_run, tmp_path):  # noqa: F811
    """A reference-named ``.pyth`` (the JAX package's ``flax_to_torch_state``
    of the JAX run's variables, names under ``module.``) loads through
    ``CHECKPOINT_CLEAR_NAME_PATTERN``; the port's eval forward on the JAX
    pipeline's spectrograms is within 1e-5 of the JAX model's. A head of
    another class count is skipped with a warning, the rest still loads."""
    from asf_tpu.engine.steps import make_input_pipeline
    from asf_tpu.models import build_model as jax_build_model

    jcfg, variables, _ = jax_run
    _, pcfg = _train_cfgs(vgg_root, str(tmp_path))
    sd = {f"module.{k}": torch.tensor(v) for k, v in flax_to_torch_state(variables).items()}
    path = str(tmp_path / "ref.pyth")
    torch.save({"model_state": sd, "epoch": 4}, path)

    pcfg.TRAIN.CHECKPOINT_FILE_PATH = path
    pcfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ("module.",)
    model = build_model(pcfg, "cpu")
    state = init_state(pcfg, model)
    with captured("asf_tpu_torch") as log:
        assert cu.load_train_checkpoint(pcfg, state) == 5 and state.step == 0
    assert not log.warnings
    want = flax_variables_to_torch_state(variables)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k

    s = int(round(jcfg.AUDIO_DATA.SAMPLING_RATE * jcfg.AUDIO_DATA.CLIP_SECS)) - 1
    wave = (np.random.default_rng(8).standard_normal((3, s)) * 0.1).astype(np.float32)
    paths = make_input_pipeline(jcfg)(jnp.asarray(wave), jnp.full((3,), s, jnp.int32), None)
    jmodel = jax_build_model(jcfg)
    jprobs = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, paths))
    with torch.inference_mode():
        probs = model.eval()([torch.tensor(np.asarray(p)).permute(0, 3, 1, 2)
                              for p in paths]).numpy()
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)

    head = {k: (torch.zeros(7, *v.shape[1:]) if "head.projection" in k else v)
            for k, v in sd.items()}
    other = build_model(pcfg, "cpu")
    before = other.head.projection.weight.clone()
    with captured("asf_tpu_torch") as log:
        skipped = load_into(other, head, ("module.",))
    assert sorted(name for name, *_ in skipped) == ["head.projection.bias",
                                                     "head.projection.kernel"]
    assert len(log.warnings) == 2 and all("head.projection" in w for w in log.warnings)
    assert torch.equal(other.head.projection.weight, before)
    assert torch.equal(other.s1.pathway0_stem.conv.weight, model.s1.pathway0_stem.conv.weight)


def test_resumed_run_equals_the_straight_one(vgg_root, tmp_path):  # noqa: F811
    """SpecAugment and dropout on: two epochs straight, and one epoch then an
    auto-resumed second, end on the same parameters, statistics and step.
    The LR steps at epoch 1 and does not depend on MAX_EPOCH."""
    runs = {}
    for name, epochs in (("straight", (2,)), ("resumed", (1, 2))):
        _, cfg = _train_cfgs(vgg_root, str(tmp_path / name))
        cfg.GPU.SPEC_AUGMENT = True
        cfg.MODEL.DROPOUT_RATE = 0.5
        cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
        cfg.SOLVER.STEPS, cfg.SOLVER.LRS = [0, 1], [1.0, 0.1]
        for max_epoch in epochs:
            cfg.SOLVER.MAX_EPOCH = max_epoch
            runs[name] = train(cfg, device="cpu")
    a, b = runs["straight"], runs["resumed"]
    assert a.step == b.step == 6
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_train_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_cfg())


def test_train_raises_with_more_than_one_shard():
    """More than one shard (or device) is a process group that ``run_net``
    starts: without one, ``train(cfg)`` raises and names it, before it
    builds or reads anything."""
    cfg = get_cfg()
    cfg.NUM_SHARDS = 2
    with pytest.raises(RuntimeError, match="NUM_SHARDS = 2.*run_net"):
        train(cfg, device="cpu")


class _SlowLoader:
    """Batches of 2 clips, the ``i``-th delayed by ``waits[i]`` seconds."""

    def __init__(self, waits):
        self.waits = waits

    def __len__(self):
        return len(self.waits)

    def __iter__(self):
        for w in self.waits:
            time.sleep(w)
            yield {"waveform": np.zeros((2, 8), np.float32)}


def test_train_epoch_logs_each_iteration_its_own_times(monkeypatch):
    """Iterations that wait for data alternate with iterations whose step is
    slow: a record that carried another iteration's times would miss the
    wait or the step of its own."""
    cfg = get_cfg()
    cfg.LOG_PERIOD = 1
    cfg.SOLVER.MAX_EPOCH = 1
    monkeypatch.setattr(prefetch_mod, "DEPTH", 0)  # each batch's delay is the loop's data wait
    waits, steps = [0.15, 0.0, 0.15, 0.0], [0.0, 0.15, 0.0, 0.15]
    calls = iter(steps)

    def step(state, batch, lr):
        time.sleep(next(calls))
        one = torch.ones(())
        return {"loss": one}, {"top1_err": one, "top5_err": one}

    meter = meters.TrainMeter(len(waits), cfg)
    with captured("asf_tpu_torch") as log:
        train_loop.train_epoch(_SlowLoader(waits), None, step, meter, 0, cfg, "cpu")
    iters = [r for r in log.stats if r["_type"] == "train_iter"]
    assert [r["iter"] for r in iters] == ["1/4", "2/4", "3/4", "4/4"]
    for r, wait, slow in zip(iters, waits, steps):
        assert r["dt_data"] >= wait - 1e-3 and r["dt_net"] >= slow - 1e-3, r
        assert r["dt"] >= 0.15 - 1e-3, r
    assert [r["dt_data"] > r["dt_net"] for r in iters] == [True, False, True, False]


_NO_FOREIGN_IMPORTS = """
import os, pickle, sys
import numpy as np
from scipy.io import wavfile
sys.path.insert(0, {root!r})
import chip_smoke  # noqa: F401
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.engine import test, train
from asf_tpu_torch.tools import run_net
root = {data!r}
rows = []
for i in range(8):
    wavfile.write(os.path.join(root, f"c{{i}}.wav"), 8000,
                  (np.random.default_rng(i).standard_normal(4000) * 3000).astype(np.int16))
    rows.append({{"video": f"c{{i}}.mp4", "class_id": i % 6}})
pickle.dump(rows, open(os.path.join(root, "a.pkl"), "wb"))
cfg = get_cfg()
for k, v in {cfg!r}.items():
    node = cfg
    *path, leaf = k.split(".")
    for p in path:
        node = node[p]
    node[leaf] = v
train(cfg, device="cpu")
test(cfg, device="cpu")
with open(os.path.join(root, "run.yaml"), "w") as f:
    f.write(cfg.dump())
run_net.main(["--cfg", os.path.join(root, "run.yaml"), "--device", "cpu",
              "TRAIN.ENABLE", "False", "TEST.SAVE_RESULTS_PATH", "cli.pkl"])
# EPIC-KITCHENS from an HDF5 archive, written and read by the port alone
from asf_tpu_torch.data.hdf5 import Writer
with Writer(os.path.join(root, "EPIC_audio.hdf5")) as w:
    for v in range(2):
        w.add(f"P01_{{v:02d}}", (np.random.default_rng(v).standard_normal(16000) * 3000
                                ).astype(np.int16), 4000)
rows = [{{"narration_id": f"P01_{{i:03d}}", "participant_id": "P01",
         "video_id": f"P01_{{i % 2:02d}}", "start_timestamp": f"00:00:0{{0.1 + 0.2 * i:.2f}}",
         "stop_timestamp": f"00:00:0{{0.6 + 0.2 * i:.2f}}", "verb_class": i % 6,
         "noun_class": i % 8}} for i in range(8)]
pickle.dump(rows, open(os.path.join(root, "e.pkl"), "wb"))
cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchens"
cfg.EPICKITCHENS.AUDIO_DATA_FILE = os.path.join(root, "EPIC_audio.hdf5")
cfg.EPICKITCHENS.ANNOTATIONS_DIR = root
for key in ("PROCESSED_TRAIN_LIST", "PROCESSED_VAL_LIST", "PROCESSED_TEST_LIST"):
    cfg.EPICKITCHENS[key] = "e.pkl"
cfg.MODEL.NUM_CLASSES = [6, 8]
cfg.MODEL.ONLY_ACTION_RECOGNITION = True
cfg.OUTPUT_DIR = os.path.join(root, "epic")
train(cfg, device="cpu")
print(sorted(m for m in ("jax", "pandas", "yaml", "h5py", "sklearn", "asf_tpu")
             if m in sys.modules))
"""


def test_train_path_imports_no_jax_pandas_yaml_or_h5py(tmp_path):
    """``train(cfg)`` on list-of-dicts annotations with 2 loader workers, then
    ``test(cfg)``, then the ``run_net`` CLI testing from a YAML file, then an
    EPIC ``train(cfg)`` from an HDF5 archive the port wrote, with
    ``chip_smoke`` imported, in a fresh interpreter: none of the modules the
    card's machine lacks (jax, pandas, yaml, h5py, sklearn) is loaded."""
    pcfg = _model_cfg(get_cfg(), False)
    keys = {"MODEL.NUM_CLASSES": [6], "RESNET.DEPTH": 26, "RESNET.WIDTH_PER_GROUP": 8,
            "RESNET.NUM_BLOCK_TEMP_KERNEL": pcfg.RESNET.NUM_BLOCK_TEMP_KERNEL,
            "RESNET.FREQUENCY_STRIDES": pcfg.RESNET.FREQUENCY_STRIDES,
            "RESNET.FREQUENCY_DILATIONS": pcfg.RESNET.FREQUENCY_DILATIONS,
            "MODEL.MODEL_NAME": "AudioSlowFast", "SLOWFAST.ALPHA": 4,
            "AUDIO_DATA.SAMPLING_RATE": 8000, "AUDIO_DATA.CLIP_SECS": 0.32,
            "AUDIO_DATA.N_FFT": 256, "AUDIO_DATA.NUM_FRAMES": 64,
            "AUDIO_DATA.NUM_FREQUENCIES": 32, "TRAIN.BATCH_SIZE": 4, "SOLVER.MAX_EPOCH": 1,
            "BN.USE_PRECISE_STATS": True, "BN.NUM_BATCHES_PRECISE": 1,
            "VGGSOUND.AUDIO_DATA_DIR": str(tmp_path), "VGGSOUND.ANNOTATIONS_DIR": str(tmp_path),
            "VGGSOUND.TRAIN_LIST": "a.pkl", "VGGSOUND.VAL_LIST": "a.pkl",
            "VGGSOUND.TEST_LIST": "a.pkl", "TEST.NUM_ENSEMBLE_VIEWS": 2,
            "OUTPUT_DIR": str(tmp_path / "out"), "LOG_MODEL_INFO": False,
            "GPU.COMPUTE_DTYPE": "float32", "DATA_LOADER.NUM_WORKERS": 2}
    code = _NO_FOREIGN_IMPORTS.format(root=str(ROOT), data=str(tmp_path), cfg=keys)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    assert os.path.exists(tmp_path / "out" / "checkpoints" / "checkpoint_epoch_00001.pyth")
    for name in ("test_scores.pkl", "cli.pkl"):
        assert os.path.exists(tmp_path / "out" / "scores" / name)
    assert os.path.exists(tmp_path / "epic" / "checkpoints" / "checkpoint_epoch_00001.pyth")
