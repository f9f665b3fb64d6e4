"""Tensor parallelism of the port (``GPU.MODEL_PARALLEL``) on gloo ranks on the CPU, against ``asf_tpu``.

* The shard rule: at the flagship's and ``epic_cfg``'s widths and mp = 2,
  ``parallel/tensor.py`` shards the leaves that
  ``asf_tpu.parallel.mesh.param_shardings`` places on ``model`` (leaf
  shapes from ``jax.eval_shape`` of the JAX model's init, no compile),
  matched by name through the converter.
* On a 2 x 2 grid of 4 spawned ranks (``NUM_GPUS 2``, ``GPU.MODEL_PARALLEL
  2``; ``run_net.run_rank``): the two autograd Functions, forward and
  backward of a sharded conv, grouped conv and linear in float64 against the
  unsharded layers (1e-12); ``batchnorm`` and ``sync_batchnorm`` (k = 2 and
  1 data ranks) against ``asf_tpu.models.norm.TorchBatchNorm`` over the
  data ranks' rows (1e-5), equal on the ranks of a model group; the same
  world read at ``GPU.MODEL_PARALLEL`` 1 (PR 11's data parallelism: no
  shard, the world as the data group); one train step of the tiny_cfg
  model (``tests/fixtures.py``: depth 26, width 64) against one process's
  (``grad_norm`` and ``param_norm`` within 1e-4, every leaf after the step,
  the watch histograms' counts summing to each leaf's size); and
  ``train(cfg)`` with the head's dropout on: one mask a model group, each
  rank holding half of every sharded leaf and of its momentum, its
  ``.pyth`` loading strictly into one process's model.
* ``run_net --device cpu ... NUM_GPUS 2 GPU.MODEL_PARALLEL 2``: ``train(cfg)``
  of the tiny_cfg model on the EPIC set of ``test_torch_port_epic.py`` (one
  epoch of 4 steps of 4 clips, BN frozen as the EPIC configs have it,
  precise BN over 2 batches, val in 4, 4 and 2), against
  ``asf_tpu.engine.train`` at ``TPU.DATA_PARALLEL 2``, ``TPU.MODEL_PARALLEL
  2`` on 4 of the tests' 8 virtual devices (the configuration of
  ``tests/test_e2e.py:test_train_tensor_parallel_mesh``) from the same
  ``.pyth``: every leaf within 1e-4 relative L2, the epoch loss within
  1e-4, the val errors equal, one ``.pyth`` that loads strictly into one
  process's model; then ``test(cfg)`` of 6 clips in 3 views against
  ``asf_tpu.engine.test`` on the same grid (scores within 1e-5) and against
  one process of the port (1e-6), one pickle.

The JAX side runs its plain log-mel (``USE_PALLAS_DSP`` off), as the
port's CPU tensors do, ``ASF_MAXPOOL_SAS_BWD=1``
(``test_torch_port_train.py``) and its model init jitted
(``test_torch_port_state.py:_jitted_init_state``).
"""

import functools
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.engine import test as jax_test
from asf_tpu.engine import test_loop as jax_test_loop
from asf_tpu.engine import train as jax_train
from asf_tpu.engine import train_loop as jax_train_loop
from asf_tpu.models import build_model as jax_build_model
from asf_tpu.models.norm import TorchBatchNorm
from asf_tpu.parallel.mesh import make_mesh, param_shardings
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine.optimizer import is_frozen_bn_param
from asf_tpu_torch.engine.steps import init_state, watch_name
from asf_tpu_torch.entry import epic_cfg, flagship_cfg
from asf_tpu_torch.models import build_model
from asf_tpu_torch.parallel import tensor
from asf_tpu_torch.tools import run_net, verify_release_ckpt
from test_torch_port_epic import CLASSES, epic_cfgs
from test_torch_port_epic import epic_root  # noqa: F401  (fixture)
from test_torch_port_loop import _model_cfg, _rel_l2, captured
from test_torch_port_state import _jitted_init_state, _start_pyth
from torch_dist_ranks import (C, GRID_BN_CASES, ROWS, bn_inputs, bn_params, free_port,
                              grid_rank, grid_step, tp_forward, tp_layers)

DATA, MP = 2, 2
WORLD = DATA * MP
LEAF_TOL, LOSS_TOL, STEP_TOL = 1e-4, 1e-4, 1e-4
SCORE_TOL, JAX_SCORE_TOL = 1e-6, 1e-5  # test scores: against one process; against asf_tpu
FN_TOL, BN_TOL = 1e-12, 1e-5


# --------------------------------------------------------------------------
# the shard rule against param_shardings
# --------------------------------------------------------------------------

def _jax_twin(pcfg):
    """The JAX package's config of the port's ``pcfg`` model."""
    jcfg = jax_get_cfg()
    for node in ("MODEL", "RESNET", "SLOWFAST", "AUDIO_DATA"):
        for k, v in pcfg[node].items():
            if k in jcfg[node]:
                jcfg[node][k] = v
    return jcfg


@pytest.mark.parametrize("name,make,want", [("flagship", flagship_cfg, 43),
                                            ("epic", epic_cfg, 44)])
def test_the_port_shards_the_leaves_param_shardings_shards(name, make, want):
    pcfg = make()
    jcfg = _jax_twin(pcfg)
    alpha, t, f = jcfg.SLOWFAST.ALPHA, jcfg.AUDIO_DATA.NUM_FRAMES, jcfg.AUDIO_DATA.NUM_FREQUENCIES
    xs = [jax.ShapeDtypeStruct((1, t // alpha, f, 1), np.float32),
          jax.ShapeDtypeStruct((1, t, f, 1), np.float32)]
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), xs)["params"]
    mesh = Mesh(np.asarray(jax.devices()[:MP]).reshape(1, MP), ("data", "model"))
    placed = param_shardings(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), mesh)
    flags = jax.tree.map(lambda x: "model" in tuple(x.sharding.spec), placed)
    # the converter's name of each leaf, carried by a one-element array of its index
    leaves, treedef = jax.tree.flatten(shapes)
    ids = jax.tree.unflatten(treedef, [np.full((1,) * len(s.shape), i, np.float32)
                                       for i, s in enumerate(leaves)])
    names = {int(v.flatten()[0]): k for k, v in flax_variables_to_torch_state(
        {"params": ids}).items()}
    jax_sharded = {names[i] for i, f in enumerate(jax.tree.leaves(flags)) if f}
    port = build_model(pcfg, "cpu")
    got = set(tensor.shard_names(port, MP))
    assert got == jax_sharded and len(got) == want, (sorted(got ^ jax_sharded), len(got))
    total = sum(p.numel() for p in port.parameters())
    params = dict(port.named_parameters())
    print(f"{name}: {len(got)} of {len(params)} leaves, "
          f"{sum(params[k].numel() for k in got) / total:.3f} of the parameters")


# --------------------------------------------------------------------------
# a 2 x 2 grid of 4 spawned ranks
# --------------------------------------------------------------------------

def _tiny(cfg, jax_side):
    """``test_torch_port_loop``'s tiny model at tiny_cfg's width (64)."""
    _model_cfg(cfg, jax_side)
    cfg.RESNET.WIDTH_PER_GROUP = 64
    cfg.MODEL.NUM_CLASSES = list(CLASSES)
    return cfg


def _grid(cfg):
    cfg.NUM_GPUS = DATA
    cfg.GPU.MODEL_PARALLEL = MP
    return cfg


@pytest.fixture(scope="module")
def grid_runs(epic_root, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("grid_ranks"))
    _, step_cfg = epic_cfgs(epic_root)
    _tiny(step_cfg, False)
    _, train_cfg = epic_cfgs(epic_root)
    _tiny(train_cfg, False)
    train_cfg.MODEL.DROPOUT_RATE = 0.5
    train_cfg.BN.USE_PRECISE_STATS = False
    train_cfg.DATA_LOADER.NUM_WORKERS = 0
    train_cfg.OUTPUT_DIR = os.path.join(out, "train")
    body = functools.partial(grid_rank, out=out, step_cfg=_grid(step_cfg.clone()),
                             train_cfg=_grid(train_cfg))
    mp.spawn(run_net.run_rank, args=(_grid(get_cfg()), f"tcp://localhost:{free_port()}", body,
                                     "cpu", "gloo"), nprocs=WORLD, join=True)
    got = [torch.load(os.path.join(out, f"grid_rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    fns = [torch.load(os.path.join(out, f"tp_rank{r}.pt")) for r in range(WORLD)]
    return got, fns, step_cfg, train_cfg


def test_a_rank_of_the_grid_knows_its_place(grid_runs):
    got, *_ = grid_runs
    # (data rank, model rank, data ranks, model size, local data rank, data ranks a host)
    assert [g["grid"] for g in got] == [(r // MP, r % MP, DATA, MP, r // MP, DATA)
                                        for r in range(WORLD)]


def test_the_autograd_functions_give_the_unsharded_layers(grid_runs):
    """Forward and backward in float64 on every rank: the outputs and input
    gradients whole, each weight's and bias's gradient its rank's block."""
    _, fns, *_ = grid_runs
    want = tp_forward(tp_layers())
    for r, got in enumerate(fns):
        assert got["names"] == ["conv.weight", "grouped.weight", "linear.weight"]
        m = r % MP
        for k, w in want.items():
            if k.startswith("d_"):  # every layer is sharded: its parameters' blocks
                n = w.shape[0] // MP
                w = w[m * n:(m + 1) * n]
            assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
            assert (got[k] - w).abs().max().item() <= FN_TOL * max(1.0, w.abs().max().item()), k


def _nhwc(a):
    return jax.numpy.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def _jax_bn(name):
    norm_type, k = GRID_BN_CASES[name]
    splits = {"batchnorm": 1, "sync_batchnorm": DATA // k}[norm_type]
    return TorchBatchNorm(features=C, num_splits=splits,
                          unbiased_running=norm_type != "sync_batchnorm")


@pytest.mark.parametrize("name", list(GRID_BN_CASES))
def test_batch_norm_on_the_grid_normalises_over_the_data_ranks(grid_runs, name):
    """The data ranks' rows together, against ``TorchBatchNorm`` over them:
    outputs, input and parameter gradients of the first step and the
    running statistics after two, within 1e-5; the ranks of a model group
    equal bit for bit."""
    got, *_ = grid_runs
    w, b = bn_params()
    bn = _jax_bn(name)
    params = {"scale": jax.numpy.asarray(w), "bias": jax.numpy.asarray(b)}
    stats = {"mean": jax.numpy.zeros(C), "var": jax.numpy.ones(C)}
    close = functools.partial(np.testing.assert_allclose, rtol=BN_TOL, atol=BN_TOL)
    for step in range(2):
        x, t = bn_inputs(step, DATA)

        def loss(p, xj, stats=stats, t=t):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xj,
                              use_running_average=False, mutable=["batch_stats"])
            return (y * _nhwc(t)).sum() / x.shape[0], (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, _nhwc(x))
        y, gx = np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2)
        for r, g in enumerate(got):
            rec, rows = g["bn"][name], slice((r // MP) * ROWS, (r // MP + 1) * ROWS)
            assert rec["type"] == "GroupedBatchNorm2d", rec["type"]
            close(rec[f"y{step}"].numpy(), y[rows])
            if step == 0:
                close(rec["dx"].numpy(), gx[rows])
                close(rec["dw"].numpy(), np.asarray(gp["scale"]))
                close(rec["db"].numpy(), np.asarray(gp["bias"]))
    for r, g in enumerate(got):
        close(g["bn"][name]["running_mean"].numpy(), np.asarray(stats["mean"]))
        close(g["bn"][name]["running_var"].numpy(), np.asarray(stats["var"]))
        partner = got[r ^ 1]["bn"][name]
        for k in ("y0", "y1", "dx", "running_mean", "running_var"):
            assert torch.equal(g["bn"][name][k], partner[k]), (r, k)


def test_model_parallel_one_is_the_data_parallelism_of_before(grid_runs):
    """The same 4 ranks read at ``GPU.MODEL_PARALLEL`` 1: every rank a data
    rank, the world as the data group, no shard, the norms of PR 11."""
    got, *_ = grid_runs
    for r, g in enumerate(got):
        one = g["mp1"]
        assert one["grid"] == (r, 0, WORLD, 1, r, WORLD)
        assert one["world_groups"] == (True, True)
        assert one["sync_bn_splits"] == WORLD
        assert one["sharded"] == [] and one["kept"]
        assert one["norms"] == {"batchnorm": ("GroupedBatchNorm2d", 1),
                                "sync-k2": ("GroupedBatchNorm2d", 2),
                                "sync-k1": ("GroupedBatchNorm2d", 4)}


def test_a_grid_step_matches_one_process(grid_runs):
    """One step of the tiny_cfg model on the grid against one process on
    the same 4 clips: the loss, ``grad_norm`` and ``param_norm`` within
    1e-4 relative, every leaf after the step within 1e-4 relative L2, and
    each sharded leaf's histogram counts summing to its whole size."""
    got, _, step_cfg, _ = grid_runs
    want = grid_step(step_cfg, "cpu")
    model = build_model(step_cfg, "cpu")
    whole = dict(model.named_parameters())
    norms = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    for g in got:
        step = g["step"]
        for k in ("loss", "grad_norm", "param_norm"):
            assert abs(step["parts"][k] - want["parts"][k]) <= STEP_TOL * abs(want["parts"][k]), k
        assert set(step["model"]) == set(want["model"])
        worst = max((_rel_l2(step["model"][k], w), k) for k, w in want["model"].items()
                    if not k.endswith("num_batches_tracked"))
        assert worst[0] <= LEAF_TOL, worst
        assert len(step["sharded"]) > 10
        # a gather a sharded layer and a batch norm forward, a sum of the layer's input's
        # gradient and of the norm's sums backward, and the step's: the numbers' gather
        # over the data group, the two norms' sums, the histograms' two
        n = len(step["sharded"]) + norms
        assert step["calls"] == {"all_gather": n + 1, "all_reduce": n + 2 + 2}, step["calls"]
        for k in step["sharded"]:
            for kind in ("parameters", "gradients"):
                counts, _ = step["watch"][f"{kind}/{watch_name(k, whole[k].dim())}"]
                assert int(counts.sum()) == whole[k].numel(), k
    assert want["sharded"] == []


def test_the_heads_dropout_draws_one_mask_a_model_group(grid_runs):
    """``train(cfg)`` with dropout 0.5: the ranks of a model group draw the
    same mask each step, the two data ranks different ones."""
    got, *_ = grid_runs
    masks = [g["train"]["masks"] for g in got]
    assert len(masks[0]) == 4
    for step in range(4):
        assert np.array_equal(masks[0][step], masks[1][step])
        assert np.array_equal(masks[2][step], masks[3][step])
        assert not np.array_equal(masks[0][step], masks[2][step])


def test_each_rank_holds_half_of_every_sharded_leaf_and_its_momentum(grid_runs):
    got, _, _, train_cfg = grid_runs
    whole = build_model(train_cfg, "cpu")
    names = tensor.shard_names(whole, MP)
    shapes = {k: tuple(p.shape) for k, p in whole.named_parameters()}
    for g in got:
        rec = g["train"]
        assert rec["step"] == 4
        assert rec["sharded"] == [k for k in shapes if k in names
                                  or k[:-len("bias")] + "weight" in names]
        for k, shape in shapes.items():
            half = (shape[0] // MP, *shape[1:]) if k in rec["sharded"] else shape
            assert rec["shapes"][k] == half, k
            assert rec["momentum"][k] == half, k


def test_the_grid_writes_one_pyth_that_loads_into_one_process(grid_runs):
    _, _, _, train_cfg = grid_runs
    ckpts = os.path.join(train_cfg.OUTPUT_DIR, "checkpoints")
    assert "checkpoint_epoch_00001.pyth" in os.listdir(ckpts)
    ckpt = cu.load_checkpoint(os.path.join(ckpts, "checkpoint_epoch_00001.pyth"))
    model = build_model(train_cfg, "cpu")
    model.load_state_dict(ckpt["model_state"], strict=True)
    optimizer = init_state(train_cfg, model).optimizer
    order = [p for g in optimizer.param_groups for p in g["params"]]
    state = ckpt["optimizer_state"]["state"]
    assert len(state) == len(order)
    assert all(state[i]["momentum_buffer"].shape == p.shape for i, p in enumerate(order))
    optimizer.load_state_dict(ckpt["optimizer_state"])


# --------------------------------------------------------------------------
# train(cfg) and test(cfg) through run_net on a 2 x 2 grid, against asf_tpu
# --------------------------------------------------------------------------

def _loop_cfgs(root, out):
    """(JAX cfg, port cfg) of the grid's run: the tiny_cfg model on the EPIC
    set, one epoch of 4 steps, BN frozen but for the stems and ``s1_fuse``
    (as the EPIC configs have it, ``entry.epic_cfg``), precise BN over 2
    batches, val in 4, 4 and 2, test in 3 views (B = 4, the last batch
    ragged). With every BN live at this width, one process of each package
    already ends ~8 % apart in the BN biases after these 4 steps at LR 0.01
    (float32 sums of their gradients), grid or not; frozen, 2.4e-5."""
    jcfg, pcfg = epic_cfgs(root)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _tiny(cfg, side)
        cfg.BN.FREEZE = True
        cfg.NUM_GPUS = DATA
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
    jcfg.TPU.DATA_PARALLEL, jcfg.TPU.MODEL_PARALLEL = DATA, MP
    jcfg.TPU.USE_PALLAS_DSP = False
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.GPU.MODEL_PARALLEL = MP
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


def _json_stats(path):
    with open(path) as f:
        return [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                if "json_stats: " in line]


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


@pytest.fixture(scope="module")
def loop_runs(epic_root, tmp_path_factory):  # noqa: F811
    """``run_net --device cpu`` on the grid (train, then test), and
    ``asf_tpu.engine.train`` on the (2, 2) mesh, from one start."""
    out = str(tmp_path_factory.mktemp("grid_loop"))
    jcfg, pcfg = _loop_cfgs(epic_root, out)
    one = pcfg.clone()
    one.NUM_GPUS, one.GPU.MODEL_PARALLEL = 1, 1
    start = _start_pyth(one, os.path.join(out, "start.pyth"), 5)
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.CHECKPOINT_FILE_PATH = start
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    pcfg.TEST.ENABLE = True
    path = os.path.join(out, "run.yaml")
    with open(path, "w") as f:
        f.write(pcfg.dump())
    run_net.main(["--cfg", path, "--device", "cpu", "--init_method",
                  f"tcp://localhost:{free_port()}"])
    pstats = _json_stats(os.path.join(pcfg.OUTPUT_DIR, "stdout.log"))
    with pytest.MonkeyPatch.context() as mp_, captured("asf_tpu") as jlog:
        mp_.setenv("ASF_MAXPOOL_SAS_BWD", "1")
        mp_.setattr(jax_train_loop, "init_state", _jitted_init_state)
        jax_train(jcfg)
    mesh = make_mesh(jcfg)
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (DATA, MP)
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    assert int(payload["step"]) == 4
    return (jcfg, pcfg, start, pstats, jax.tree.map(np.asarray, payload["model_state"]),
            jlog.stats)


def test_train_on_the_grid_matches_jax_on_the_mesh(loop_runs):
    """Every leaf within 1e-4 relative L2 of ``asf_tpu``'s, and moved from
    the start; the epoch's losses within 1e-4; one record an iteration."""
    _, pcfg, start, pstats, variables, jstats = loop_runs
    got = cu.load_checkpoint(cu.get_path_to_checkpoint(pcfg.OUTPUT_DIR, 1))["model_state"]
    want = flax_variables_to_torch_state(variables)
    assert set(got) == set(want)
    begin = torch.load(start)["model_state"]
    worst = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        worst[k] = _rel_l2(got[k], w)
        assert is_frozen_bn_param(k) or not torch.equal(got[k], begin[k]), k
    assert max(worst.values()) <= LEAF_TOL, max(worst.items(), key=lambda kv: kv[1])
    (jep,), (pep,) = _records(jstats, "train_epoch"), _records(pstats, "train_epoch")
    for k in ("loss", "verb_loss", "noun_loss"):
        assert abs(pep[k] - jep[k]) <= LOSS_TOL, (k, pep[k], jep[k])
    for kind, n in (("train_iter", 4), ("val_iter", 3)):
        assert len(_records(pstats, kind)) == len(_records(jstats, kind)) == n


def test_val_on_the_grid_gives_the_jax_errors(loop_runs):
    _, _, _, pstats, _, jstats = loop_runs
    (jval,), (pval,) = _records(jstats, "val_epoch"), _records(pstats, "val_epoch")
    for k in jval:
        if k.endswith("_acc"):
            assert pval[k] == jval[k], (k, pval[k], jval[k])


def test_the_grid_writes_its_checkpoints_once_and_they_load_into_one_process(loop_runs):
    _, pcfg, *_ = loop_runs
    ckpts = os.path.join(pcfg.OUTPUT_DIR, "checkpoints")
    names = sorted(os.listdir(ckpts))
    assert names[-1] == "checkpoint_epoch_00001.pyth" and len(names) <= 2, names
    ckpt = cu.load_checkpoint(os.path.join(ckpts, "checkpoint_epoch_00001.pyth"))
    assert ckpt["step"] == 4
    one = pcfg.clone()
    one.NUM_GPUS, one.GPU.MODEL_PARALLEL = 1, 1
    build_model(one, "cpu").load_state_dict(ckpt["model_state"], strict=True)


def test_test_on_the_grid_matches_jax_on_the_mesh(loop_runs, tmp_path):
    """``test(cfg)`` of the grid's checkpoint against ``asf_tpu.engine.test``
    on the (2, 2) mesh from the same weights: verb and noun scores within
    1e-5 (``test_torch_port_epic.py``'s bound: at this width one process of
    the port is itself 2e-6 from ``asf_tpu``), and within 1e-6 of one
    process of the port; the labels and narration ids equal, one pickle."""
    jcfg, pcfg, _, pstats, _, _ = loop_runs
    jcfg = jcfg.clone()
    jcfg.OUTPUT_DIR = str(tmp_path)
    jcfg.TEST.CHECKPOINT_FILE_PATH = cu.get_path_to_checkpoint(pcfg.OUTPUT_DIR, 1)
    with pytest.MonkeyPatch.context() as mp_, captured("asf_tpu") as jlog:
        mp_.setattr(jax_test_loop, "init_state", _jitted_init_state)
        (jv, jn), (jvl, jnl), jids = jax_test(jcfg)
    scores = os.path.join(pcfg.OUTPUT_DIR, "scores")
    assert os.listdir(scores) == ["scores.pkl"]
    with open(os.path.join(scores, "scores.pkl"), "rb") as f:
        got = pickle.load(f)
    assert got["verb_output"].shape == jv.shape == (6, CLASSES[0])
    assert max(np.abs(got["verb_output"] - jv).max(),
               np.abs(got["noun_output"] - jn).max()) <= JAX_SCORE_TOL
    one = pcfg.clone()
    one.NUM_GPUS, one.GPU.MODEL_PARALLEL = 1, 1
    one.OUTPUT_DIR = str(tmp_path / "one")
    one.TEST.CHECKPOINT_FILE_PATH = jcfg.TEST.CHECKPOINT_FILE_PATH
    (ov, on), _, ids = port_test(one, device="cpu")
    assert max(np.abs(got["verb_output"] - ov).max(),
               np.abs(got["noun_output"] - on).max()) <= SCORE_TOL
    assert list(ids) == list(got["narration_id"])
    np.testing.assert_array_equal(got["labels"]["verb"], jvl)
    np.testing.assert_array_equal(got["labels"]["noun"], jnl)
    assert list(got["narration_id"]) == list(jids)
    (jfinal,), (pfinal,) = _records(jlog.stats, "test_final"), _records(pstats, "test_final")
    assert pfinal == jfinal


# --------------------------------------------------------------------------
# the release-checkpoint check
# --------------------------------------------------------------------------

def test_the_release_self_test_passes_on_the_cpu(tmp_path, capsys):
    assert verify_release_ckpt.main(["--self-test", "--device", "cpu",
                                     "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "self-test OK" in out and '"stable_across_runs": true' in out


@pytest.fixture(scope="module")
def jax_release(tmp_path_factory):
    """The JAX script's tiny model with weights from ``PRNGKey(7)`` as a
    reference ``.pyth`` (its self-test's file), its fixture wav, and its
    ``verify`` of that file: the snapshot and ``predict``'s scores."""
    import asf_tpu.models as jax_models
    from asf_tpu.checkpoint.pyth_converter import flax_to_torch_state
    from asf_tpu.tools import predict as jax_predict
    from test_torch_port_tools import _JITTED, _Jitted

    v = _jax_release_script()
    out = tmp_path_factory.mktemp("release")
    cfg = v.build_cfg("slowfast", "epic", tiny=True)
    cfg.RNG_SEED = 0
    wav = v.fixture_wav(cfg, str(out / "fixture.wav"))
    model = jax_build_model(cfg)
    inputs = jax_predict.load_audio(cfg, wav)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(jax.random.PRNGKey(7), inputs)
    sd = flax_to_torch_state({"params": variables["params"],
                              "batch_stats": variables.get("batch_stats", {})})
    ckpt = str(out / "release.pyth")
    torch.save({"model_state": {k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
                "epoch": 3}, ckpt)
    scores, main = [], jax_predict.main

    def recording(argv=None):
        preds = main(argv)
        scores.append([np.asarray(p, np.float32) for p in preds])
        return preds

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax_models, "build_model", lambda c: _JITTED.setdefault(
            c.dump(), _Jitted(jax_build_model(c))))
        mp_.setattr(jax_predict, "main", recording)
        os.makedirs(out / "jax")
        snap = v.verify(ckpt, cfg, wav, str(out / "jax"))
    return ckpt, wav, snap, scores[0], out


def _jax_release_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "verify_release_ckpt.py")
    spec = importlib.util.spec_from_file_location("verify_release_ckpt", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_release_check_of_a_jax_pyth_gives_the_jax_scripts_snapshot(jax_release):
    """The port's check of the ``.pyth`` the JAX script verifies: each
    head's argmax and top 5 as the JAX script's, ``predict``'s scores within
    2e-5 (``test_torch_port_tools.py:test_predict_matches_jax``)."""
    ckpt, wav, want, want_scores, out = jax_release
    pcfg = verify_release_ckpt.build_cfg("slowfast", "epic", tiny=True)
    os.makedirs(out / "port")
    got = verify_release_ckpt.verify(ckpt, pcfg, wav, str(out / "port"), "cpu")
    assert got["stable_across_runs"] and set(got["heads"]) == set(want["heads"]) == {"verb",
                                                                                      "noun"}
    for name in want["heads"]:
        for k in ("shape", "argmax", "top5"):
            assert got["heads"][name][k] == want["heads"][name][k], (name, k)
    saved = np.load(out / "port" / "predict_scores.npz")
    for name, w in zip(("verb", "noun"), want_scores):
        np.testing.assert_allclose(saved[name], w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case,code", [("absent", 2), ("not a checkpoint", 2),
                                       ("a leaf short", 3), ("module. prefix", 0)])
def test_the_release_check_exit_codes(jax_release, tmp_path, case, code):
    """A missing or unreadable file exits 2, a checkpoint that leaves a
    leaf of the release model out exits 3, a DDP-saved one (``module.``
    names) loads whole."""
    ckpt, *_ = jax_release
    path = str(tmp_path / "ckpt.pyth")
    if case == "not a checkpoint":
        with open(path, "wb") as f:
            f.write(b"stub")
    elif case != "absent":
        state = torch.load(ckpt)["model_state"]
        if case == "a leaf short":
            state.pop("head.projection_noun.weight")
        else:
            state = {f"module.{k}": t for k, t in state.items()}
        torch.save({"model_state": state}, path)
    cfg = verify_release_ckpt.build_cfg("slowfast", "epic", tiny=True)
    if code == 0:
        release = verify_release_ckpt.load_release(verify_release_ckpt.fetch(path), cfg,
                                                   str(tmp_path))
        build_model(cfg, "cpu").load_state_dict(torch.load(release)["model_state"], strict=True)
        return
    with pytest.raises(SystemExit) as e:
        verify_release_ckpt.load_release(verify_release_ckpt.fetch(path), cfg, str(tmp_path))
    assert e.value.code == code
