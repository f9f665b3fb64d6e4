"""``train(cfg)`` and ``test(cfg)`` of the port in 4 gloo ranks on the CPU, against ``asf_tpu``.

``run_net --device cpu`` at ``NUM_GPUS 4``: ``train(cfg)`` (the tiny
VGG-Sound SlowFast of ``test_torch_port_loop.py``, float32, SpecAugment and
dropout off, precise BN over 2 batches; 3 steps of 4 clips, 1 a rank; val
batches of 4, 4 and 2 clips, ranks 2 and 3 empty in the last) against
``asf_tpu.engine.train`` at ``NUM_GPUS 4`` (4 of the tests' 8 virtual
devices) from the same ``.pyth``: every leaf within 1e-4 relative L2, the
epoch loss within 1e-4, the val errors equal, the checkpoints written once,
by rank 0, with no ``module.`` prefix; then ``test(cfg)`` (10 clips in 2
views, batches of 8, the last of 4: ranks 2 and 3 empty) against
``asf_tpu.engine.test`` from the same weights: scores within 1e-6, one
pickle, the same ``test_final`` record.

The JAX side runs its plain log-mel (``USE_PALLAS_DSP`` off), as the port's
CPU tensors do, ``ASF_MAXPOOL_SAS_BWD=1`` (``test_torch_port_train.py``)
and its model init jitted (``test_torch_port_state.py:_jitted_init_state``).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.engine import test as jax_test
from asf_tpu.engine import test_loop as jax_test_loop
from asf_tpu.engine import train as jax_train
from asf_tpu.engine import train_loop as jax_train_loop
from asf_tpu.parallel.mesh import make_mesh
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.tools import run_net
from test_torch_port_data import vgg_cfgs, vgg_root  # noqa: F401  (fixture)
from test_torch_port_loop import _model_cfg, _rel_l2, captured, start_pyth  # noqa: F401
from test_torch_port_state import _jitted_init_state
from torch_dist_ranks import free_port

WORLD = 4
LEAF_TOL, LOSS_TOL, SCORE_TOL = 1e-4, 1e-4, 1e-6


def _dist_cfgs(root, out):
    """(JAX cfg, port cfg) of ``test_torch_port_loop.py``'s run at NUM_GPUS 4."""
    jcfg, pcfg = vgg_cfgs(root, train_list="all.pkl", val_list="val.pkl")
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
        cfg.NUM_GPUS = WORLD
        cfg.TEST.BATCH_SIZE = 8
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
    jcfg.TPU.DATA_PARALLEL = 0
    jcfg.TPU.USE_PALLAS_DSP = False
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


def _json_stats(path):
    with open(path) as f:
        return [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                if "json_stats: " in line]


@pytest.fixture(scope="module")
def port_run(vgg_root, start_pyth, tmp_path_factory):  # noqa: F811
    """``run_net --device cpu ... NUM_GPUS 4``: train(cfg), then test(cfg)."""
    out = str(tmp_path_factory.mktemp("dist_port"))
    _, pcfg = _dist_cfgs(vgg_root, out)
    pcfg.TRAIN.CHECKPOINT_FILE_PATH = start_pyth
    pcfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    pcfg.TEST.ENABLE = True
    path = os.path.join(out, "run.yaml")
    with open(path, "w") as f:
        f.write(pcfg.dump())
    run_net.main(["--cfg", path, "--device", "cpu", "--init_method",
                  f"tcp://localhost:{free_port()}"])
    return pcfg, _json_stats(os.path.join(pcfg.OUTPUT_DIR, "stdout.log"))


@pytest.fixture(scope="module")
def jax_run(vgg_root, start_pyth, tmp_path_factory):  # noqa: F811
    """``asf_tpu.engine.train`` at NUM_GPUS 4 from ``start.pyth``."""
    jcfg, _ = _dist_cfgs(vgg_root, str(tmp_path_factory.mktemp("dist_jax")))
    jcfg.TRAIN.CHECKPOINT_FILE_PATH = start_pyth
    jcfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    with pytest.MonkeyPatch.context() as mp_, captured("asf_tpu") as log:
        mp_.setenv("ASF_MAXPOOL_SAS_BWD", "1")
        mp_.setattr(jax_train_loop, "init_state", _jitted_init_state)
        jax_train(jcfg)
    assert make_mesh(jcfg).devices.size == WORLD
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    return jcfg, jax.tree.map(np.asarray, payload["model_state"]), log.stats


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


def test_train_over_four_ranks_writes_its_checkpoints_once_without_a_prefix(port_run):
    """Rank 0 alone writes, the model's own names (no ``module.``), step 3."""
    pcfg, _ = port_run
    ckpts = os.path.join(pcfg.OUTPUT_DIR, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["checkpoint_best.pyth", "checkpoint_epoch_00001.pyth"]
    ckpt = cu.load_checkpoint(os.path.join(ckpts, "checkpoint_epoch_00001.pyth"))
    assert ckpt["step"] == 3
    assert not [k for k in ckpt["model_state"] if k.startswith("module.")]


def test_train_over_four_ranks_matches_jax_on_four_devices(port_run, jax_run,
                                                           start_pyth):  # noqa: F811
    """Every leaf within 1e-4 relative L2 of ``asf_tpu``'s, and moved from the start."""
    pcfg, _ = port_run
    _, variables, _ = jax_run
    got = cu.load_checkpoint(cu.get_path_to_checkpoint(pcfg.OUTPUT_DIR, 1))["model_state"]
    want = flax_variables_to_torch_state(variables)
    assert set(got) == set(want)
    start = torch.load(start_pyth)["model_state"]
    worst = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        worst[k] = _rel_l2(got[k], w)
        assert not torch.equal(got[k], start[k]), k
    assert max(worst.values()) <= LEAF_TOL, max(worst.items(), key=lambda kv: kv[1])


def test_train_over_four_ranks_logs_the_jax_loss(port_run, jax_run):
    """The epoch loss within 1e-4 and one record an iteration, from rank 0 alone."""
    _, pstats = port_run
    _, _, jstats = jax_run
    (jep,), (pep,) = _records(jstats, "train_epoch"), _records(pstats, "train_epoch")
    assert abs(pep["loss"] - jep["loss"]) <= LOSS_TOL
    for kind in ("train_iter", "val_iter"):
        assert len(_records(pstats, kind)) == len(_records(jstats, kind)) == 3


def test_val_over_four_ranks_gives_the_jax_errors(port_run, jax_run):
    """The val errors of the batches of 4, 4 and 2 clips (ranks 2 and 3 empty
    in the last) equal ``asf_tpu``'s."""
    _, pstats = port_run
    _, _, jstats = jax_run
    (jval,), (pval,) = _records(jstats, "val_epoch"), _records(pstats, "val_epoch")
    for k in ("top1_err", "top5_err", "min_top1_err"):
        assert pval[k] == jval[k], (k, pval[k], jval[k])
    for j, p in zip(_records(jstats, "val_iter"), _records(pstats, "val_iter")):
        assert (p["top1_err"], p["top5_err"]) == (j["top1_err"], j["top5_err"])


def test_test_over_four_ranks_matches_jax_on_four_devices(port_run, vgg_root,  # noqa: F811
                                                         tmp_path):
    pcfg, pstats = port_run
    jcfg, _ = _dist_cfgs(vgg_root, str(tmp_path))
    sd = cu.load_checkpoint(cu.get_last_checkpoint(pcfg.OUTPUT_DIR))["model_state"]
    jcfg.TEST.CHECKPOINT_FILE_PATH = str(tmp_path / "trained.pyth")
    torch.save({"model_state": sd, "epoch": 1}, jcfg.TEST.CHECKPOINT_FILE_PATH)
    with pytest.MonkeyPatch.context() as mp_, captured("asf_tpu") as jlog:
        mp_.setattr(jax_test_loop, "init_state", _jitted_init_state)
        want_preds, want_labels = jax_test(jcfg)
    scores = os.listdir(os.path.join(pcfg.OUTPUT_DIR, "scores"))
    assert scores == ["scores.pkl"]
    with open(os.path.join(pcfg.OUTPUT_DIR, "scores", "scores.pkl"), "rb") as f:
        got = pickle.load(f)
    assert got["output"].shape == want_preds.shape == (10, 6)
    np.testing.assert_array_equal(got["labels"], want_labels)
    assert np.abs(got["output"] - want_preds).max() <= SCORE_TOL
    (jfinal,), (pfinal,) = _records(jlog.stats, "test_final"), _records(pstats, "test_final")
    assert pfinal == jfinal
