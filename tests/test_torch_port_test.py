"""The port's ``test(cfg)``, its metrics, its YAML reader and the ``run_net``
CLI against the JAX package's.

``test(cfg)`` and ``asf_tpu.engine.test_loop.test`` load one ``.pyth`` (the
port's converter applied to the JAX model's initial parameters, with BN
statistics drawn from a seed) and score the 15 clips of
``tests/fixtures.py:make_vgg_fixture`` (plus one file shorter than a clip)
in 2 views each, in batches of 4 and a ragged 2, with the tiny float32
SlowFast (the HIGHEST front end; K1 in interpret mode on the JAX side), by
sum and by max. The metrics are held to scikit-learn through
``asf_tpu.engine.metrics``, ties included; ``yaml_lite`` to
``yaml.safe_load`` on every config under ``models/asf/config``.
"""

import glob
import math
import os
import pickle
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from asf_tpu.engine import meters as jax_meters
from asf_tpu.engine import metrics as jax_metrics
from asf_tpu.engine.steps import make_input_pipeline
from asf_tpu.engine.test_loop import test as jax_test
from asf_tpu.models import build_model as jax_build_model
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg, yaml_lite
from asf_tpu_torch.engine import meters, metrics
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.tools import run_net
from test_torch_port_data import N_CLIPS, vgg_cfgs, vgg_root  # noqa: F401  (fixture)
from test_torch_port_loop import _model_cfg, captured

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "models" / "asf" / "config" / "**" / "*.yaml"),
                           recursive=True))
# Ensembled scores, float32 probabilities summed (or maxed) in float64 over 2
# views: the two packages' float32 forwards differ by ~1e-7 a probability.
SCORE_TOL = 1e-5
VIEWS = 2


# -- metrics ------------------------------------------------------------------

def test_tied_scores_follow_sklearn_by_hand():
    """Two tied scores, one positive: AP steps over the tie once (precision
    1/2 at recall 1/2, then 2/3 at 1); AUC counts the tied pair as half."""
    y, s = np.array([1.0, 0.0, 1.0]), np.array([0.5, 0.5, 0.2])
    assert metrics.average_precision(y, s) == pytest.approx(0.5 * 0.5 + 0.5 * 2 / 3, abs=1e-12)
    assert metrics.roc_auc(y, s) == pytest.approx(0.25, abs=1e-12)
    with pytest.raises(ValueError, match="one class"):
        metrics.roc_auc(np.ones(3), s)


@pytest.mark.parametrize("ties", [False, True])
def test_vggsound_stats_and_map_match_sklearn(ties):
    rng = np.random.default_rng(5 + ties)
    for trial in range(24):
        n, c = int(rng.integers(4, 90)), int(rng.integers(2, 14))
        preds = rng.random((n, c))
        if ties:  # a handful of levels, and whole rows repeated
            preds = np.round(preds * 3) / 3
            preds[n // 2 :] = preds[: n - n // 2]
        if trial % 3 == 0:
            preds = preds.astype(np.float32)
        labels = rng.integers(0, c, n)
        labels[0] = c - 1  # two classes at least: every class has an AUC or no positive
        got, want = metrics.vggsound_stats(preds, labels), jax_metrics.vggsound_stats(preds,
                                                                                     labels)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9, (trial, k, got[k], want[k])
        multi = (rng.random((n, c)) < 0.3).astype(np.int64)
        multi[:, 0] = 0  # a class with no positive is dropped
        assert abs(metrics.get_map(preds, multi) - jax_metrics.get_map(preds, multi)) <= 1e-9
    for auc in (0.3, 0.5, 0.77, 0.99):
        assert metrics.d_prime(auc) == pytest.approx(jax_metrics.d_prime(auc), abs=1e-12)
    bad = np.array([[0, 2], [1, 0]])
    assert metrics.get_map(np.ones((2, 2)), bad) == jax_metrics.get_map(np.ones((2, 2)), bad)


def test_a_class_every_clip_belongs_to_has_no_auc():
    """Every clip of class 0: its AUC is undefined and left out, as the JAX
    package's ``except ValueError`` means it to be (scikit-learn 1.9 returns
    NaN with a warning there instead of raising, and the JAX package's mean
    AUC turns NaN)."""
    preds = np.random.default_rng(2).random((6, 3))
    labels = np.zeros(6, np.int64)
    got = metrics.vggsound_stats(preds, labels)
    assert got == {"mAP": 1.0, "AUC": 0.0, "d_prime": 0.0}
    with warnings.catch_warnings():  # scikit-learn's UndefinedMetricWarning
        warnings.simplefilter("ignore")
        want = jax_metrics.vggsound_stats(preds, labels)
    assert want["mAP"] == 1.0 and want["d_prime"] == 0.0
    assert want["AUC"] == 0.0 or math.isnan(want["AUC"])


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_ensembles_as_jax(method):
    """Views arriving out of order, a clip's views in one batch: the same
    float64 rows, labels and top-k records."""
    rng = np.random.default_rng(9)
    n_clips, views, classes = 11, 3, 7
    ids = rng.permutation(n_clips * views)
    labels = (ids // views) % classes
    preds = rng.random((ids.size, classes)).astype(np.float32)
    mine = meters.TestMeter(n_clips, views, classes, 4, method)
    theirs = jax_meters.TestMeter(n_clips, views, classes, 4, method)
    for b in range(0, ids.size, 8):
        sl = slice(b, b + 8)
        mine.update_stats(preds[sl], labels[sl], ids[sl])
        theirs.update_stats(preds[sl], labels[sl], ids[sl])
    with captured("asf_tpu_torch") as plog, captured("asf_tpu") as jlog:
        got, want = mine.finalize_metrics(), theirs.finalize_metrics()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert plog.stats == jlog.stats and plog.stats[0]["_type"] == "test_final"
    with pytest.raises(AssertionError, match="different labels"):
        mine.update_stats(preds[:1], labels[:1] + 1, ids[:1])


# -- yaml_lite ------------------------------------------------------------------

def test_every_repo_config_is_found():
    assert len(CONFIGS) == 23 and any("/slide/" in p for p in CONFIGS)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_lite_reads_each_repo_config_as_pyyaml(path):
    text = Path(path).read_text()
    assert yaml_lite.load(text) == yaml.safe_load(text)


SNIPPETS = [
    "a: 1\nb: [1, 2, [3, 4]]\nc: {x: 1.0e-4, y: 1e-4, z: .5, w: -.inf}\n",
    "A:\n- [1, 2]\n- [3, 4]\nB: yes\nC: ~\nD:\nE: 'it''s # not'  # a comment\nF: \"a\\tb\"\n",
    "x: [add, apply,\n  insert, mix]\ny: {P: a, Q: [1,\n   2]}\nz: Off\n",
    "top:\n  sub:\n    - 1\n    - 2.5\n  other: NO\nnext: runs/a-0,5s\n",
    "k: 0\nm: -3\nn: +4\no: 1_000\np: 1.\nq: 1e5\nr: ''\ns: {}\nt: [ ]\nu: 'a: b'\n",
    "[1, {A: b}]\n", "plain words\n", "", "# only a comment\n",
    "A:\n- - 3\n- - 4\n", "A:\n  B:\n  - - 1\n    - 1\n  - - 1\n    - [2, 3]\n  C: 1\n",
    "- - - 1\n    - 2\n  - - 3\n- x\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_yaml_lite_forms_read_as_pyyaml(text):
    assert yaml_lite.load(text) == yaml.safe_load(text)


OUTSIDE = ["k: 010\n", "k: 0x10\n", "k: 1:30\n", "k: 2001-12-14\n", "k: &a 1\n", "k: *a\n",
           "k: !!str 1\n", "k: |\n  x\n", "- a: 1\n", "a: 1\na: 2\n", "k: [a:b]\n",
           "k: foo\n  bar\n", "---\nk: 1\n", "k: 1\n\tl: 2\n", "k: [1, 2\n",
           "- - a: 1\n", "- -\n"]


@pytest.mark.parametrize("text", OUTSIDE)
def test_yaml_lite_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match=r"line \d+"):
        yaml_lite.load(text)


def test_cfg_dump_reads_back_through_both_readers_and_merges(tmp_path):
    cfg = get_cfg()
    cfg.OUTPUT_DIR = "runs/a: b # c"
    cfg.TEST.SAVE_RESULTS_PATH = "yes"
    cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ("module.", "1e-4")
    cfg.SOLVER.BASE_LR = 1e-10
    cfg.SOLVER.STEPS = [0, 20, 25]
    text = cfg.dump()
    plain = yaml.safe_load(text)
    assert yaml_lite.load(text) == plain
    assert plain["TRAIN"]["CHECKPOINT_CLEAR_NAME_PATTERN"] == ["module.", "1e-4"]
    for suffix, body in ((".yaml", text), (".json", cfg.to_json())):
        path = tmp_path / f"cfg{suffix}"
        path.write_text(body)
        back = get_cfg()
        back.merge_from_file(str(path))
        assert back == cfg


# -- test(cfg) -----------------------------------------------------------------

@pytest.fixture(scope="module")
def test_pyth(vgg_root, tmp_path_factory):  # noqa: F811
    """The JAX model's initial parameters, BN statistics drawn from a seed,
    through the port's converter into a ``.pyth``."""
    jcfg, _ = vgg_cfgs(vgg_root)
    _model_cfg(jcfg, True)
    model = jax_build_model(jcfg)
    s = int(round(jcfg.AUDIO_DATA.SAMPLING_RATE * jcfg.AUDIO_DATA.CLIP_SECS)) - 1
    paths = make_input_pipeline(jcfg)(jnp.zeros((2, s), jnp.float32),
                                      jnp.full((2,), s, jnp.int32), None)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, xs: model.init(k, xs, train=False))(jax.random.PRNGKey(3), paths))
    rng = np.random.default_rng(4)

    def stat(path, v):
        if path[-1].key == "mean":
            return (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
        return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    path = str(tmp_path_factory.mktemp("weights") / "test.pyth")
    torch.save({"model_state": flax_variables_to_torch_state(variables), "epoch": 3}, path)
    return path


def _test_cfgs(root, out, pyth, method):
    """(JAX cfg, port cfg): the 15 records of ``all.pkl`` in 2 views, B = 4."""
    jcfg, pcfg = vgg_cfgs(root, train_list="all.pkl", val_list="all.pkl")
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
        cfg.TEST.CHECKPOINT_FILE_PATH = pyth
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
        cfg.DATA.ENSEMBLE_METHOD = method
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


def _scores(cfg):
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "scores.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_matches_jax_test(vgg_root, test_pyth, tmp_path, method):  # noqa: F811
    jcfg, pcfg = _test_cfgs(vgg_root, str(tmp_path), test_pyth, method)
    with captured("asf_tpu") as jlog:
        want_preds, want_labels = jax_test(jcfg)
    with captured("asf_tpu_torch") as plog:
        got_preds, got_labels = port_test(pcfg, device="cpu")
    n = N_CLIPS + 1
    assert got_preds.shape == want_preds.shape == (n, 6) and got_preds.dtype == np.float64
    np.testing.assert_array_equal(got_labels, want_labels)
    assert np.abs(got_preds - want_preds).max() <= SCORE_TOL
    if method == "sum":  # each row: VIEWS probability rows
        np.testing.assert_allclose(got_preds.sum(axis=1), VIEWS, rtol=0, atol=1e-5)
    (jfinal,) = [r for r in jlog.stats if r["_type"] == "test_final"]
    (pfinal,) = [r for r in plog.stats if r["_type"] == "test_final"]
    assert pfinal == jfinal
    assert not [r for r in plog.stats if r["_type"] == "test_warn"]
    got, want = _scores(pcfg), _scores(jcfg)
    assert got.keys() == want.keys() == {"output", "labels"}
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k])
    np.testing.assert_array_equal(got["output"], got_preds)
    assert any(m.startswith("VGG-Sound stats: ") for m in plog.messages)


def test_test_raises_for_what_later_slices_bring():
    """What ``test(cfg)`` and ``run_net`` refuse now that ranks are ported:
    more than one shard without the process group ``run_net`` starts (the
    error names it), ``NUM_GPUS`` above the CUDA device count (NCCL takes a
    card a rank), and a world size that ``NUM_SYNC_DEVICES`` does not divide."""
    cfg = get_cfg()
    cfg.merge_from_list(["NUM_SHARDS", 2])
    with pytest.raises(RuntimeError, match="NUM_SHARDS = 2.*run_net"):
        port_test(cfg, device="cpu")
    cfg = get_cfg()
    cfg.NUM_GPUS = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        run_net.launch_job(cfg, "tcp://localhost:9999", port_test)
    cfg = get_cfg()
    cfg.merge_from_list(["BN.NORM_TYPE", "sync_batchnorm", "BN.NUM_SYNC_DEVICES", 2])
    with pytest.raises(ValueError, match="NUM_SYNC_DEVICES = 2 does not divide the world size 1"):
        port_test(cfg, device="cpu")


def test_run_net_trains_then_tests_from_a_yaml_file(vgg_root, tmp_path):  # noqa: F811
    """One epoch of 3 steps, then the test split (15 clips, 2 views) from
    the epoch's checkpoint, from a YAML file written by ``cfg.dump()``."""
    _, cfg = vgg_cfgs(vgg_root, train_list="all.pkl", val_list="val.pkl")
    _model_cfg(cfg, False)
    cfg.VGGSOUND.TEST_LIST = "all.pkl"
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.DATA_LOADER.NUM_WORKERS = 0
    path = tmp_path / "run.yaml"
    path.write_text(cfg.dump())
    with captured("asf_tpu_torch") as log:
        run_net.main(["--cfg", str(path), "--device", "cpu", "TEST.SAVE_RESULTS_PATH", "cli.pkl"])
    kinds = [r["_type"] for r in log.stats]
    assert kinds.index("train_epoch") < kinds.index("test_final")
    ckpt = os.path.join(cfg.OUTPUT_DIR, "checkpoints", "checkpoint_epoch_00001.pyth")
    assert f"Test weights: {ckpt}" in log.messages
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "cli.pkl"), "rb") as f:
        scores = pickle.load(f)
    assert scores["output"].shape == (N_CLIPS + 1, 6)
    assert all(math.isfinite(v) for v in scores["output"].ravel())
