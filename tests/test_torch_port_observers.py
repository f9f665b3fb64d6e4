"""The port's observers against the JAX package's: ``ScalarLogger`` with
TensorBoard and a stand-in W&B, the TensorBoard writer's confusion matrix,
the plots, the class names, the watch histograms, and ``train(cfg)``
logging ``Train/*``, ``Val/*``, the val plots and a profiler trace.

The stand-in ``wandb`` module (``chip_smoke.WandbStandIn``, which phase 12
uses on the card) goes into ``sys.modules`` (this host has no ``wandb``), as
``tests/test_watch_histograms.py`` does; both packages' loggers record
their calls on the same stand-in. The event files are
read back with tensorboard's ``EventAccumulator``. The val plots' rows
across two gloo ranks are held to one process's. ``train(cfg)``'s scalars,
plots, histograms and trace against the JAX run are in
``tests/test_torch_port_loop.py``, which shares its JAX train.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from asf_tpu.checkpoint.pyth_converter import torch_state_to_flax as jax_torch_state_to_flax
from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.engine import observers as jax_observers
from asf_tpu.engine import steps as jax_steps
from asf_tpu.utils.misc import get_class_names as jax_get_class_names
from asf_tpu.visualization import tensorboard_vis as jax_tb
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.engine import observers
from asf_tpu_torch.engine.steps import watch_summary
from asf_tpu_torch.models import build_model
from asf_tpu_torch.utils.misc import get_class_names
from asf_tpu_torch.visualization import plots, tensorboard_vis
from chip_smoke import WandbStandIn
from test_torch_port_data import vgg_root  # noqa: F401  (fixture)
from test_torch_port_loop import _scalars, _train_cfgs, captured


@pytest.fixture
def wandb(monkeypatch):
    stand_in = WandbStandIn()
    monkeypatch.setitem(sys.modules, "wandb", stand_in)
    return stand_in


def _observer_cfgs(root, jax_side=None):
    out = []
    for side, cfg in ((True, jax_get_cfg()), (False, get_cfg())):
        if jax_side is not None and side != jax_side:
            continue
        cfg.OUTPUT_DIR = os.path.join(root, "jax" if side else "port")
        cfg.TENSORBOARD.ENABLE = True
        cfg.TRAIN.DATASET = "Vggsound"
        out.append(cfg)
    return out


def test_scalar_logger_writes_the_jax_tags_and_steps(tmp_path):
    """The same scalar dicts through both loggers: the same tags, steps and
    values in the event files (exact: float32 scalars either way); a string
    is dropped by both."""
    feed = [({"Train/loss": 1.25, "Train/lr": 0.1, "skipme": "str"}, 0),
            ({"Train/loss": 0.75, "Train/lr": 0.05}, 2), ({"Val/top1_acc": 37.5}, 3)]
    dirs = []
    for cfg, cls in zip(_observer_cfgs(str(tmp_path)),
                        (jax_observers.ScalarLogger, observers.ScalarLogger)):
        lg = cls(cfg)
        for scalars, step in feed:
            lg.log(scalars, global_step=step)
        lg.close()
        dirs.append(os.path.join(cfg.OUTPUT_DIR, "runs-Vggsound"))
    want, got = _scalars(dirs[0]), _scalars(dirs[1])
    assert got == want and set(got) == {"Train/loss", "Train/lr", "Val/top1_acc"}
    assert got["Train/loss"] == [(0, 1.25), (2, 0.75)]


def test_wandb_resume_histograms_and_alerts_match_jax(tmp_path, wandb):
    """With ``WANDB.RUN_ID`` both ``init`` with ``id`` and ``resume="must"``;
    histograms are rebuilt from the counts and the range, edges
    ``linspace(lo, hi, 65)``; ``alert`` calls W&B at WARN and logs a warning."""
    counts = np.zeros(64, np.int64)
    counts[0], counts[-1] = 3, 5
    hists = {"parameters/s1/kernel": {"counts": counts, "lo": -2.0, "hi": 2.0},
             "gradients/s1/kernel": {"counts": counts[::-1], "lo": 0.5, "hi": 0.5}}
    calls = []
    for cfg, cls in zip(_observer_cfgs(str(tmp_path)),
                        (jax_observers.ScalarLogger, observers.ScalarLogger)):
        cfg.TENSORBOARD.ENABLE = False
        cfg.WANDB.ENABLE = True
        cfg.WANDB.RUN_ID = "abc123"
        wandb.calls.clear()
        lg = cls(cfg)
        lg.log({"Train/loss": 1.0}, global_step=4)
        lg.log_histograms(hists, global_step=4)
        with captured("asf_tpu_torch") as log:
            lg.alert("State looking strange", "State predictions < 0.1")
        lg.close()
        calls.append(list(wandb.calls))
        if cls is observers.ScalarLogger:
            assert log.warnings == ["State looking strange: State predictions < 0.1"]
            assert lg.tb is None and lg.wandb_run is not None
    (jinit, *jrest), (init, *rest) = calls
    assert init[1]["id"] == jinit[1]["id"] == "abc123"
    assert init[1]["resume"] == jinit[1]["resume"] == "must"
    assert init[1]["project"] == jinit[1]["project"] and init[1]["dir"].endswith("port")
    assert [c[0] for c in rest] == [c[0] for c in jrest] == ["log", "log", "alert", "finish"]
    for (_, payload, step), (_, jpayload, jstep) in zip(rest[1:2], jrest[1:2]):
        assert step == jstep == 4 and set(payload) == set(jpayload) == set(hists)
        for name in hists:
            (c, e), (jc, je) = payload[name].np_histogram, jpayload[name].np_histogram
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(e, je)  # exact: the same linspace
            assert len(e) == 65
    assert rest[2] == jrest[2] == ("alert", "State looking strange", "State predictions < 0.1",
                                   "WARN")


def test_observers_warn_and_go_on_without_their_packages(tmp_path, monkeypatch):
    """No ``wandb`` module: the logger warns and has no W&B sink; logging,
    histograms and alerts still work."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    (cfg,) = _observer_cfgs(str(tmp_path), jax_side=False)
    cfg.WANDB.ENABLE = True
    with captured("asf_tpu_torch") as log:
        lg = observers.ScalarLogger(cfg)
    assert lg.tb is not None and lg.wandb_run is None
    assert any(w.startswith("wandb disabled") for w in log.warnings)
    lg.log({"Train/loss": 1.0}, global_step=0)
    lg.log_histograms({"x": {"counts": np.ones(64), "lo": 0.0, "hi": 1.0}}, global_step=0)
    lg.close()


@pytest.mark.parametrize("scores", [False, True])
def test_confusion_matrix_counts_match_jax(scores):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 7, 50)
    preds = rng.random((50, 7)) if scores else rng.integers(0, 7, 50)
    for n in (None, 9):
        got = tensorboard_vis.confusion_matrix_counts(preds, labels, n)
        want = jax_tb.confusion_matrix_counts(preds, labels, n)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and got.sum() == 50


def test_plot_helpers_return_figures():
    cm = np.array([[5, 1], [2, 7]], dtype=np.int64)
    assert plots.plot_confusion_matrix(cm, class_names=["a", "b"]) is not None
    assert plots.plot_topk_histogram("Top verbs", np.random.rand(20), k=5) is not None
    assert plots.plot_topk_histogram("Few", np.random.rand(3), k=5) is not None
    assert plots.plot_spectrogram(np.random.randn(64, 32), sr=8000, hop=40) is not None
    assert plots.plot_waveform(np.random.randn(2, 800), 8000) is not None


def test_class_names_match_jax(tmp_path):
    names = {"take": 0, "put": 2, "open": 1, "close": 4}
    parents = {"move": ["take", "put", "throw"], "door": ["open", "close"]}
    for name, obj in (("names.json", names), ("parents.json", parents)):
        (tmp_path / name).write_text(json.dumps(obj))
    (tmp_path / "subset.txt").write_text("open\nthrow\nclose\n")
    args = [str(tmp_path / n) for n in ("names.json", "parents.json", "subset.txt")]
    got, want = get_class_names(*args), jax_get_class_names(*args)
    assert got == want and got[0] == ["take", "open", "put", None, "close"]
    assert got[2] == [1, 4]


def _on_edge(x, lo, hi):
    """Whether float32 ``x`` sits exactly on a bin edge of ``[lo, hi]``."""
    pos = (np.float64(x) - lo) / max(hi - lo, 1e-12) * 64
    return pos == np.round(pos)


def test_watch_summary_matches_jax():
    """``watch_summary`` of the same parameter and gradient numbers: the
    range exact, the counts equal. A count may move only where an element
    lies exactly on a bin edge (the two sides' float32 position rounds to
    the edge on one side only); the test says which, and none here does."""
    rng = np.random.default_rng(0)
    leaves = {"conv": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32) * 1e-3,
              "const": np.full(5, 0.25, np.float32),  # hi == lo: the 1e-12 span
              "edges": np.linspace(-1, 1, 129).astype(np.float32),  # on every edge
              "skew": rng.exponential(size=1000).astype(np.float32)}
    grads = {k: (v * 0.1 + 0.01).astype(np.float32) for k, v in leaves.items()}
    want = jax_steps.watch_summary(leaves, grads)
    counts, ranges = watch_summary([torch.from_numpy(v) for v in (*leaves.values(),
                                                                  *grads.values())])
    names = [f"parameters/{k}" for k in leaves] + [f"gradients/{k}" for k in grads]
    for i, name in enumerate(names):
        w = want[name]
        assert ranges[i, 0].item() == float(w["lo"]) and ranges[i, 1].item() == float(w["hi"])
        got_c, want_c = counts[i].numpy(), np.asarray(w["counts"])
        assert got_c.sum() == want_c.sum() == (leaves if i < len(leaves) else grads)[
            name.split("/")[1]].size
        if not np.array_equal(got_c, want_c):
            x = (leaves if i < len(leaves) else grads)[name.split("/")[1]]
            off_edge = [v for v in x if not _on_edge(v, float(w["lo"]), float(w["hi"]))]
            pytest.fail(f"{name}: counts differ; elements on a bin edge: "
                        f"{x.size - len(off_edge)} of {x.size}")


def test_observers_off_make_no_sink(tmp_path, wandb):
    """With TensorBoard and W&B off nothing is written and no W&B run starts,
    though a ``wandb`` module is there; alerts still log a warning."""
    (cfg,) = _observer_cfgs(str(tmp_path), jax_side=False)
    cfg.TENSORBOARD.ENABLE = False
    lg = observers.ScalarLogger(cfg)
    assert lg.tb is None and lg.wandb_run is None
    lg.log({"Train/loss": 1.0}, global_step=0)
    lg.log_histograms({"x": {"counts": np.ones(64), "lo": 0.0, "hi": 1.0}}, global_step=0)
    with captured("asf_tpu_torch") as log:
        lg.alert("state_loss >= 40", "Anomalous state loss: 41")
    lg.close()
    assert log.warnings == ["state_loss >= 40: Anomalous state loss: 41"]
    assert not wandb.calls and not os.path.exists(cfg.OUTPUT_DIR)


def test_port_model_parameters_all_watched():
    """Every parameter of the port's model maps onto a JAX tree path."""
    from test_torch_port_loop import _model_cfg

    model = build_model(_model_cfg(get_cfg(), False), "cpu")
    from asf_tpu_torch.engine.steps import watch_name

    sd = model.state_dict()
    tree = jax_torch_state_to_flax({k: v.numpy() for k, v in sd.items()})["params"]
    paths = {jax_steps._watch_name(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert {watch_name(n, p.dim()) for n, p in model.named_parameters()} == paths


def test_val_plot_rows_across_ranks_are_the_whole_val_set(vgg_root, tmp_path):  # noqa: F811
    """Two gloo ranks (``run_net.launch_job``, spawned): rank 0's writer gets
    the val set's 10 score rows and labels, gathered from both ranks in the
    order of one process's (labels equal, scores within 1e-6: the loop's
    float32 across ranks, tests/test_torch_port_dist_loop.py's bound)."""
    import pickle

    import torch_dist_ranks
    from asf_tpu_torch.tools.run_net import launch_job

    _, pcfg = _train_cfgs(vgg_root, str(tmp_path))
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    pcfg.TENSORBOARD.ENABLE = True
    pcfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
    rows = []
    for ranks in (1, 2):
        cfg = pcfg.clone()
        cfg.NUM_GPUS = ranks
        cfg.OUTPUT_DIR = str(tmp_path / f"ranks{ranks}")
        launch_job(cfg, f"tcp://localhost:{torch_dist_ranks.free_port()}",
                   torch_dist_ranks.plot_rows, "cpu")
        with open(os.path.join(cfg.OUTPUT_DIR, "plot_rows.pkl"), "rb") as f:
            (got,) = pickle.load(f)
        rows.append(got)
    (one_p, one_l), (two_p, two_l) = rows
    assert one_p.shape == two_p.shape == (10, 6)
    np.testing.assert_array_equal(two_l, one_l)
    np.testing.assert_allclose(two_p, one_p, rtol=0, atol=1e-6)
