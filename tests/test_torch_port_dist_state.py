"""The GRU state model's ``train(cfg)`` in 4 gloo ranks on the CPU, against ``asf_tpu`` on 4 devices.

``run_net --device cpu`` at ``NUM_GPUS 4`` trains the tiny GRU state model of
``test_torch_port_state.py`` (one epoch of 4 steps of 4 chains, one chain a
rank, BN frozen but for the stems, no precise BN; val in 4, 4 and 2 chains)
from a seeded ``.pyth``, against ``asf_tpu.engine.train`` at ``NUM_GPUS 4``
on 4 of the tests' 8 virtual devices. The chains hold 1 or 2 windows, so
the ranks of a step keep different numbers of state windows: the state
loss is the mean over the kept windows of the whole batch, which each rank
must divide by the count over every rank, not by its own. Bounds as in the
one-process test: every leaf within 1e-4 relative L2, the epoch losses
within 1e-4, the val record's state means within 1e-6.
"""

import json
import os

import jax
import numpy as np
import pytest

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.engine import train as jax_train
from asf_tpu.engine import train_loop as jax_train_loop
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.data import loader
from asf_tpu_torch.tools import run_net
from test_torch_port_epic import epic_root  # noqa: F401  (fixture)
from test_torch_port_loop import _rel_l2, captured
from test_torch_port_state import _jitted_init_state, _loop_cfgs, _start_pyth
from test_torch_port_state import state_root  # noqa: F401  (fixture)
from torch_dist_ranks import free_port

WORLD = 4
LEAF_TOL, LOSS_TOL, STATE_TOL = 1e-4, 1e-4, 1e-6


def _json_stats(path):
    with open(path) as f:
        return [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                if "json_stats: " in line]


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


@pytest.fixture(scope="module")
def runs(state_root, tmp_path_factory):  # noqa: F811
    """Both trains from one start: (port cfg, port records, JAX variables, JAX records)."""
    out = str(tmp_path_factory.mktemp("dist_state"))
    jcfg, pcfg = _loop_cfgs(state_root, out, gru=True)
    start = _start_pyth(pcfg, os.path.join(out, "start.pyth"), 5)
    for cfg in (jcfg, pcfg):
        cfg.NUM_GPUS = WORLD
        cfg.TRAIN.CHECKPOINT_FILE_PATH = start
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    jcfg.TPU.DATA_PARALLEL = 0  # NUM_GPUS devices

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
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    assert int(payload["step"]) == 4
    return pcfg, pstats, jax.tree.map(np.asarray, payload["model_state"]), jlog.stats


def test_the_ranks_of_a_step_keep_different_numbers_of_state_windows(runs):
    """The data makes the case: some host batch mixes chains of 1 and 2 windows."""
    pcfg, *_ = runs
    cfg = pcfg.clone()
    cfg.NUM_GPUS = 1
    ld = loader.construct_loader(cfg, "train")
    loader.shuffle_dataset(ld, 0)
    lengths = [b["lengths"].tolist() for b in ld]
    assert len(lengths) == 4 and any(len(set(ls)) > 1 for ls in lengths), lengths


def test_gru_state_train_over_four_ranks_matches_jax_on_four_devices(runs):
    """Every leaf within 1e-4 relative L2 of ``asf_tpu``'s, the state
    projections among them."""
    pcfg, _, variables, _ = runs
    got = cu.load_checkpoint(cu.get_path_to_checkpoint(pcfg.OUTPUT_DIR, 1))["model_state"]
    want = flax_variables_to_torch_state(variables)
    assert set(got) == set(want)
    worst = {k: _rel_l2(got[k], w) for k, w in want.items()
             if not k.endswith("num_batches_tracked")}
    assert max(worst.values()) <= LEAF_TOL, max(worst.items(), key=lambda kv: kv[1])


def test_gru_state_losses_and_val_over_four_ranks_match_jax(runs):
    """The epoch's losses (the state loss a global mean) within 1e-4 and
    the val record's 14 state means within 1e-6."""
    _, pstats, _, jstats = runs
    (jep,), (pep,) = _records(jstats, "train_epoch"), _records(pstats, "train_epoch")
    for k in ("loss", "verb_loss", "noun_loss", "state_loss"):
        assert abs(pep[k] - jep[k]) <= LOSS_TOL, (k, pep[k], jep[k])
    for j, p in zip(_records(jstats, "train_iter"), _records(pstats, "train_iter")):
        assert abs(p["state_loss"] - j["state_loss"]) <= LOSS_TOL, (p, j)
    (jval,), (pval,) = _records(jstats, "val_epoch"), _records(pstats, "val_epoch")
    state_keys = [k for k in jval if k.startswith("Val/state/")]
    assert len(state_keys) == 14 and set(state_keys) <= set(pval)
    for k in state_keys:
        assert abs(pval[k] - jval[k]) <= STATE_TOL, (k, pval[k], jval[k])
