"""Data parallelism of the port over 4 gloo ranks on the CPU, against ``asf_tpu`` on 4 devices.

* The grouped batch norm (``models/norm.py``) in 4 spawned ranks, 2 rows
  each, against ``asf_tpu.models.norm.TorchBatchNorm`` over the 8 rows
  together: ``batchnorm`` (global), ``sync_batchnorm`` with k = 2 and 1,
  ``sub_batchnorm`` with 2 and 8 splits. The outputs, the input gradients
  and the parameter gradients (summed over the ranks, as DDP's mean of the
  ranks' ``sum(y * t) / 8``) of the first step, and the running statistics
  after two steps, equal on every rank: within 1e-5. A split count or k
  that cuts a split at a rank's boundary raises.
* The loader's rows of each rank against ``asf_tpu``'s ``pad_batch_to``
  then ``shard_batch`` over 4 of the tests' 8 virtual devices.
* Each model family of the port (EPIC verb/noun, the GRU, the GRU and
  single-clip state heads, the Slow-only R50) trains through
  ``DistributedDataParallel`` in 2 spawned ranks (``run_net.run_rank``), 2
  to 4 steps of ``train(cfg)``: no parameter goes without a gradient, so
  the wrapper needs no ``find_unused_parameters``.
* The roles and refusals: only rank 0 writes a checkpoint and every rank
  waits at the barrier after it; ``NUM_GPUS`` above the CUDA device count
  raises in ``run_net.launch_job``; ``train(cfg)`` and ``test(cfg)`` with
  more than one device and no process group raise, naming ``run_net``.

``train(cfg)`` and ``test(cfg)`` over 4 ranks are in
``test_torch_port_dist_loop.py``.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from asf_tpu.data import loader as jax_loader
from asf_tpu.models.norm import TorchBatchNorm
from asf_tpu.parallel.mesh import make_mesh, pad_batch_to, shard_batch
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data import loader
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.engine.steps import TrainState
from asf_tpu_torch.parallel import dist
from asf_tpu_torch.tools import run_net
from test_torch_port_data import vgg_cfgs, vgg_root  # noqa: F401  (fixture)
from test_torch_port_epic import _loop_cfgs as epic_loop_cfgs
from test_torch_port_epic import epic_root  # noqa: F401  (fixture)
from test_torch_port_gru import _loop_cfgs as gru_loop_cfgs
from test_torch_port_gru import gru_root  # noqa: F401  (fixture)
from test_torch_port_resnet import _loop_cfgs as resnet_loop_cfgs
from test_torch_port_state import _loop_cfgs as state_loop_cfgs
from test_torch_port_state import state_root  # noqa: F401  (fixture)
from torch_dist_ranks import (BAD_CASES, BN_CASES, ROWS, bn_inputs, bn_params, bn_rank,
                              ddp_families, free_port)

WORLD = 4
TOL = 1e-5


# --------------------------------------------------------------------------
# the grouped batch norm over 4 ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bn_ranks"))
    mp.spawn(bn_rank, args=(WORLD, f"tcp://localhost:{free_port()}", out), nprocs=WORLD,
             join=True)
    return [torch.load(os.path.join(out, f"bn_rank{r}.pt")) for r in range(WORLD)]


def _nhwc(a):
    return jax.numpy.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def _jax_bn(name):
    norm_type, splits, k = BN_CASES[name]
    num_splits = {"batchnorm": 1, "sub_batchnorm": splits, "sync_batchnorm": WORLD // k}
    return TorchBatchNorm(features=6, num_splits=num_splits[norm_type],
                          unbiased_running=norm_type != "sync_batchnorm")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(BN_CASES))
def test_grouped_norm_over_ranks_matches_jax_over_the_whole_batch(bn_runs, name):
    w, b = bn_params()
    bn = _jax_bn(name)
    params = {"scale": jax.numpy.asarray(w), "bias": jax.numpy.asarray(b)}
    stats = {"mean": jax.numpy.zeros(6), "var": jax.numpy.ones(6)}
    assert all(r[name]["type"] == "GroupedBatchNorm2d" for r in bn_runs)
    for step in range(2):
        x, t = bn_inputs(step, WORLD)

        def loss(p, xj, stats=stats, t=t):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xj,
                              use_running_average=False, mutable=["batch_stats"])
            return (y * _nhwc(t)).sum() / x.shape[0], (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, _nhwc(x))
        y, gx = np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2)
        for r, rec in enumerate(bn_runs):
            rows = slice(r * ROWS, (r + 1) * ROWS)
            _close(rec[name][f"y{step}"], y[rows])
            if step == 0:
                _close(rec[name]["dx"], gx[rows])
                _close(rec[name]["dw"], gp["scale"])
                _close(rec[name]["db"], gp["bias"])
    for rec in bn_runs:
        assert torch.equal(rec[name]["running_mean"], bn_runs[0][name]["running_mean"])
        assert torch.equal(rec[name]["running_var"], bn_runs[0][name]["running_var"])
    _close(bn_runs[0][name]["running_mean"], stats["mean"])
    _close(bn_runs[0][name]["running_var"], stats["var"])


@pytest.mark.parametrize("name", list(BAD_CASES))
def test_splits_that_cut_a_rank_raise(bn_runs, name):
    """``NUM_SYNC_DEVICES`` 3 or ``NUM_SPLITS`` 3 over 4 ranks raise ``ValueError``."""
    messages = [r[name] for r in bn_runs]
    assert all(m is not None for m in messages), messages
    assert all(("does not divide" in m) or ("do not fit" in m) for m in messages), messages


# --------------------------------------------------------------------------
# the rows of each rank
# --------------------------------------------------------------------------

def _shard(array, r):
    """Device ``r``'s rows of a batch sharded over the mesh's data axis."""
    shards = sorted(array.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.asarray(shards[r].data)


@pytest.mark.parametrize("split", ["train", "val"])
def test_each_rank_reads_the_rows_of_its_jax_device(vgg_root, split):  # noqa: F811
    """Rank r's batches (and the last val batch's ``n_real``) against the
    shard of ``asf_tpu``'s device r after ``pad_batch_to`` and
    ``shard_batch`` over a mesh of 4 devices, epoch 1, bit for bit."""
    jcfg, pcfg = vgg_cfgs(vgg_root, train_list="all.pkl", val_list="val.pkl")
    jcfg.TPU.DATA_PARALLEL = 0
    jcfg.NUM_GPUS = WORLD
    mesh = make_mesh(jcfg)
    jld = jax_loader.construct_loader(jcfg, split)
    jld.set_epoch(1)
    want = []
    for batch in jld:
        batch.pop("metadata")
        batch, n_real = pad_batch_to(batch, 4)
        sharded = shard_batch(batch, mesh)
        arrays = {k: sharded[k] for k in ("waveform", "n_valid", "index")}
        arrays["label"] = sharded["labels"]["class_id"]
        want.append(([{k: _shard(a, r) for k, a in arrays.items()} for r in range(WORLD)],
                     n_real))
    jld.close()
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    for r in range(WORLD):
        ld = loader.construct_loader(pcfg, split)
        ld.local_rank, ld.local_size = r, WORLD
        ld.set_epoch(1)
        got = list(ld)
        assert len(got) == len(want)
        for batch, (shards, n_real) in zip(got, want):
            for k in ("waveform", "n_valid", "index"):
                np.testing.assert_array_equal(batch[k], shards[r][k])
            np.testing.assert_array_equal(batch["labels"]["class_id"], shards[r]["label"])
            assert batch["host_rows"] == n_real
            assert batch["n_real"] == max(0, min(1, n_real - r))


def test_every_host_tests_on_the_whole_test_set(vgg_root):  # noqa: F811
    """The test loader of host 1 of 2 holds every test clip, where its
    train and val loaders hold their host's share."""
    _, pcfg = vgg_cfgs(vgg_root, train_list="all.pkl", val_list="val.pkl")
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    pcfg.NUM_SHARDS, pcfg.SHARD_ID = 2, 1
    one = pcfg.clone()
    one.NUM_SHARDS, one.SHARD_ID = 1, 0
    test_ld, whole = loader.construct_loader(pcfg, "test"), loader.construct_loader(one, "test")
    assert (test_ld.rank, test_ld.world_size) == (0, 1)
    assert [b["index"].tolist() for b in test_ld] == [b["index"].tolist() for b in whole]
    val_ld = loader.construct_loader(pcfg, "val")
    assert (val_ld.rank, val_ld.world_size) == (1, 2)


# --------------------------------------------------------------------------
# every parameter of each model family gets a gradient through the wrapper
# --------------------------------------------------------------------------

FAMILIES = ("epic", "gru", "gru_state", "state", "slow_r50")
DDP_RANKS = 2


@pytest.fixture(scope="module")
def ddp_runs(epic_root, gru_root, state_root, vgg_root, tmp_path_factory):  # noqa: F811
    """Each family's tiny ``train(cfg)`` of the port's tests at ``NUM_GPUS 2``."""
    out = str(tmp_path_factory.mktemp("ddp_families"))
    loops = {"epic": lambda o: epic_loop_cfgs(epic_root, o),
             "gru": lambda o: gru_loop_cfgs(gru_root, o),
             "gru_state": lambda o: state_loop_cfgs(state_root, o, gru=True),
             "state": lambda o: state_loop_cfgs(state_root, o, gru=False),
             "slow_r50": lambda o: resnet_loop_cfgs(vgg_root, o, "slow")}
    cfgs = []
    for name in FAMILIES:
        _, cfg = loops[name](os.path.join(out, name))
        cfg.NUM_GPUS = DDP_RANKS
        cfg.BN.USE_PRECISE_STATS = False
        cfg.TRAIN.CHECKPOINT_PERIOD = 10
        cfgs.append((name, cfg))
    body = functools.partial(ddp_families, cfgs=cfgs, out=out)
    mp.spawn(run_net.run_rank, args=(cfgs[0][1], f"tcp://localhost:{free_port()}", body,
                                     "cpu", "gloo"), nprocs=DDP_RANKS, join=True)
    return [torch.load(os.path.join(out, f"ddp_rank{r}.pt")) for r in range(DDP_RANKS)]


@pytest.mark.parametrize("family", FAMILIES)
def test_every_parameter_gets_a_gradient_through_the_wrapper(ddp_runs, family):
    """Two or more steps through ``DistributedDataParallel`` (a parameter
    with no gradient would make the second raise), then every parameter
    holds a gradient, on every rank."""
    for rec in ddp_runs:
        got = rec[family]
        assert got["wrapper"] == "DistributedDataParallel" and got["steps"] >= 2, got
        assert got["no_grad"] == [], got["no_grad"]


# --------------------------------------------------------------------------
# roles and refusals
# --------------------------------------------------------------------------

def test_only_rank_zero_writes_a_checkpoint_and_every_rank_waits(tmp_path, monkeypatch):
    model = torch.nn.Linear(2, 2)
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                       generator=torch.Generator())
    waits = []
    monkeypatch.setattr(dist, "barrier", lambda: waits.append(1))
    monkeypatch.setattr(dist, "is_primary", lambda: False)
    path = cu.save_checkpoint(str(tmp_path), state, 0, get_cfg())
    assert not os.path.exists(path) and waits == [1]
    monkeypatch.setattr(dist, "is_primary", lambda: True)
    assert cu.save_checkpoint(str(tmp_path), state, 0, get_cfg()) == path
    assert os.path.exists(path) and waits == [1, 1]
    assert set(torch.load(path)["model_state"]) == {"weight", "bias"}


def test_num_gpus_above_the_device_count_raises():
    cfg = get_cfg()
    cfg.NUM_GPUS = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        run_net.launch_job(cfg, "tcp://localhost:9999", train)


@pytest.mark.parametrize("entry", [train, port_test])
@pytest.mark.parametrize("key", ["NUM_SHARDS", "NUM_GPUS"])
def test_more_than_one_device_without_a_group_names_run_net(entry, key):
    cfg = get_cfg()
    cfg[key] = 2
    with pytest.raises(RuntimeError, match="run_net"):
        entry(cfg, device="cpu")
