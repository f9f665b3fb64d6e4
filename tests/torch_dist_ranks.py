"""Rank bodies that ``tests/test_torch_port_dist.py`` spawns (gloo, on the CPU).

Kept apart from the test module so that a spawned rank imports torch and
the port only, not JAX.
"""

import os
import socket

import numpy as np
import torch
import torch.distributed as tdist

from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.models.norm import make_norm

C = 6
ROWS = 2  # a rank's rows; the global batch is ROWS * world
# name -> (BN.NORM_TYPE, BN.NUM_SPLITS, BN.NUM_SYNC_DEVICES)
BN_CASES = {
    "batchnorm": ("batchnorm", 1, 1),
    "sync-k2": ("sync_batchnorm", 1, 2),
    "sync-k1": ("sync_batchnorm", 1, 1),
    "sub-s2": ("sub_batchnorm", 2, 1),
    "sub-s8": ("sub_batchnorm", 8, 1),
}
# configurations that must raise at world size 4: (NORM_TYPE, NUM_SPLITS, NUM_SYNC_DEVICES)
BAD_CASES = {"sync-k3": ("sync_batchnorm", 1, 3), "sub-s3": ("sub_batchnorm", 3, 1)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def bn_inputs(step: int, world: int):
    """The global batch of ``step`` (x, t, each ``(ROWS * world, C, 5, 4)``)."""
    rng = np.random.default_rng(100 + step)
    shape = (ROWS * world, C, 5, 4)
    x = (rng.standard_normal(shape) * 2 + rng.uniform(-3, 3, (1, C, 1, 1))).astype(np.float32)
    return x, rng.standard_normal(shape).astype(np.float32)


def bn_params():
    rng = np.random.default_rng(11)
    return (rng.uniform(0.5, 1.5, C).astype(np.float32),
            rng.standard_normal(C).astype(np.float32) * 0.1)


def _cfg(norm_type, splits, k):
    cfg = get_cfg()
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS, cfg.BN.NUM_SYNC_DEVICES = norm_type, splits, k
    return cfg


def bn_rank(rank: int, world: int, init_method: str, out: str) -> None:
    """Every case of ``BN_CASES`` on this rank's rows: two train steps of the
    loss ``sum(y * t) / global rows`` summed over ranks; saves the outputs,
    the first step's input gradient and its parameter gradients summed over
    the ranks, and the running statistics after both, to ``out``."""
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        w, b = bn_params()
        got = {}
        for name, (norm_type, splits, k) in BN_CASES.items():
            m = make_norm(_cfg(norm_type, splits, k))(C).train()
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(w))
                m.bias.copy_(torch.from_numpy(b))
            rec = {"type": type(m).__name__}
            for step in range(2):
                x, t = bn_inputs(step, world)
                rows = slice(rank * ROWS, (rank + 1) * ROWS)
                xt = torch.from_numpy(x[rows]).requires_grad_(True)
                m.weight.grad = m.bias.grad = None
                y = m(xt)
                ((y * torch.from_numpy(t[rows])).sum() / x.shape[0]).backward()
                rec[f"y{step}"] = y.detach()
                if step == 0:
                    grads = torch.stack([m.weight.grad, m.bias.grad])
                    tdist.all_reduce(grads)
                    rec["dx"], rec["dw"], rec["db"] = xt.grad, grads[0], grads[1]
            rec["running_mean"], rec["running_var"] = m.running_mean.clone(), m.running_var.clone()
            got[name] = rec
        for name, (norm_type, splits, k) in BAD_CASES.items():
            try:
                make_norm(_cfg(norm_type, splits, k))
                got[name] = None
            except ValueError as e:
                got[name] = str(e)
        torch.save(got, os.path.join(out, f"bn_rank{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def ddp_families(cfg, device, cfgs, out):
    """``run_rank``'s body: ``train(c)`` of each ``(name, c)`` of ``cfgs`` in
    this process group, through ``DistributedDataParallel`` without
    ``find_unused_parameters`` (which raises at the next step when a
    parameter got no gradient); saves, by name, the steps taken, the
    wrapper's class and the parameters left with no gradient after the last
    step, to ``out``."""
    from asf_tpu_torch.engine import train

    got = {}
    for name, c in cfgs:
        state = train(c, device=device)
        got[name] = {"steps": state.step, "wrapper": type(state.ddp).__name__,
                     "no_grad": [k for k, p in state.model.named_parameters()
                                 if p.requires_grad and p.grad is None]}
    torch.save(got, os.path.join(out, f"ddp_rank{tdist.get_rank()}.pt"))


class PlotRecorder:
    """A TensorBoard writer that keeps the rows ``eval_epoch`` plots."""

    def __init__(self):
        self.rows = []

    def add_confusion_matrix(self, preds, labels, **kwargs):
        self.rows.append((preds, labels))

    def add_topk_histograms(self, preds, labels, **kwargs):
        pass


def plot_rows(cfg, device):
    """``eval_epoch`` of a seeded model over the val split with the plots
    on; rank 0 (or the one process) pickles the rows its writer got to
    ``OUTPUT_DIR/plot_rows.pkl``."""
    import pickle
    import types

    from asf_tpu_torch.data.loader import construct_loader
    from asf_tpu_torch.engine.eval_loop import build_val_meter, eval_epoch
    from asf_tpu_torch.engine.steps import make_eval_step
    from asf_tpu_torch.models import build_model
    from asf_tpu_torch.parallel import dist

    model = build_model(cfg, device, torch.Generator().manual_seed(3))
    loader = construct_loader(cfg, "val")
    sink = types.SimpleNamespace(tb=PlotRecorder() if dist.is_primary() else None)
    try:
        eval_epoch(loader, model, make_eval_step(cfg, device), build_val_meter(cfg, len(loader)),
                   0, cfg, device, sink)
    finally:
        loader.close()
    if dist.is_primary():
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.OUTPUT_DIR, "plot_rows.pkl"), "wb") as f:
            pickle.dump(sink.tb.rows, f)


# --------------------------------------------------------------------------
# tensor parallelism (tests/test_torch_port_tensor.py, test_torch_port_cuda.py)
# --------------------------------------------------------------------------

def tp_layers(device="cpu"):
    """A float64 conv (16 -> 256, 3x3), a grouped conv (256 -> 256, 1x3, 4
    groups) and a linear (32 -> 256), seeded alike wherever they are made."""
    from torch import nn

    from asf_tpu_torch.models.layers import Conv2d

    g = torch.Generator().manual_seed(21)
    mods = nn.ModuleDict({
        "conv": Conv2d(16, 256, (3, 3), (1, 1), (1, 1), dtype=torch.float64),
        "grouped": Conv2d(256, 256, (1, 3), (1, 1), (0, 1), groups=4, dtype=torch.float64),
        "linear": nn.Linear(32, 256)}).double()
    with torch.no_grad():
        for p in mods.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64) * 0.1)
    return mods.to(device)


def tp_forward(mods, device="cpu") -> dict:
    """Each layer of ``tp_layers`` on seeded float64 inputs, then the
    backward of ``sum(y * t)``: the outputs, the input gradients and the
    parameter gradients (a sharded layer's: its block), on the CPU."""
    from asf_tpu_torch.parallel import tensor

    rng = np.random.default_rng(22)
    shapes = {"conv": ((2, 16, 5, 4), (2, 256, 5, 4)), "grouped": ((2, 256, 5, 4), (2, 256, 5, 4)),
              "linear": ((2, 3, 32), (2, 3, 256))}
    out, loss = {}, 0.0
    xs = {}
    for name, (xs_shape, t_shape) in shapes.items():
        x = torch.from_numpy(rng.standard_normal(xs_shape)).to(device).requires_grad_(True)
        t = torch.from_numpy(rng.standard_normal(t_shape)).to(device)
        y = (tensor.linear(x, mods[name], torch.float64) if name == "linear"
             else mods[name](x))
        loss = loss + (y * t).sum()
        xs[name] = x
        out[f"y_{name}"] = y.detach().cpu()
    loss.backward()
    for name, x in xs.items():
        out[f"dx_{name}"] = x.grad.cpu()
    for k, p in mods.named_parameters():
        out[f"d_{k}"] = p.grad.cpu()
    return out


def tp_functions_rank(cfg, device, out):
    """``run_rank``'s body for the autograd Functions alone: ``tp_layers``
    sharded over this rank's model group, ``tp_forward``; saves the names
    sharded and the results to ``out``."""
    from asf_tpu_torch.parallel import tensor

    mods = tp_layers(device)
    names = tensor.shard_model(mods, cfg)
    got = {"names": names, **tp_forward(mods, device)}
    torch.save(got, os.path.join(out, f"tp_rank{tdist.get_rank()}.pt"))


# name -> (BN.NORM_TYPE, BN.NUM_SYNC_DEVICES) of the grouped norm on a 2 x 2 grid
GRID_BN_CASES = {"batchnorm": ("batchnorm", 1), "sync-k2": ("sync_batchnorm", 2),
                 "sync-k1": ("sync_batchnorm", 1)}


def grid_bn(cfg) -> dict:
    """Each case of ``GRID_BN_CASES`` on this rank's data rank's ``ROWS``
    rows of ``bn_inputs`` (the global batch of every data rank's rows): two
    train steps of ``sum(y * t) / global rows``; the outputs, the first
    step's input gradient and parameter gradients (summed over the data
    ranks), the running statistics after both."""
    from asf_tpu_torch.parallel import dist

    w, b = bn_params()
    ranks, group = dist.data_size(cfg), dist.data_group(cfg)
    rows = slice(dist.data_rank(cfg) * ROWS, (dist.data_rank(cfg) + 1) * ROWS)
    got = {}
    for name, (norm_type, k) in GRID_BN_CASES.items():
        c = cfg.clone()
        c.BN.NORM_TYPE, c.BN.NUM_SYNC_DEVICES = norm_type, k
        m = make_norm(c)(C).train()
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
        rec = {"type": type(m).__name__, "splits": m.num_splits}
        for step in range(2):
            x, t = bn_inputs(step, ranks)
            xt = torch.from_numpy(x[rows]).requires_grad_(True)
            m.weight.grad = m.bias.grad = None
            y = m(xt)
            ((y * torch.from_numpy(t[rows])).sum() / x.shape[0]).backward()
            rec[f"y{step}"] = y.detach()
            if step == 0:
                grads = torch.stack([m.weight.grad, m.bias.grad])
                tdist.all_reduce(grads, group=group)
                rec["dx"], rec["dw"], rec["db"] = xt.grad, grads[0], grads[1]
        rec["running_mean"], rec["running_var"] = m.running_mean.clone(), m.running_var.clone()
        got[name] = rec
    return got


def step_batch(cfg, rows: int, seed: int = 9) -> dict:
    """A seeded verb/noun batch of ``rows`` float32 clips of ``cfg``'s geometry."""
    rng = np.random.default_rng(seed)
    s = int(round(cfg.AUDIO_DATA.SAMPLING_RATE * cfg.AUDIO_DATA.CLIP_SECS)) - 1
    return {"waveform": (rng.standard_normal((rows, s)) * 0.1).astype(np.float32),
            "n_valid": np.full((rows,), s, np.int32),
            "labels": {"verb": rng.integers(0, cfg.MODEL.NUM_CLASSES[0], rows),
                       "noun": rng.integers(0, cfg.MODEL.NUM_CLASSES[1], rows)}}


def grid_step(cfg, device, rows: int = 4) -> dict:
    """One train step (``make_train_step`` with the watch histograms) of
    ``cfg``'s model, weights from seed 5, on this data rank's rows of
    ``step_batch``: sharded and wrapped as ``train(cfg)`` does in a process
    group, as it is in one process. Returns the step's numbers, the whole
    model after it, and each leaf's histogram counts and range."""
    from torch.nn.parallel import DistributedDataParallel

    from asf_tpu_torch.engine.steps import init_state, make_train_step
    from asf_tpu_torch.models import build_model
    from asf_tpu_torch.parallel import dist, tensor

    model = build_model(cfg, device, torch.Generator().manual_seed(5))
    state = init_state(cfg, model)
    names = tensor.shard_model(model, cfg, state.optimizer)
    if dist.is_initialized():
        state.ddp = DistributedDataParallel(model, broadcast_buffers=False,
                                            process_group=dist.data_group(cfg))
    lo, hi = dist.host_rows(dist.local_rank(cfg), dist.local_size(cfg), rows)
    host = step_batch(cfg, rows)
    batch = {"waveform": torch.from_numpy(host["waveform"][lo:hi]).to(device),
             "n_valid": torch.from_numpy(host["n_valid"][lo:hi]).to(device),
             "labels": {k: torch.from_numpy(v[lo:hi]).to(device)
                        for k, v in host["labels"].items()}}
    dist.CALLS.clear()
    parts, _ = make_train_step(cfg, device, watch=True)(state, batch, 0.05)
    calls = dict(dist.CALLS)
    names_w, counts, ranges = parts.pop("watch")
    whole, _ = tensor.full_state_dicts(model, state.optimizer, tensor.model_shard(cfg))
    return {"parts": {k: v.item() for k, v in parts.items()}, "sharded": names, "calls": calls,
            "model": whole, "watch": dict(zip(names_w, zip(counts.cpu(), ranges.cpu())))}


def grid_rank(cfg, device, out, step_cfg, train_cfg):
    """``run_rank``'s body on a 2 x 2 grid (``cfg``): the grid's numbers,
    the autograd Functions (``tp_functions_rank``), ``grid_bn``, the same
    world read at ``GPU.MODEL_PARALLEL`` 1, ``grid_step`` of ``step_cfg``,
    then ``train(train_cfg)`` with the head's dropout masks recorded and
    each parameter's and momentum's shape after it; saves to ``out``."""
    import torch.nn.functional as F

    from asf_tpu_torch.engine import train
    from asf_tpu_torch.parallel import dist, tensor

    tp_functions_rank(cfg, device, out)
    got = {"grid": (dist.data_rank(cfg), dist.model_rank(cfg), dist.data_size(cfg),
                    dist.model_size(cfg), dist.local_rank(cfg), dist.local_size(cfg)),
           "bn": grid_bn(cfg)}
    one = cfg.clone()
    one.GPU.MODEL_PARALLEL, one.NUM_GPUS = 1, dist.world_size()
    model = tp_layers(device)
    before = {k: p for k, p in model.named_parameters()}
    got["mp1"] = {
        "grid": (dist.data_rank(one), dist.model_rank(one), dist.data_size(one),
                 dist.model_size(one), dist.local_rank(one), dist.local_size(one)),
        "world_groups": (dist.data_group(one) is None, dist.host_group(one) is None),
        "sync_bn_splits": dist.sync_bn_splits(one), "sharded": tensor.shard_model(model, one),
        "kept": all(p is before[k] and not tensor.is_sharded(p)
                    for k, p in model.named_parameters()),
        "norms": {name: (type(m).__name__, getattr(m, "num_splits", None))
                  for name, (norm_type, k) in GRID_BN_CASES.items()
                  for m in [make_norm(_cfg(norm_type, 1, k))(C)]}}
    got["step"] = grid_step(step_cfg, device)

    masks, dropout = [], F.dropout

    def recording(x, p=0.5, training=True, inplace=False):
        y = dropout(x, p, training, inplace)
        if training:
            masks.append(np.packbits((y != 0).cpu().numpy()))
        return y

    F.dropout = recording
    try:
        state = train(train_cfg, device=device)
    finally:
        F.dropout = dropout
    got["train"] = {
        "masks": masks, "step": state.step,
        "shapes": {k: tuple(p.shape) for k, p in state.model.named_parameters()},
        "momentum": {k: tuple(state.optimizer.state[p]["momentum_buffer"].shape)
                     for k, p in state.model.named_parameters() if p in state.optimizer.state},
        "sharded": [k for k, p in state.model.named_parameters() if tensor.is_sharded(p)]}
    torch.save(got, os.path.join(out, f"grid_rank{dist.rank()}.pt"))
