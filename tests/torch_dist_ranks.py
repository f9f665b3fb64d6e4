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
