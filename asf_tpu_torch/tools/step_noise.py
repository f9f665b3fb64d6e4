"""How far float32 steps of the flagship part, from float64 and from each other, on one card.

    python -m asf_tpu_torch.tools.step_noise

The yardstick for ``chip_smoke.py`` phase 11's comparison of two gloo ranks
on one card with one process. Float32 with TF32 off, B = 64, dropout and
SpecAugment off, weights from a seed:

1. one step's gradients (a seeded batch of clips) against float64: one
   process with ``batchnorm`` (cuDNN; then with cuDNN off, and with its
   deterministic algorithms) and with ``sync_batchnorm`` at world size 1
   (the port's grouped norm), and two gloo ranks on ``cuda:0`` with
   ``batchnorm`` (32 rows each, gradients averaged), each as the relative
   L2 of the whole gradient and its worst norm and other leaf; and the two
   ranks' against one process's, both float32;
2. ``train(cfg)`` on a synthetic VGG-Sound set (LR 1e-3, no precise BN)
   after 1 and 3 steps: the update of the parameters together of one
   process under cuDNN's benchmark mode (other algorithms) and of two gloo
   ranks, each against one process's, as relative L2.

Prints one line a comparison; needs a CUDA device and ``nvcc`` for the
log-mel kernel. Writes its data into a temporary directory.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp


def _cfg(norm_type: str = "batchnorm"):
    from ..entry import flagship_cfg

    cfg = flagship_cfg()
    cfg.GPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.GPU.SPEC_AUGMENT = False
    cfg.BN.NORM_TYPE = norm_type
    return cfg


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def step_gradients(cfg, device, rows: slice, dtype=torch.float32) -> dict:
    """Parameter gradients of one step on ``rows`` of a seeded batch of 64 clips."""
    from ..engine.pipeline import make_input_pipeline
    from ..entry import clip_samples
    from ..models import build_model
    from ..models.losses import cross_entropy
    from ..utils.torch_setup import disable_tf32

    disable_tf32()
    s, rng = clip_samples(cfg), np.random.default_rng(3)
    wave = torch.from_numpy(rng.standard_normal((64, s)).astype(np.float32) * 0.1).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.MODEL.NUM_CLASSES[0], 64)).to(device)
    paths = make_input_pipeline(cfg, device)(wave, torch.full((64,), s, dtype=torch.int32,
                                                              device=device))
    model = build_model(cfg, device, torch.Generator().manual_seed(0)).to(dtype).train()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    cross_entropy(model([p[rows].to(dtype) for p in paths]), labels[rows]).backward()
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}


def _rank_gradients(rank: int, port: int, out: str) -> None:
    import torch.distributed as tdist

    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                             rank=rank)
    try:
        cfg = _cfg()
        cfg.NUM_GPUS = 2
        grads = step_gradients(cfg, torch.device("cuda", 0), slice(32 * rank, 32 * rank + 32))
        for g in grads.values():
            tdist.all_reduce(g)
            g /= 2
        torch.save(grads, os.path.join(out, f"grads{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def _rel(got: dict, want: dict, keys) -> float:
    a = torch.cat([got[k].double().flatten() for k in keys])
    b = torch.cat([want[k].double().flatten() for k in keys])
    return ((a - b).norm() / b.norm()).item()


def _report(tag: str, got: dict, want: dict) -> None:
    per = {k: _rel(got, want, [k]) for k in want}
    bn = max((k for k in per if "bn" in k), key=per.get)
    other = max((k for k in per if "bn" not in k), key=per.get)
    print(f"[step_noise] {tag}: whole gradient {_rel(got, want, list(want)):.3g} relative L2 from "
          f"float64; worst norm leaf {bn} {per[bn]:.3g}, worst other {other} {per[other]:.3g}",
          flush=True)


def _train_rank(cfg, device) -> None:
    from ..engine import train
    from ..parallel import dist

    state = train(cfg, device=device)
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               os.path.join(cfg.OUTPUT_DIR, f"model{dist.rank()}.pt"))


def _train(cfg, out: str, ranks: int = 1, benchmark: bool = False) -> dict:
    from ..engine import train
    from .run_net import run_rank

    cfg = cfg.clone()
    cfg.OUTPUT_DIR = out
    if ranks == 1:
        torch.backends.cudnn.benchmark = benchmark
        try:
            return {k: v.cpu() for k, v in train(cfg).model.state_dict().items()}
        finally:
            torch.backends.cudnn.benchmark = False
    cfg.NUM_GPUS = ranks
    mp.start_processes(run_rank, args=(cfg, f"tcp://localhost:{_port()}", _train_rank, "cuda:0",
                                       "gloo"), nprocs=ranks, start_method="spawn")
    return torch.load(os.path.join(out, "model0.pt"))


def main() -> None:
    from ..models import build_model
    from .loop_probe import write_vggsound

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(_rank_gradients, args=(_port(), root), nprocs=2, start_method="spawn")
        want = step_gradients(_cfg(), device, slice(0, 64), torch.float64)
        one = step_gradients(_cfg(), device, slice(0, 64))
        _report("one process, batchnorm (cuDNN)", one, want)
        _report("one process, sync_batchnorm at world size 1 (grouped norm)",
                step_gradients(_cfg("sync_batchnorm"), device, slice(0, 64)), want)
        two = torch.load(os.path.join(root, "grads0.pt"))
        _report("two gloo ranks on cuda:0, batchnorm (grouped over the ranks)", two, want)
        with torch.backends.cudnn.flags(enabled=False):
            _report("one process, batchnorm, cuDNN off (PyTorch's own convolutions and norms)",
                    step_gradients(_cfg(), device, slice(0, 64)), want)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True):
            _report("one process, batchnorm, cuDNN's deterministic algorithms",
                    step_gradients(_cfg(), device, slice(0, 64)), want)
        print(f"[step_noise] two gloo ranks against one process, both float32: whole gradient "
              f"{_rel(two, one, list(want)):.3g} relative L2", flush=True)

        cfg = _cfg()
        cfg.GPU.SPEC_AUGMENT = True
        cfg.TRAIN.BATCH_SIZE = 64
        cfg.SOLVER.BASE_LR = 1e-3
        cfg.SOLVER.MAX_EPOCH = 1
        cfg.BN.USE_PRECISE_STATS = False
        cfg.LOG_MODEL_INFO = False
        cfg.DATA_LOADER.NUM_WORKERS = 0
        write_vggsound(root, cfg, 192, 64, 2.0)
        with open(os.path.join(root, "train.pkl"), "rb") as f:
            rows = pickle.load(f)
        with open(os.path.join(root, "train_64.pkl"), "wb") as f:
            pickle.dump(rows[:64], f)
        start = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED)).state_dict()
        params = [k for k in start if not k.endswith(("running_mean", "running_var",
                                                      "num_batches_tracked"))]
        for steps, train_list in ((1, "train_64.pkl"), (3, "train.pkl")):
            cfg.VGGSOUND.TRAIN_LIST = train_list
            runs = {tag: _train(cfg, os.path.join(root, f"{tag}{steps}"), ranks, bench)
                    for tag, ranks, bench in (("one", 1, False), ("benchmark", 1, True),
                                              ("ranks", 2, False))}
            update = {tag: {k: sd[k] - start[k].cpu() for k in params} for tag, sd in runs.items()}
            print(f"[step_noise] train(cfg) after {steps} step(s): update of one process under "
                  f"cuDNN's benchmark mode {_rel(update['benchmark'], update['one'], params):.3g}, "
                  f"of two gloo ranks {_rel(update['ranks'], update['one'], params):.3g}, relative "
                  f"L2 from one process's | {torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
