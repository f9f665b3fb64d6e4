"""Train, then test, from a config file and command-line overrides.

    python -m asf_tpu_torch.tools.run_net --cfg config.yaml [KEY VALUE ...]
    python -m asf_tpu_torch.tools.run_net --device cpu --cfg config.yaml NUM_GPUS 4
    python -m asf_tpu_torch.tools.run_net --cfg config.yaml NUM_GPUS 8 \\
        --init_method tcp://host0:9999 --shard_id 0 --num_shards 2
    python -m asf_tpu_torch.tools.run_net --device cpu --cfg config.yaml \\
        NUM_GPUS 2 GPU.MODEL_PARALLEL 2

Counterpart of ``asf_tpu/tools/run_net.py``: ``train(cfg)`` when
``TRAIN.ENABLE``, then ``test(cfg)`` when ``TEST.ENABLE``. The config file
is YAML (the subset of ``config/yaml_lite.py``, no PyYAML) or JSON.

With ``NUM_GPUS = 1``, ``GPU.MODEL_PARALLEL = 1`` and ``NUM_SHARDS = 1``
each runs in this process, on the current CUDA device (``--device cpu``:
on the CPU). Otherwise ``launch_job`` starts P = ``NUM_GPUS *
GPU.MODEL_PARALLEL`` processes on this host (the JAX package drives a
host's devices from one process, ``:21-41``): local rank r runs on
``cuda:r`` in an NCCL group, or with ``--device cpu`` on the CPU in a gloo
group, as global rank ``SHARD_ID * P + r`` of ``NUM_SHARDS * P``, the
group met at ``--init_method``; ``NUM_GPUS`` stays the data-parallel size
a host, as the JAX package's mesh keeps it (``n = req * mp``,
``asf_tpu/parallel/mesh.py:36-45``). Processes start with ``spawn`` (each
rank's loader starts workers of its own). NCCL takes one card a rank: P
above the CUDA device count raises (the JAX package caps it,
``asf_tpu/parallel/mesh.py:41``). A rank that fails makes the launch
raise; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from ..engine import test, train
from ..parallel import dist
from ..utils.parser import load_config, parse_args
from ..utils.torch_setup import rank_device


def run_rank(local_rank: int, cfg, init_method: str, func, device=None, backend=None):
    """One rank: joins the process group as global rank ``SHARD_ID * P +
    local_rank`` of ``NUM_SHARDS * P`` (P = ``NUM_GPUS *
    GPU.MODEL_PARALLEL``), runs ``func(cfg, device=...)`` and leaves the
    group, also when ``func`` raises; returns what ``func`` returns.

    ``device``: None or "cuda" -> ``cuda:local_rank``; "cpu" -> the CPU;
    an indexed device ("cuda:0") as it is (several ranks on one card, over
    gloo). ``backend``: NCCL on CUDA and gloo on the CPU unless given.
    """
    per = dist.host_ranks(cfg)
    dev = rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    extra = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            extra["device_id"] = dev
    else:
        # One intra-op thread a CPU rank: beside the prefetcher's thread, a
        # parallel region may get fewer threads than asked, which re-chunks
        # the float sums of a reduction from run to run.
        torch.set_num_threads(1)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=int(cfg.NUM_SHARDS) * per,
                             rank=int(cfg.SHARD_ID) * per + local_rank, **extra)
    try:
        return func(cfg, device=dev)
    finally:
        tdist.destroy_process_group()
        dist.forget_groups()


def launch_job(cfg, init_method=None, func=None, device=None):
    """Runs ``func(cfg, device=device)``: in this process for one device,
    else in ``NUM_GPUS * GPU.MODEL_PARALLEL`` spawned ranks (``run_rank``)
    of this host."""
    per = dist.host_ranks(cfg)
    if per == 1 and int(cfg.NUM_SHARDS) == 1:
        return func(cfg, device=device)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and per > torch.cuda.device_count():
        raise ValueError(
            f"NUM_GPUS x GPU.MODEL_PARALLEL = {cfg.NUM_GPUS} x {cfg.GPU.MODEL_PARALLEL} ranks "
            f"but this host has {torch.cuda.device_count()} CUDA devices: NCCL takes one a "
            "rank (run on the CPU with --device cpu)")
    mp.spawn(run_rank, args=(cfg, init_method or "tcp://localhost:9999", func, device, None),
             nprocs=per, join=True)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args)

    if cfg.TRAIN.ENABLE:
        launch_job(cfg, args.init_method, train, args.device)

    if cfg.TEST.ENABLE:
        launch_job(cfg, args.init_method, test, args.device)


if __name__ == "__main__":
    main()
