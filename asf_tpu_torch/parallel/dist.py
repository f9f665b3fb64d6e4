"""The world of a data-parallel run: ranks, the rows each reads, the collectives.

Counterpart of ``asf_tpu/parallel/mesh.py`` (``make_mesh`` :23-46,
``check_batch_divisibility`` :49-80, ``shard_batch`` :164-180,
``pad_batch_to`` :188) and of ``sync_bn_splits``/``check_sync_bn_mesh``
(``asf_tpu/models/norm.py:120-156``). The JAX package drives every device
of a host from one process and shards each host batch contiguously over
them; the port runs one process a device, started by
``tools/run_net.py:launch_job``:

* global rank = ``SHARD_ID * NUM_GPUS + local rank``, world size =
  ``NUM_SHARDS * NUM_GPUS``;
* the loader splits the data over hosts by ``SHARD_ID``/``NUM_SHARDS``, as
  the JAX package's does, and local rank r of N = ``NUM_GPUS`` reads rows
  ``[r*B/N, (r+1)*B/N)`` of each host batch of B rows (``host_rows``): the
  rows ``shard_batch`` places on the JAX package's device r;
* a ragged last batch (val, test) is first padded to B rows by repeating
  its last row, as ``pad_batch_to`` does, so a rank may hold no real row;
  it still runs the batch and joins every collective.

The collectives here are those that gloo implements for CUDA tensors too
(``all_reduce``, ``broadcast`` and the list form of ``all_gather``), so the
same code runs over NCCL on the card and over gloo on the CPU or, for a
test, with several ranks on one card. None reads a value back to the host.
``CALLS`` counts them by name.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as tdist

CALLS: Counter = Counter()  # the collectives issued through this module, by name
_HOST_GROUPS: dict = {}  # (world size, ranks a host) -> this rank's per-host group


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """Global rank 0: the process that logs, writes checkpoints and score pickles."""
    return rank() == 0


def local_size(cfg) -> int:
    """Ranks on this host: ``NUM_GPUS`` in a process group, else 1."""
    return max(1, int(cfg.NUM_GPUS)) if is_initialized() else 1


def local_rank(cfg) -> int:
    return rank() % local_size(cfg)


def check_world(cfg, entry: str) -> None:
    """Raises unless ``NUM_SHARDS``, ``NUM_GPUS`` and ``SHARD_ID`` describe
    this process's world: without a process group both counts must be 1."""
    shards, gpus = int(cfg.NUM_SHARDS), max(1, int(cfg.NUM_GPUS))
    if not is_initialized():
        if shards > 1 or gpus > 1:
            raise RuntimeError(
                f"NUM_SHARDS = {shards}, NUM_GPUS = {gpus} and no process group: {entry}(cfg) "
                "runs one process a device; start it through `python -m "
                "asf_tpu_torch.tools.run_net` (run_net.launch_job), which starts the "
                "processes and their group")
        return
    if world_size() != shards * gpus or rank() // gpus != int(cfg.SHARD_ID):
        raise ValueError(
            f"process group of {world_size()} ranks (this one {rank()}) does not match "
            f"NUM_SHARDS = {shards} x NUM_GPUS = {gpus} at SHARD_ID = {cfg.SHARD_ID}")


def host_rows(local_rank: int, local_size: int, batch_size: int) -> tuple[int, int]:
    """``[lo, hi)``: the rows of a host batch of ``batch_size`` that local
    rank ``local_rank`` of ``local_size`` reads."""
    per = batch_size // local_size
    return local_rank * per, (local_rank + 1) * per


def check_batch_divisibility(cfg, batch_size: int, which: str) -> None:
    """``asf_tpu``'s check: a host batch must split evenly over its ranks."""
    dp = local_size(cfg)
    if batch_size % dp != 0:
        raise ValueError(
            f"{which}.BATCH_SIZE={batch_size} (per-process) is not divisible "
            f"by this process's share of the mesh data axis, {dp} (mesh "
            f"shape {{'data': {world_size()}}}). Set NUM_GPUS to a divisor, "
            f"or adjust the batch size.")


def sync_bn_splits(cfg) -> int:
    """Groups of ``NUM_SYNC_DEVICES`` adjacent ranks that ``sync_batchnorm``
    normalises over: the world size over k (at least 1)."""
    k = max(1, int(cfg.BN.NUM_SYNC_DEVICES))
    return max(1, world_size() // k)


def check_sync_bn_mesh(cfg) -> None:
    """Raises for ``sync_batchnorm`` when k = ``NUM_SYNC_DEVICES`` does not
    divide the world size (``asf_tpu`` would cut a group across ranks)."""
    if cfg.BN.NORM_TYPE != "sync_batchnorm":
        return
    k, world = max(1, int(cfg.BN.NUM_SYNC_DEVICES)), world_size()
    if world % k:
        raise ValueError(
            f"sync_batchnorm group mismatch: BN.NUM_SYNC_DEVICES = {k} does not divide the "
            f"world size {world}; set it to a divisor of NUM_SHARDS x NUM_GPUS")


def split_layout(num_splits: int, world: int) -> tuple[int, int]:
    """``(splits a rank holds, ranks a split spans)`` for ``num_splits``
    contiguous splits of the global batch over ``world`` ranks: a split
    spans ``world / num_splits`` ranks when that divides, a rank holds
    ``num_splits / world`` when that does; another pair raises, because a
    split would be cut at a rank's boundary."""
    if world % num_splits == 0:
        return 1, world // num_splits
    if num_splits % world == 0:
        return num_splits // world, 1
    raise ValueError(
        f"{num_splits} batch-norm splits of the global batch do not fit {world} ranks: one "
        "must divide the other")


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(ranks, *t.shape)``: ``t`` of every rank of ``group`` (the world when
    None), in rank order, through the list form of ``all_gather``."""
    CALLS["all_gather"] += 1
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(out, t, group=group)
    return torch.stack(out)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the world, in place."""
    CALLS["all_reduce"] += 1
    tdist.all_reduce(t)
    return t


def all_gather_object(obj, group=None) -> list:
    """Every rank's ``obj`` (picklable host data), in rank order."""
    CALLS["all_gather_object"] += 1
    out = [None] * tdist.get_world_size(group)
    tdist.all_gather_object(out, obj, group=group)
    return out


def barrier() -> None:
    """Waits for every rank (nothing without a process group)."""
    if is_initialized():
        CALLS["barrier"] += 1
        tdist.barrier()


def forget_groups() -> None:
    """Drops the cached per-host groups (after ``destroy_process_group``)."""
    _HOST_GROUPS.clear()


def host_group(per: int):
    """The process group of this host's ``per`` ranks (the world when there
    is one host). Every rank creates every host's group, in order, at its
    first call, as ``new_group`` requires."""
    world = world_size()
    if per == world:
        return None
    key = (world, per)
    if key not in _HOST_GROUPS:
        groups = [tdist.new_group(list(range(h * per, (h + 1) * per)))
                  for h in range(world // per)]
        _HOST_GROUPS[key] = groups[rank() // per]
    return _HOST_GROUPS[key]
