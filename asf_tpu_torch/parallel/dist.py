"""The world of a run over processes: ranks, the data x model grid, the rows each reads, the collectives.

Counterpart of ``asf_tpu/parallel/mesh.py`` (``make_mesh`` :23-46,
``check_batch_divisibility`` :49-80, ``data_parallel_size`` :83-91,
``shard_batch`` :164-180, ``pad_batch_to`` :188) and of
``sync_bn_splits``/``check_sync_bn_mesh`` (``asf_tpu/models/norm.py:120-156``).
The JAX package drives every device of a host from one process and shards
each host batch contiguously over the mesh's ``data`` axis; the port runs
one process a device, started by ``tools/run_net.py:launch_job``:

* with mp = ``GPU.MODEL_PARALLEL`` (the JAX package's ``TPU.MODEL_PARALLEL``)
  a host runs ``NUM_GPUS * mp`` ranks: global rank = ``SHARD_ID * NUM_GPUS *
  mp + local rank``, world size = ``NUM_SHARDS * NUM_GPUS * mp``;
* global rank g is data rank ``g // mp`` and model rank ``g % mp``: a model
  group (``model_group``) is the mp adjacent ranks of one data rank, as a
  row of the JAX package's ``(data, model)`` mesh is, and a data group
  (``data_group``) the ranks of one model rank; at mp = 1 the data group is
  the world and every rank is its own model group;
* the loader splits the data over hosts by ``SHARD_ID``/``NUM_SHARDS``, as
  the JAX package's does, and local data rank r of N = ``NUM_GPUS`` reads
  rows ``[r*B/N, (r+1)*B/N)`` of each host batch of B rows (``host_rows``):
  the rows ``shard_batch`` places on the JAX package's data index r, which
  every rank of r's model group reads alike (the batch is replicated over
  ``model``, ``P("data")``);
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
_GROUPS: dict = {}  # (kind, world size, sizes...) -> this rank's group of that kind


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """Global rank 0: the process that logs, writes checkpoints and score pickles."""
    return rank() == 0


def model_size(cfg) -> int:
    """The ranks of a model group: ``GPU.MODEL_PARALLEL`` in a process group, else 1."""
    return max(1, int(cfg.GPU.MODEL_PARALLEL)) if is_initialized() else 1


def data_size(cfg) -> int:
    """The data-parallel ranks over every host: the world over the model size
    (``data_parallel_size``)."""
    return world_size() // model_size(cfg)


def data_rank(cfg) -> int:
    return rank() // model_size(cfg)


def model_rank(cfg) -> int:
    return rank() % model_size(cfg)


def local_size(cfg) -> int:
    """Data ranks on this host: ``NUM_GPUS`` in a process group, else 1."""
    return max(1, int(cfg.NUM_GPUS)) if is_initialized() else 1


def local_rank(cfg) -> int:
    """This rank's data index among its host's data ranks."""
    return data_rank(cfg) % local_size(cfg)


def host_ranks(cfg) -> int:
    """The processes a host runs: ``NUM_GPUS * GPU.MODEL_PARALLEL``."""
    return max(1, int(cfg.NUM_GPUS)) * max(1, int(cfg.GPU.MODEL_PARALLEL))


def check_world(cfg, entry: str) -> None:
    """Raises unless ``NUM_SHARDS``, ``NUM_GPUS``, ``GPU.MODEL_PARALLEL`` and
    ``SHARD_ID`` describe this process's world: without a process group
    every count must be 1."""
    shards, gpus = int(cfg.NUM_SHARDS), max(1, int(cfg.NUM_GPUS))
    mp, per = max(1, int(cfg.GPU.MODEL_PARALLEL)), host_ranks(cfg)
    if not is_initialized():
        if shards > 1 or per > 1:
            raise RuntimeError(
                f"NUM_SHARDS = {shards}, NUM_GPUS = {gpus}, GPU.MODEL_PARALLEL = {mp} and no "
                f"process group: {entry}(cfg) runs one process a device; start it through "
                "`python -m asf_tpu_torch.tools.run_net` (run_net.launch_job), which starts "
                "the processes and their group")
        return
    if world_size() != shards * per or rank() // per != int(cfg.SHARD_ID):
        raise ValueError(
            f"process group of {world_size()} ranks (this one {rank()}) does not match "
            f"NUM_SHARDS = {shards} x NUM_GPUS = {gpus} x GPU.MODEL_PARALLEL = {mp} at "
            f"SHARD_ID = {cfg.SHARD_ID}")


def host_rows(local_rank: int, local_size: int, batch_size: int) -> tuple[int, int]:
    """``[lo, hi)``: the rows of a host batch of ``batch_size`` that local
    rank ``local_rank`` of ``local_size`` reads."""
    per = batch_size // local_size
    return local_rank * per, (local_rank + 1) * per


def check_batch_divisibility(cfg, batch_size: int, which: str) -> None:
    """``asf_tpu``'s check: a host batch must split evenly over its data ranks."""
    dp = local_size(cfg)
    if batch_size % dp != 0:
        shape = {"data": data_size(cfg)}
        if model_size(cfg) > 1:
            shape["model"] = model_size(cfg)
        raise ValueError(
            f"{which}.BATCH_SIZE={batch_size} (per-process) is not divisible "
            f"by this process's share of the mesh data axis, {dp} (mesh "
            f"shape {shape}). Set NUM_GPUS to a divisor, "
            f"or adjust the batch size.")


def sync_bn_splits(cfg) -> int:
    """Groups of ``NUM_SYNC_DEVICES`` adjacent data ranks that
    ``sync_batchnorm`` normalises over: the data ranks over k (at least 1)."""
    k = max(1, int(cfg.BN.NUM_SYNC_DEVICES))
    return max(1, data_size(cfg) // k)


def check_sync_bn_mesh(cfg) -> None:
    """Raises for ``sync_batchnorm`` when k = ``NUM_SYNC_DEVICES`` does not
    divide the data ranks (``asf_tpu`` would cut a group across ranks)."""
    if cfg.BN.NORM_TYPE != "sync_batchnorm":
        return
    k, ranks, mp = max(1, int(cfg.BN.NUM_SYNC_DEVICES)), data_size(cfg), model_size(cfg)
    if ranks % k:
        where = (f"world size {ranks}" if mp == 1 else
                 f"{ranks} data ranks (world size {world_size()} / GPU.MODEL_PARALLEL {mp})")
        raise ValueError(
            f"sync_batchnorm group mismatch: BN.NUM_SYNC_DEVICES = {k} does not divide the "
            f"{where}; set it to a divisor of NUM_SHARDS x NUM_GPUS")


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


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` (the world when None), in place."""
    CALLS["all_reduce"] += 1
    tdist.all_reduce(t, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t``'s elementwise maximum over ``group`` (the world when None), in place."""
    CALLS["all_reduce"] += 1
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=group)
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
    """Drops the cached groups (after ``destroy_process_group``)."""
    _GROUPS.clear()


def _group(key: tuple, members: list, mine: int):
    """This rank's group of the family ``key``: ``members`` lists every
    group's ranks, ``mine`` is the index of this rank's. Every rank creates
    every group of the family, in order, at its first call, as
    ``new_group`` requires."""
    key = (*key, world_size())
    if key not in _GROUPS:
        _GROUPS[key] = [tdist.new_group(m) for m in members][mine]
    return _GROUPS[key]


def model_group(cfg):
    """The process group of this rank's model group: the mp adjacent ranks of
    its data rank (mp = ``model_size(cfg)``)."""
    mp = model_size(cfg)
    return _group(("model", mp), [list(range(d * mp, (d + 1) * mp))
                                  for d in range(world_size() // mp)], data_rank(cfg))


def data_group(cfg):
    """The process group of this rank's data group, the ranks of its model
    rank: None (the world) at ``GPU.MODEL_PARALLEL`` 1."""
    mp = model_size(cfg)
    if mp == 1:
        return None
    return _group(("data", mp), [list(range(m, world_size(), mp)) for m in range(mp)],
                  model_rank(cfg))


def host_group(cfg):
    """The process group of this host's data ranks that share this rank's
    model rank: the data group when there is one host (the world at
    ``GPU.MODEL_PARALLEL`` 1)."""
    per, mp = local_size(cfg), model_size(cfg)
    if per == data_size(cfg):
        return data_group(cfg)
    hosts = data_size(cfg) // per
    members = [[(h * per + d) * mp + m for d in range(per)] for h in range(hosts)
               for m in range(mp)]
    return _group(("host", per, mp), members, (data_rank(cfg) // per) * mp + model_rank(cfg))
