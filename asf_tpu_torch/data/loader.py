"""Batch loader: whole batches read and collated in worker processes.

Counterpart of ``asf_tpu/data/loader.py`` (``bucket_windows`` :34,
``collate`` :39-126, ``AsfLoader`` :129-299, ``construct_loader`` :302-330,
``shuffle_dataset`` :333-335) for single-clip items of VGG-Sound and
EPIC-KITCHENS (its ``train+val`` split too) and for EPIC window chains.
A batch of chains is padded to ``bucket_windows(longest chain,
MAX_NB_SPECTROGRAMS)`` windows, a power of two capped at the maximum, so
that cuDNN meets few shapes; the JAX package's ``TPU.GRU_SINGLE_BUCKET``,
which pads every batch to the maximum for XLA's compile keys, is not
ported.
``AsfLoader`` visits the indices in the JAX package's order
(``np.random.default_rng(seed + epoch)``, the wrap-pad and the rank split),
so both packages see the same batches.

The JAX package reads items on a thread pool. The port reads them in the
worker processes of a ``torch.utils.data.DataLoader`` (``NUM_WORKERS`` of
them, as the reference's DataLoader does), so that the loader's Python never
holds the interpreter lock of the process that dispatches the step. Each
request is a key ``(epoch, chunk)``, one batch's slice of ``_indices()``:
the epoch travels with the request, and a worker reads the chunk with the
dataset's ``get_batch(epoch, chunk)`` and collates it. ``NUM_WORKERS = 0``
reads in the calling process.

Workers start with ``spawn``: the parent holds a CUDA context and the
prefetcher's thread, and a child forked from a process with threads can
inherit a lock (the logging module's, CUDA's) that a thread of the parent
held, and wait on it for ever. A spawned worker starts from a fresh
interpreter, imports this package and numpy (never CUDA), and rebuilds the
dataset from its class, config and split; a script that reads data
therefore runs under ``if __name__ == "__main__":``. The dataset itself does
not travel: ``spawn`` writes a child's arguments into a pipe that the child
reads only after importing its modules, so a pickle larger than the pipe
(64 KB: the tables of a few hundred rows) makes the parent wait for each
worker's imports in turn, and 8 workers start one after another instead of
together. Workers live as long as the loader
(``persistent_workers``) and ``close`` ends them. Each worker holds at most
``PREFETCH_FACTOR`` requests. Batches come back as pickled numpy arrays
through the workers' pipes (no shared-memory segment); the prefetcher pins
them, once.

The last val batch keeps its real rows only (no padding, no mask): the JAX
package pads it because XLA compiles static shapes; the port computes the
metrics on the rows it has. The host-to-card copy is ``data/prefetch.py``'s.

With a device store attached (``attach_store``; ``GPU.TRAIN_DEVICE_CACHE_MB``
and ``GPU.TEST_DEVICE_CACHE_MB``, ``asf_tpu/data/loader.py:226-292``) a pass
starts no worker: each batch is made in the calling process from the
dataset's tables (``ref_batch``, a few hundred bytes of int32 offsets,
labels and indices) and its waveform is gathered on the card by the
prefetcher; its rows, padding, ``n_real``, ``host_rows`` and chain bucket
follow the rules below, as a streamed batch's do.

With N = ``NUM_GPUS`` data ranks on a host (``parallel/dist.py``), local
data rank r reads only rows ``[r*B/N, (r+1)*B/N)`` of each host batch of B
rows, the rows the JAX package's ``shard_batch`` puts on its data index r:
the items are drawn per index, so a rank's rows are bit for bit those of
the whole batch. On a data x model grid (``GPU.MODEL_PARALLEL``) every rank
of a model group reads its data rank's rows. A ragged host batch is first padded to B rows by repeating its last
index, as ``pad_batch_to`` repeats its last row, and each rank's batch then
carries ``n_real``, its real rows (0 at times), and ``host_rows``, the host
batch's. Chains pad to the bucket of the host batch's longest chain, so
that every rank of a host pads to the same window count as the JAX package
does for the whole batch.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils import data as tud

from ..parallel import dist
from . import epickitchens as _epic  # noqa: F401  (registers the dataset)
from . import epickitchens_slide as _epic_slide  # noqa: F401  (registers the dataset)
from . import vggsound as _vgg  # noqa: F401  (registers the dataset)
from .build import build_dataset
from .device_store import bucket_windows, offset_batch

PREFETCH_FACTOR = 2  # requests a worker holds at a time


def _collate_chains(items: List[Dict[str, Any]], max_windows: Optional[int],
                    n_max: Optional[int] = None) -> Dict[str, Any]:
    """waveform (B, Nb, S), n_valid (B, Nb), lengths (B,) and, where the
    items carry it, noun_embedding (B, 512); Nb is the bucket of the longest
    chain, or of ``n_max`` windows when given (a rank's share of a host
    batch pads as the whole batch does). Padded windows are zeros with
    ``n_valid`` 1 (the front end's edge replication needs a frame); the
    model masks them by ``lengths``."""
    if n_max is None:
        n_max = max(int(it["length"]) for it in items)
    nb = bucket_windows(n_max, max_windows or n_max)
    # int16 only when every chain is raw PCM; otherwise the int16 chains
    # take the /32768 scale here, as single clips do.
    all_int16 = all(it["waveform"].dtype == np.int16 for it in items)
    waves = np.zeros((len(items), nb, items[0]["waveform"].shape[1]),
                     np.int16 if all_int16 else np.float32)
    n_valid = np.ones((len(items), nb), np.int32)
    lengths = np.zeros((len(items),), np.int32)
    for i, it in enumerate(items):
        n = min(int(it["length"]), nb)
        w = it["waveform"][:n]
        if not all_int16 and w.dtype == np.int16:
            w = w.astype(np.float32) / 32768.0
        waves[i, :n] = w
        n_valid[i, :n] = it["n_valid"][:n]
        lengths[i] = n
    out = {"waveform": waves, "n_valid": n_valid, "lengths": lengths}
    if "noun_embedding" in items[0]:
        out["noun_embedding"] = np.stack([it["noun_embedding"] for it in items])
    return out


def collate(items: List[Dict[str, Any]], max_windows: Optional[int] = None,
            n_max: Optional[int] = None) -> Dict[str, Any]:
    """Stack items. Single clips: waveform (B, S), n_valid (B,); window
    chains: ``_collate_chains``, padded to at most ``max_windows``. Then
    labels as a dict of stacked arrays (``class_id``, or ``verb`` and
    ``noun``), index (B,) and metadata as lists (EPIC's ``narration_id``)."""
    first = items[0]
    if first["waveform"].ndim == 2:
        out = _collate_chains(items, max_windows, n_max)
    else:
        waves = [it["waveform"] for it in items]
        if len({w.dtype for w in waves}) > 1:
            # Raw int16 PCM beside float rows (a file that is not mono int16
            # fell back to float32 under GPU.INT16_TRANSFER): np.stack would
            # promote the PCM to float at 32768x amplitude, so scale it here.
            waves = [w.astype(np.float32) / 32768.0 if w.dtype == np.int16
                     else w.astype(np.float32) for w in waves]
        out = {"waveform": np.stack(waves),
               "n_valid": np.asarray([it["n_valid"] for it in items], np.int32)}
    return {
        **out,
        "labels": {k: np.stack([np.asarray(it["label"][k]) for it in items])
                   for k in first["label"]},
        "index": np.asarray([it["index"] for it in items], np.int64),
        "metadata": {k: [it["metadata"][k] for it in items] for k in first["metadata"]},
    }


def _rebuilt(cls, cfg, mode: str, max_windows: Optional[int]) -> "_Batches":
    return _Batches(cls(cfg, mode), max_windows)


def _as_is(batch):
    """The DataLoader's ``collate_fn``: a request already gives a batch."""
    return batch


class _Batches(tud.Dataset):
    """A dataset whose items are collated batches, keyed by ``(epoch, chunk)``.
    Pickled (into a worker), it carries the dataset's class, config and split
    and rebuilds the dataset where it is unpickled."""

    def __init__(self, dataset, max_windows: Optional[int]):
        self.dataset = dataset
        self.max_windows = max_windows

    def __reduce__(self):
        ds = self.dataset
        return _rebuilt, (type(ds), ds.cfg, ds.mode, self.max_windows)

    def __getitem__(self, key):
        return _rank_batch(self.dataset, key, lambda epoch, rows, n_max: collate(
            self.dataset.get_batch(epoch, rows), self.max_windows, n_max))


def _rank_batch(dataset, key, make):
    """The batch of request ``key`` = ``(epoch, chunk, *share)``:
    ``make(epoch, rows, n_max)`` of the whole chunk, or of this rank's share
    of it, padded to the batch size by repeating its last index, with
    ``n_real`` and ``host_rows``; chains pad to the bucket of the host
    batch's longest chain."""
    epoch, chunk, *share = key
    if not share:
        return make(epoch, chunk, None)
    lo, hi = dist.host_rows(*share)
    real = len(chunk)
    padded = np.concatenate([chunk, np.repeat(chunk[-1:], share[2] - real)])
    windows = getattr(dataset, "chain_windows", None)
    batch = make(epoch, padded[lo:hi], None if windows is None else int(windows(chunk).max()))
    batch["n_real"] = max(0, min(hi, real) - lo)
    batch["host_rows"] = real
    return batch


class _Chunks(tud.Sampler):
    """One pass over ``loader``: its ``(epoch, chunk)`` keys, taken from its
    epoch and order when the pass starts; with ranks on the host, each key
    also names this rank's share, ``(local rank, local ranks, batch size)``."""

    def __init__(self, loader: "AsfLoader"):
        self.loader = loader

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        ld, bs = self.loader, self.loader.batch_size
        idx = ld._indices()
        share = () if ld.local_size == 1 else (ld.local_rank, ld.local_size, bs)
        for b in range(len(ld)):
            yield (ld.epoch, idx[b * bs : (b + 1) * bs], *share)


class AsfLoader:
    """Iterable over collated numpy batches; with ``num_workers > 0`` its
    worker processes start at the first pass and live until ``close``.
    ``rank``/``world_size`` split the data over hosts; local data rank
    ``local_rank`` of ``local_size`` takes its rows of each host batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 num_workers: int = 8, seed: int = 0, rank: int = 0, world_size: int = 1,
                 max_windows: Optional[int] = None, local_rank: int = 0, local_size: int = 1):
        self.dataset = dataset
        self.max_windows = max_windows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.seed = seed
        self.epoch = 0
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_size = local_size
        self.device_store = None
        self._store_bases: Optional[np.ndarray] = None
        self._dl: Optional[tud.DataLoader] = None

    def attach_store(self, store) -> None:
        """From the next pass on, yield offset batches into ``store``
        (``data/device_store.py``), made in this process: no worker starts."""
        self.close()
        self.device_store = store
        self._store_bases = np.asarray([store.base(k) for k in self.dataset.ref_seg_keys()],
                                       np.int64)

    def _offset_batch(self, epoch, rows, n_max):
        return offset_batch(self.dataset.ref_batch(epoch, rows), self._store_bases,
                            self.device_store, self.max_windows, n_max)

    def _loader(self) -> tud.DataLoader:
        if self._dl is None:
            workers = self.num_workers > 0
            self._dl = tud.DataLoader(
                _Batches(self.dataset, self.max_windows), batch_size=None, sampler=_Chunks(self),
                collate_fn=_as_is, num_workers=self.num_workers,
                persistent_workers=workers,
                prefetch_factor=PREFETCH_FACTOR if workers else None,
                multiprocessing_context="spawn" if workers else None,
                # The workers' seeds come from here, not from torch's global
                # generator, whose draws the train step's dropout takes.
                generator=torch.Generator().manual_seed(int(self.seed)),
            )
        return self._dl

    def worker_pids(self) -> List[int]:
        """The pids of the live worker processes (none before the first pass)."""
        it = getattr(self._dl, "_iterator", None)
        return [w.pid for w in getattr(it, "_workers", []) if w.is_alive()]

    def close(self):
        """Ends the worker processes and waits for them."""
        it = getattr(self._dl, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
        self._dl = None

    def set_epoch(self, epoch: int):
        """Reshuffles the order and re-keys the items' draws from the next pass on."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.world_size > 1:
            # Wrap-pad so that every rank gets as many items (torch's
            # DistributedSampler), then take this rank's share.
            total = -(-n // self.world_size) * self.world_size
            if total > n:
                idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.rank :: self.world_size]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.device_store is not None:
            return (_rank_batch(self.dataset, key, self._offset_batch) for key in _Chunks(self))
        return iter(self._loader())


def construct_loader(cfg, split: str) -> AsfLoader:
    """The loader of ``split``: train and train+val shuffle and drop the
    last partial batch; val and test keep the order and every item. Train
    and val are split over hosts (``SHARD_ID`` of ``NUM_SHARDS``); every
    host tests on the whole test set, as the JAX package's host-local test
    mesh does (``asf_tpu/engine/test_loop.py:176-186``)."""
    assert split in ["train", "val", "test", "train+val"]
    if split == "test":
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    train = split in ("train", "train+val")
    return AsfLoader(
        build_dataset(dataset_name, cfg, split),
        batch_size=batch_size,
        shuffle=train,
        drop_last=train,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        seed=cfg.RNG_SEED,
        rank=0 if split == "test" else cfg.SHARD_ID,
        world_size=1 if split == "test" else cfg.NUM_SHARDS,
        max_windows=cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS,
        local_rank=dist.local_rank(cfg),
        local_size=dist.local_size(cfg),
    )


def shuffle_dataset(loader: AsfLoader, cur_epoch: int):
    loader.set_epoch(cur_epoch)
