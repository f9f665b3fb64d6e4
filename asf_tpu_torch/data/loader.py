"""Batch loader: items fetched by a thread pool, collated into numpy batches.

Counterpart of ``asf_tpu/data/loader.py`` (``collate`` :39-126,
``AsfLoader`` :129-358, ``construct_loader`` :361-392, ``shuffle_dataset``
:395-397) for single-clip items; the GRU window chains come with the GRU
slice. Items are read by threads, not processes: the work is file reads and
numpy, which release the interpreter lock. ``AsfLoader`` visits the indices
in the JAX package's order (``np.random.default_rng(seed + epoch)``, the
wrap-pad and the rank split), so both packages see the same batches.

The last val batch keeps its real rows only (no padding, no mask): the JAX
package pads it because XLA compiles static shapes; the port computes the
metrics on the rows it has. The host-to-card copy is ``data/prefetch.py``'s.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from . import vggsound as _vgg  # noqa: F401  (registers the dataset)
from .build import build_dataset


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack single-clip items: waveform (B, S), n_valid (B,), labels as a
    dict of stacked arrays, index (B,) and metadata lists."""
    first = items[0]
    if first["waveform"].ndim != 1:
        raise NotImplementedError("window-chain (GRU) items come with the GRU slice")
    waves = [it["waveform"] for it in items]
    if len({w.dtype for w in waves}) > 1:
        # Raw int16 PCM beside float rows (a file that is not mono int16 fell
        # back to float32 under GPU.INT16_TRANSFER): np.stack would promote
        # the PCM to float at 32768x amplitude, so scale it here.
        waves = [w.astype(np.float32) / 32768.0 if w.dtype == np.int16 else w.astype(np.float32)
                 for w in waves]
    return {
        "waveform": np.stack(waves),
        "n_valid": np.asarray([it["n_valid"] for it in items], np.int32),
        "labels": {k: np.stack([np.asarray(it["label"][k]) for it in items])
                   for k in first["label"]},
        "index": np.asarray([it["index"] for it in items], np.int64),
        "metadata": {k: [it["metadata"][k] for it in items] for k in first["metadata"]},
    }


class AsfLoader:
    """Iterable over collated numpy batches, with a thread pool that lives as
    long as the loader (``close`` ends it)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 num_workers: int = 8, seed: int = 0, rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self.rank = rank
        self.world_size = world_size
        self._pool: Optional[cf.ThreadPoolExecutor] = None

    def _get_pool(self) -> cf.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(max_workers=self.num_workers,
                                               thread_name_prefix="asf-loader")
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def set_epoch(self, epoch: int):
        """Reshuffles the order and re-keys the dataset's per-item draws."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

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
        idx = self._indices()
        pool = self._get_pool()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield collate(list(pool.map(self.dataset.__getitem__, chunk)))


def construct_loader(cfg, split: str) -> AsfLoader:
    """The loader of ``split``: train shuffles and drops the last partial
    batch; val and test keep the order and every item."""
    assert split in ["train", "val", "test"]
    if split == "test":
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    train = split == "train"
    return AsfLoader(
        build_dataset(dataset_name, cfg, split),
        batch_size=batch_size,
        shuffle=train,
        drop_last=train,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        seed=cfg.RNG_SEED,
        rank=cfg.SHARD_ID,
        world_size=cfg.NUM_SHARDS,
    )


def shuffle_dataset(loader: AsfLoader, cur_epoch: int):
    loader.set_epoch(cur_epoch)
