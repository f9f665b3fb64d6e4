"""Host-RAM LRU of record segments (``GPU.HOST_WAVEFORM_CACHE_MB``).

Copy of ``asf_tpu/data/cache.py:22-72`` (``ByteLRUCache``). An epoch reads
every record again; with its whole segment kept in RAM under an exact
(video, start, end) key, epochs from the second on slice their clips out of
it instead of reading the audio. Thread-safe.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np


class ByteLRUCache:
    """LRU keyed by hashables, bounded by the arrays' total bytes. Arrays come
    back as read-only views (callers copy them into their batch), so that an
    in-place write raises instead of corrupting later epochs; an array
    larger than the whole budget is not kept."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __getstate__(self) -> dict:  # a pickled dataset carries its entries, not the lock
        return {k: v for k, v in self.__dict__.items() if k != "_lock"}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def get(self, key: Hashable) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._d.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key: Hashable, arr: np.ndarray) -> None:
        nb = int(arr.nbytes)
        if nb > self.max_bytes:
            return  # one oversized segment would evict everything for itself
        view = arr.view()
        view.setflags(write=False)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._d[key] = view
            self._bytes += nb
            while self._bytes > self.max_bytes and self._d:
                _, evicted = self._d.popitem(last=False)
                self._bytes -= evicted.nbytes

    def __len__(self) -> int:
        return len(self._d)

    @property
    def nbytes(self) -> int:
        return self._bytes
