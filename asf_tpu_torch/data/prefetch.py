"""Host batches to the card, ``DEPTH`` batches ahead of the step.

Counterpart of ``asf_tpu/data/loader.py:iter_prefetched`` and
``DevicePrefetcher`` (:400-575). A worker thread takes the loader's numpy
batches, makes each array a tensor in pinned memory and copies it to the
card with ``non_blocking=True`` on a side ``torch.cuda.Stream``, then
records an event there. The consumer's stream waits on that event before it
reads the batch, and every tensor is ``record_stream``-ed to the consumer's
stream, so that the caching allocator does not hand its memory to a later
copy while the consumer's kernels still read it. The pinned buffers stay
referenced until the consumer has taken the batch, and PyTorch's pinned
allocator does not reuse a buffer before the copy out of it has finished.

This is the one place a batch is pinned: the loader's workers hand over
plain numpy arrays. int16 waveforms stay int16 on the wire; labels and
indices keep their integer types. A batch of window chains carries its
``lengths`` and ``noun_embedding`` to the card like any array, and keeps
``host_lengths``, the lengths as a list of ints on the host: packing the
GRU's sequences reads them there, and the step must not wait for the card
to read them back. With ``device="cpu"`` the same tensors
come without pinning or streams (the caller's choice, not a fallback). With ``depth=0`` there is
no worker thread: each batch is loaded and copied the same way when the
consumer asks for it (the tests use it to make the loader's delays the
loop's data wait).

A loader with a device store (``data/device_store.py``) hands over offset
batches: their ``wave_start`` and ``n_valid`` cross from pinned memory on
the same side stream, and the store's gather runs there too, before the
event is recorded (``asf_tpu/data/loader.py:_upload``, :91-102), so the
consumer still waits on one event and takes a batch with a streamed
batch's keys, shapes and dtypes; nothing here waits for the card. On the
CPU the same code runs on CPU tensors. Each batch's pinning, copy and
gather is the span ``prefetch.upload`` (``utils/spans.py``), on the worker
thread.

The JAX package's K-step macro-batches and device-side LR (``group``,
``lr_fn``) exist for XLA's dispatch and are not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Optional

import numpy as np
import torch

from ..utils.spans import span
from .device_store import resolve_offsets

DEPTH = 2  # batches copied ahead of the step by ``prefetch``


def _tensors(batch: dict, fn) -> dict:
    """``fn`` applied to every array and tensor in ``batch`` (nested dicts);
    other leaves (metadata lists) pass as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = _tensors(v, fn)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = fn(v)
        else:
            out[k] = v
    return out


def _host(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(batch: dict):
    for v in batch.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


class _Stopped(Exception):
    pass


class Prefetcher:
    """Iterates ``batches`` as dicts of tensors on ``device``, offset
    batches gathered from ``store``; ``close()`` stops the worker (also when
    the consumer stops early)."""

    def __init__(self, batches: Iterable[dict], device, depth: int = 2, store=None):
        self.device = torch.device(device)
        self.store = store
        self.cuda = self.device.type == "cuda"
        self.depth = int(depth)
        self._it = iter(batches)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        if self.depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(target=self._worker, name="asf-prefetch",
                                            daemon=True)
            self._thread.start()

    # -- producer ----------------------------------------------------------
    def _upload(self, host: dict):
        """(device batch, event or None, pinned host tensors), as the span
        ``prefetch.upload``."""
        with span("prefetch.upload"):
            if "lengths" in host:
                host = {**host, "host_lengths": host["lengths"].tolist()}
            if not self.cuda:
                return resolve_offsets(_tensors(host, _host), self.store), None, None
            pinned = _tensors(host, lambda a: _host(a).pin_memory())
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                dev = _tensors(pinned, lambda t: t.to(self.device, non_blocking=True))
                dev = resolve_offsets(dev, self.store)
                event = torch.cuda.Event()
                event.record(self._stream)
            return dev, event, pinned

    def _put(self, item):
        while not self._stopped.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        raise _Stopped

    def _worker(self):
        try:
            for host in self._it:
                self._put(("batch", self._upload(host)))
            self._put(("done", None))
        except _Stopped:
            return
        except Exception as e:  # handed to the consumer, which raises it
            try:
                self._put(("error", e))
            except _Stopped:
                pass

    # -- consumer ----------------------------------------------------------
    def _receive(self, dev: dict, event) -> dict:
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _leaves(dev):
                t.record_stream(consumer)
        return dev

    def __iter__(self):
        if self.depth <= 0:
            for host in self._it:
                dev, event, _pinned = self._upload(host)
                yield self._receive(dev, event)
            return
        while True:
            kind, payload = self._q.get()
            if kind == "done":
                return
            if kind == "error":
                raise payload
            dev, event, _pinned = payload
            yield self._receive(dev, event)

    def close(self):
        """Stop the worker and wait for it; batches in flight are dropped."""
        self._stopped.set()
        if self._thread is not None:
            while self._thread.is_alive():
                try:
                    self._q.get(timeout=0.1)
                except queue.Empty:
                    pass
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch(loader: Iterable[dict], device) -> Prefetcher:
    """``loader``'s batches on ``device``, ``DEPTH`` ahead, gathered from its
    device store where it has one."""
    return Prefetcher(loader, device, depth=DEPTH, store=getattr(loader, "device_store", None))
