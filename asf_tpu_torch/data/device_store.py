"""Record segments kept on the card: a batch travels as int32 offsets.

Counterpart of ``asf_tpu/data/device_store.py`` (``DeviceSegmentStore``
:88-238, ``gather_in_graph`` :241-264, ``resolve_offsets`` :266-291,
``collate_refs`` :293-355). Every unique record segment of a split is read
once, in the calling process, into one buffer with ``clip_samples`` trailing
zeros at ``pad_offset`` (int16, or float32 where the split's int16 probe
said no), pinned, and copied to the card once. A batch is then the int32
first sample of each clip in that buffer (``wave_start``: (B,) clips or
(B, Nb) chain windows), its ``n_valid`` and its labels, made in the calling
process from the dataset's tables (``ref_batch``) with no worker;
``gather`` turns it into the streamed batch's waveform on the card, bit for
bit: the samples past ``n_valid`` are zero, as the host's zero-filled clip
buffers hold them. Padded chain windows and empty chunks point at the zero
pad with ``n_valid`` 1, as ``loader.collate`` pads them.

The build is two spans (``utils/spans.py``): ``store.read``, the segments
into pinned memory, and ``store.upload``, the copy to the card, whose
seconds the store keeps as ``read_s`` and ``upload_s``; each gather is a
``store.gather`` span.

``try_build`` gives None, with the JAX package's log line, where the budget
is 0 or less, the dataset has no table (a row with a host
``transformation``, which must see float samples on the host; a VGG-Sound
set past the budget), the segments exceed the budget, the buffer would hold
2**31 samples or more, or a segment comes back in another shape or dtype (a
file that is not int16 in a split the probe judged int16). Anything else
that fails (a read, the copy to the card) raises.

Each rank builds its own store on its own device; the JAX package's
replication over the mesh, its capacity quantum (XLA's compile keys) and
the gather fused into its K-step dispatch have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.logging import get_logger
from ..utils.spans import span

logger = get_logger(__name__)

INT32_MAX = 2**31 - 1


def bucket_windows(n: int, max_n: int) -> int:
    """``n`` rounded up to a power of two, capped at ``max_n``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_n)


class DeviceSegmentStore:
    """One buffer of every segment on ``mega``'s device; ``base(key)`` is a
    segment's first sample in it."""

    def __init__(self, mega: torch.Tensor, bases: dict, clip_samples: int):
        self.mega = mega
        self.clip_samples = int(clip_samples)
        self._bases = bases
        self.pad_offset = int(mega.shape[0]) - self.clip_samples
        self.nbytes = int(mega.numel() * mega.element_size())
        self.read_s = self.upload_s = 0.0

    @classmethod
    def try_build(cls, dataset, budget_bytes: int, device) -> Optional["DeviceSegmentStore"]:
        if budget_bytes <= 0:
            logger.info("Device segment store disabled: budget %d MB", budget_bytes >> 20)
            return None
        clip_samples = int(dataset.clip_samples)
        itemsize = 2 if dataset.int16 else 4
        table_fn = getattr(dataset, "device_store_table", None)
        table = table_fn(budget_samples=budget_bytes // itemsize) if callable(table_fn) else None
        if table is None:
            logger.info("Device segment store disabled: %s does not support the ref/gather "
                        "path here (host waveform transforms, or the set exceeds the budget)",
                        type(dataset).__name__)
            return None
        lengths = [max(0, int(n)) for _key, n in table]
        total = sum(lengths) + clip_samples  # the trailing pad: a slice never clamps
        if total * itemsize > budget_bytes:
            logger.warning("Device segment store disabled: %d segments need %.0f MB > budget "
                           "%.0f MB", len(table), total * itemsize / 2**20, budget_bytes / 2**20)
            return None
        if total >= INT32_MAX:
            logger.warning("Device segment store disabled: >2^31 samples")
            return None
        device = torch.device(device)
        dtype = np.int16 if itemsize == 2 else np.float32
        with span("store.read") as read:
            host = torch.empty(total, dtype=torch.int16 if itemsize == 2 else torch.float32,
                               pin_memory=device.type == "cuda")
            mega = host.numpy()
            bases, off = {}, 0
            for (key, _n), n in zip(table, lengths):
                if n > 0:
                    seg = dataset.read_segment(key)
                    if seg.shape != (n,) or seg.dtype != dtype:
                        logger.warning("Device segment store disabled: segment %s is %s/%s, "
                                       "expected (%d,)/%s", key, seg.shape, seg.dtype, n,
                                       np.dtype(dtype))
                        return None
                    mega[off : off + n] = seg
                bases[key] = off
                off += n
            mega[off:] = 0
        with span("store.upload") as upload:
            dev = host.to(device) if device.type == "cuda" else host
        store = cls(dev, bases, clip_samples)
        store.read_s, store.upload_s = read.seconds(), upload.seconds()
        logger.info("Device segment store: %d segments, %.1f MB resident on %s (read %.2f s, "
                    "copied in %.3f s) — batches ship int32 offsets instead of waveforms",
                    len(table), store.nbytes / 2**20, device, store.read_s, store.upload_s)
        return store

    def base(self, key) -> int:
        return self._bases[key]

    def gather(self, starts: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        """int32 offsets ``starts`` (any shape, on the store's device) ->
        waveforms ``starts.shape + (clip_samples,)``, zero past ``n_valid``:
        ``gather_in_graph`` of the JAX package. A row is a window of the
        buffer's unfolded view, so no (rows, S) index is built."""
        with span("store.gather"):
            S = self.clip_samples
            rows = self.mega.unfold(0, S, 1).index_select(0, starts.reshape(-1))
            wave = rows.view(*starts.shape, S)
            past = torch.arange(S, device=wave.device) >= n_valid.unsqueeze(-1)
            return wave.masked_fill_(past, 0)


def resolve_offsets(batch: dict, store: Optional[DeviceSegmentStore]) -> dict:
    """An offset batch of tensors as the streamed batch: ``wave_start``
    replaced by the ``waveform`` gathered from ``store``; a batch without
    offsets, or no store, as it is."""
    if store is None or "wave_start" not in batch:
        return batch
    rest = dict(batch)
    starts = rest.pop("wave_start")
    return {"waveform": store.gather(starts, rest["n_valid"]), **rest}


def _labels_index_metadata(items: list) -> dict:
    first = items[0]
    return {
        "labels": {k: np.stack([np.asarray(it["label"][k]) for it in items])
                   for k in first["label"]},
        "index": np.asarray([it["index"] for it in items], np.int64),
        "metadata": {k: [it["metadata"][k] for it in items] for k in first["metadata"]},
    }


def collate_refs(items: list, store: DeviceSegmentStore, max_windows: Optional[int] = None,
                 n_max: Optional[int] = None) -> dict:
    """Per-item refs (``dataset.get_ref``) as one offset batch, the keys of
    ``loader.collate`` with ``wave_start`` for the waveform; chain refs pad
    to the bucket of their longest chain, or of ``n_max`` windows."""
    first = items[0]
    if "window_offs" not in first:
        return {
            "wave_start": np.asarray([store.base(it["seg_key"]) + int(it["clip_off"])
                                      for it in items], np.int32),
            "n_valid": np.asarray([it["n_valid"] for it in items], np.int32),
            **_labels_index_metadata(items),
        }
    if n_max is None:
        n_max = max(int(it["length"]) for it in items)
    nb = bucket_windows(n_max, max_windows or n_max)
    starts = np.full((len(items), nb), store.pad_offset, np.int32)
    n_valid = np.ones((len(items), nb), np.int32)
    lengths = np.zeros((len(items),), np.int32)
    for i, it in enumerate(items):
        n = min(int(it["length"]), nb)
        offs = np.asarray(it["window_offs"][:n], np.int64)
        base = store.base(it["seg_key"])
        starts[i, :n] = np.where(offs < 0, store.pad_offset, base + offs)
        n_valid[i, :n] = it["n_valid"][:n]
        lengths[i] = n
    return {"wave_start": starts, "n_valid": n_valid, "lengths": lengths,
            "noun_embedding": np.stack([it["noun_embedding"] for it in items]),
            **_labels_index_metadata(items)}


def offset_batch(refs: dict, bases: np.ndarray, store: DeviceSegmentStore,
                 max_windows: Optional[int] = None, n_max: Optional[int] = None) -> dict:
    """A vectorised ref batch (``dataset.ref_batch``) as the offset batch
    ``collate_refs`` makes of the same items: ``bases`` holds the first
    sample of each of ``dataset.ref_seg_keys()`` in the store."""
    seg_base = bases[refs["seg_idx"]]
    if "window_offs" in refs:
        lengths = refs["lengths"]
        n = int(lengths.max()) if n_max is None else n_max
        nb = bucket_windows(n, max_windows or n)
        offs = refs["window_offs"][:, :nb]
        out = {"wave_start": np.where(offs < 0, store.pad_offset,
                                      seg_base[:, None] + offs).astype(np.int32),
               "n_valid": np.ascontiguousarray(refs["n_valid"][:, :nb], np.int32),
               "lengths": np.minimum(lengths, nb).astype(np.int32),
               "noun_embedding": refs["noun_embedding"]}
    else:
        out = {"wave_start": (seg_base + refs["clip_off"]).astype(np.int32),
               "n_valid": refs["n_valid"].astype(np.int32)}
    return {**out, "labels": refs["labels"], "index": refs["index"],
            "metadata": refs["metadata"]}
