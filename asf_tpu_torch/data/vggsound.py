"""VGG-Sound dataset: one ``.wav`` file a clip.

Counterpart of ``asf_tpu/data/vggsound.py:23-310`` for the train, val and
test splits. The test split holds ``TEST.NUM_ENSEMBLE_VIEWS`` records a clip,
each taking its own evenly spaced window. Wav files are decoded with
``scipy.io.wavfile``, int16 scaled by 1/32768 (librosa's reading of 16-bit
PCM), or kept as raw int16 for the card (``GPU.INT16_TRANSFER``), decided
for the whole dataset by ``_probe_int16``. A file shorter than a clip is
zero-padded and its ``n_valid`` says how many samples are real.

The annotation pickle is read with ``pickle.load``, not pandas: a pickled
DataFrame (which pandas must be installed to unpickle) gives its rows
through ``to_dict("records")``, a list of dicts is taken as it is.

The loader reads whole batches through ``get_batch(epoch, indices)``, which
draws the batch's clip starts in one vectorised call (as the JAX package's
``get_refs_batch`` does); ``__getitem__`` is the per-item definition it is
held to.

The device store's protocol (``data/device_store.py``; the JAX package's
``:119-260``), which decodes no audio: a segment is a whole file.
``device_store_table`` gives each unique file and its frame count from the
wav header, and None once the count passes the budget; ``_file_len``
checks the sampling rate there, since the store never calls
``__getitem__``. ``read_segment``, ``ref_seg_keys``, ``ref_batch(epoch,
indices)`` (each clip's file, its offset and ``n_valid``, placed as
``get_batch`` places it) and ``get_ref(index)``, the per-item definition.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils.logging import get_logger
from .build import register_dataset
from .sampling import get_start_end_idx, get_start_end_idx_batch, item_rng

logger = get_logger(__name__)


def load_wav(path: str, keep_int16: bool = False) -> tuple[np.ndarray, int]:
    """(samples, rate). With ``keep_int16`` a mono int16 file comes back
    memory-mapped, so that only the pages of the clip a caller copies out
    are read (a 10 s file holds eight 1.28 s clips); a file that cannot be
    mapped (24-bit PCM) is read whole, as every file is without it."""
    from scipy.io import wavfile

    try:
        sr, data = wavfile.read(path, mmap=keep_int16)
    except ValueError:  # scipy maps only 1-, 2-, 4- and 8-byte samples
        sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        if keep_int16 and data.ndim == 1:
            return data, sr
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:  # the reference's audio is mono; average the channels
        data = data.mean(axis=1)
    return data, sr


def read_annotations(path: str, index_key: str | None = None) -> list[dict]:
    """The rows of an annotation pickle as dicts: a DataFrame's records, or a
    list of dicts as it is. With ``index_key`` each row carries its key
    under that name: a DataFrame's index (which its records drop; EPIC
    pickles are indexed by ``narration_id``), or the key a list of dicts
    must already hold."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if callable(getattr(obj, "to_dict", None)) and hasattr(obj, "columns"):
        rows = obj.to_dict("records")
        if index_key is not None:
            rows = [{**row, index_key: key} for key, row in zip(obj.index, rows)]
        return rows
    if isinstance(obj, list) and all(isinstance(row, dict) for row in obj):
        if index_key is not None and not all(index_key in row for row in obj):
            raise KeyError(f"{path}: a row lacks its {index_key!r}")
        return obj
    raise TypeError(f"{path}: annotations must be a DataFrame or a list of dicts, "
                    f"not {type(obj).__name__}")


@register_dataset("Vggsound")
class Vggsound:
    def __init__(self, cfg, mode: str):
        assert mode in ["train", "val", "test"], f"Split '{mode}' not supported for VGG-Sound"
        self.cfg = cfg
        self.mode = mode
        self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS if mode == "test" else 1
        self.clip_size = int(round(cfg.AUDIO_DATA.SAMPLING_RATE * cfg.AUDIO_DATA.CLIP_SECS))
        self.clip_samples = self.clip_size - 1
        self.int16 = bool(cfg.GPU.INT16_TRANSFER)
        self._epoch = 0
        self._file_lens: dict = {}
        self._seg_table = None
        self._construct_loader()

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _construct_loader(self):
        c = self.cfg.VGGSOUND
        name = {"train": c.TRAIN_LIST, "val": c.VAL_LIST, "test": c.TEST_LIST}[self.mode]
        path = os.path.join(c.ANNOTATIONS_DIR, name)
        assert os.path.exists(path), f"{path} dir not found"
        self._audio_records = []
        self._temporal_idx = []
        for row in read_annotations(path):
            for idx in range(self._num_clips):
                self._audio_records.append(row)
                self._temporal_idx.append(idx)
        assert len(self._audio_records) > 0, (
            f"Failed to load VGG-Sound split {self.mode} from {path}"
        )
        logger.info("Constructed Vggsound %s (size %d)", self.mode, len(self._audio_records))
        if self.int16:
            self._probe_int16()

    def _probe_int16(self):
        """Decide the int16 path for the whole dataset from up to 8 files:
        any file that is not mono int16 PCM turns it off, so that every
        batch has one dtype (``collate`` still rescues a mixed batch)."""
        from scipy.io import wavfile

        seen, probed = set(), 0
        for rec in self._audio_records:
            if probed >= 8:
                break
            name = self._wav_name(rec)
            if name in seen:
                continue
            seen.add(name)
            try:
                _, data = wavfile.read(os.path.join(self.cfg.VGGSOUND.AUDIO_DATA_DIR, name),
                                       mmap=True)
            except (FileNotFoundError, ValueError):
                continue  # __getitem__ raises the real IO error
            probed += 1
            if data.dtype != np.int16 or data.ndim != 1:
                logger.warning(
                    "GPU.INT16_TRANSFER disabled for Vggsound %s: %s is %s/%dD "
                    "(need mono int16 PCM dataset-wide)",
                    self.mode, name, data.dtype, data.ndim,
                )
                self.int16 = False
                return

    @staticmethod
    def _wav_name(record) -> str:
        return record["video"][:-4] + ".wav"

    def _views(self, indices) -> np.ndarray:
        """Each item's view: -1 (a uniform draw) in train and val."""
        if self.mode in ["train", "val"]:
            return np.full(len(indices), -1, np.int64)
        return np.asarray([self._temporal_idx[i] for i in indices], np.int64)

    def _read(self, index: int) -> np.ndarray:
        return self.read_segment(self._wav_name(self._audio_records[index]))

    def _item(self, index: int, samples: np.ndarray, start: float, end: float) -> dict:
        """The clip ``[int(start), int(end))`` of ``samples`` (the whole file
        when it is shorter than a clip), zero-padded to ``clip_samples``."""
        clip = samples if len(samples) < self.clip_size else samples[int(start) : int(end)]
        wave = np.zeros(self.clip_samples, samples.dtype)
        n = min(len(clip), self.clip_samples)
        wave[:n] = clip[:n]
        return {
            "waveform": wave,
            "n_valid": np.int32(n),
            "label": {"class_id": self._audio_records[index]["class_id"]},
            "index": index,
            "metadata": {},
        }

    def __getitem__(self, index: int):
        """Item ``index`` at the epoch of ``set_epoch``, placed by its own
        ``item_rng``: the definition that ``get_batch`` replays."""
        samples = self._read(index)
        start = end = 0.0
        if len(samples) >= self.clip_size:
            start, end = get_start_end_idx(
                len(samples), self.clip_size, int(self._views([index])[0]),
                self.cfg.TEST.NUM_ENSEMBLE_VIEWS,
                rng=item_rng(self.cfg.RNG_SEED, self._epoch, index),
            )
        return self._item(index, samples, start, end)

    def get_batch(self, epoch: int, indices) -> list:
        """The items ``indices`` of ``epoch``, each bit for bit what
        ``__getitem__`` gives after ``set_epoch(epoch)``, with the batch's
        starts drawn in one vectorised call. The epoch comes with the call,
        so a loader worker that lives across epochs holds no stale one."""
        indices = [int(i) for i in indices]
        samples = [self._read(i) for i in indices]
        starts, ends = get_start_end_idx_batch(
            [len(x) for x in samples], self.clip_size, self._views(indices),
            self.cfg.TEST.NUM_ENSEMBLE_VIEWS, self.cfg.RNG_SEED, epoch, indices,
        )
        return [self._item(i, x, a, b) for i, x, a, b in zip(indices, samples, starts, ends)]

    # -- the device store (data/device_store.py) ---------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.cfg.VGGSOUND.AUDIO_DATA_DIR, name)

    def _file_len(self, name: str) -> int:
        """Frames of wav file ``name`` from its header (remembered), after
        ``__getitem__``'s sampling-rate check."""
        n = self._file_lens.get(name)
        if n is None:
            from scipy.io import wavfile

            sr, data = wavfile.read(self._path(name), mmap=True)
            assert sr == self.cfg.AUDIO_DATA.SAMPLING_RATE, (
                f"Audio sampling rate ({sr}) does not match target "
                f"({self.cfg.AUDIO_DATA.SAMPLING_RATE})"
            )
            n = self._file_lens[name] = int(data.shape[0])
        return n

    def device_store_table(self, budget_samples=None):
        """(file, frames) of each unique file, or None once the frames pass
        ``budget_samples`` (the rest of the headers go unread) or a file
        cannot be read (the item raises the real error)."""
        out, total = {}, 0
        for rec in self._audio_records:
            name = self._wav_name(rec)
            if name in out:
                continue
            try:
                n = self._file_len(name)
            except (FileNotFoundError, ValueError):
                return None
            out[name] = n
            total += n
            if budget_samples is not None and total > budget_samples:
                logger.info("Device segment store: Vggsound %s exceeds the sample budget after "
                            "%d files — streaming", self.mode, len(out))
                return None
        return list(out.items())

    def read_segment(self, name: str) -> np.ndarray:
        samples, sr = load_wav(self._path(name), keep_int16=self.int16)
        assert sr == self.cfg.AUDIO_DATA.SAMPLING_RATE, (
            f"Audio sampling rate ({sr}) does not match target "
            f"({self.cfg.AUDIO_DATA.SAMPLING_RATE})"
        )
        return samples

    def _segment_table(self):
        """(each item's index into the unique files, the files in order,
        their frame counts)."""
        if self._seg_table is None:
            key_of = {}
            seg_of = [key_of.setdefault(self._wav_name(r), len(key_of))
                      for r in self._audio_records]
            self._seg_table = (np.asarray(seg_of, np.int64), list(key_of),
                               np.asarray([self._file_len(k) for k in key_of], np.int64))
        return self._seg_table

    def ref_seg_keys(self) -> list:
        return self._segment_table()[1]

    def _clip_refs(self, lens: np.ndarray, starts: np.ndarray, ends: np.ndarray):
        """(offsets, n_valid) of clips ``[int(start), int(end))`` of files of
        ``lens`` frames, the whole file where it is shorter than a clip."""
        short = lens < self.clip_size
        off = np.where(short, 0, np.floor(starts)).astype(np.int64)
        n_valid = np.where(short, lens, np.floor(ends) - np.floor(starts))
        return off, np.minimum(n_valid, self.clip_samples).astype(np.int32)

    def ref_batch(self, epoch: int, indices) -> dict:
        """The refs of items ``indices`` of ``epoch``: ``seg_idx`` into
        ``ref_seg_keys()``, ``clip_off``, ``n_valid``, labels and indices."""
        indices = np.asarray(indices, np.int64)
        seg_of, _keys, lens = self._segment_table()
        si = seg_of[indices]
        starts, ends = get_start_end_idx_batch(
            lens[si], self.clip_size, self._views(indices), self.cfg.TEST.NUM_ENSEMBLE_VIEWS,
            self.cfg.RNG_SEED, epoch, indices,
        )
        off, n_valid = self._clip_refs(lens[si], starts, ends)
        labels = np.stack([np.asarray(self._audio_records[i]["class_id"]) for i in indices])
        return {"seg_idx": si, "clip_off": off, "n_valid": n_valid,
                "labels": {"class_id": labels}, "index": indices, "metadata": {}}

    def get_ref(self, index: int) -> dict:
        """Item ``index``'s ref at the epoch of ``set_epoch``, placed by its
        own ``item_rng`` as ``__getitem__`` places it."""
        name = self._wav_name(self._audio_records[index])
        n = self._file_len(name)
        start = end = 0.0
        if n >= self.clip_size:
            start, end = get_start_end_idx(
                n, self.clip_size, int(self._views([index])[0]),
                self.cfg.TEST.NUM_ENSEMBLE_VIEWS,
                rng=item_rng(self.cfg.RNG_SEED, self._epoch, index),
            )
        off, n_valid = self._clip_refs(np.asarray([n]), np.asarray([start]), np.asarray([end]))
        return {"seg_key": name, "clip_off": int(off[0]), "n_valid": n_valid[0],
                "label": {"class_id": self._audio_records[index]["class_id"]}, "index": index,
                "metadata": {}}

    def __len__(self):
        return len(self._audio_records)
