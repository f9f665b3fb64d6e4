"""EPIC-KITCHENS-100 datasets from per-video wav files: one clip an item
(``EpicKitchens``), or one chain of windows an item (``EpicKitchensGRU``);
with PDDL state labels, ``EpicKitchensWithPDDL`` and
``EpicKitchensGRUwithPDDL``.

Counterpart of ``asf_tpu/data/epickitchens.py:50-376`` (``EpicKitchens``,
regular items), ``:588-642`` (``get_refs_batch``) and ``:379-391,
711-800`` (``_gru_region``, ``_get_item_gru``, ``EpicKitchensGRU`` and the
two PDDL datasets). Splits ``train``,
``val``, ``test`` (``TEST.NUM_ENSEMBLE_VIEWS`` records a row, each taking
its own evenly spaced window) and ``train+val`` (both lists);
``EPICKITCHENS.SINGLE_BATCH`` keeps the first ``TRAIN.BATCH_SIZE`` rows of
each list. An action at least a clip long gives a clip placed inside it
(``_placement``); a shorter one gives all its samples, and ``n_valid`` says
how many are real. Samples outside the video read as zeros.

The audio: ``EPICKITCHENS.AUDIO_DATA_FILE`` names a directory of mono wav
files, ``<video_id>.wav`` (what ``asf_tpu/tools/extract_audio.py`` writes
and ``asf_tpu/tools/wav_to_hdf5.py`` packs into the JAX package's HDF5
archive). A mono int16 file is memory-mapped, and a read copies out the
clip's pages only (``vggsound.load_wav``). The JAX package's host byte-LRU
(``asf_tpu/data/cache.py``) exists for HDF5 region reads; memory-mapped
files go through the page cache, and it is not ported.

The int16 transfer (``GPU.INT16_TRANSFER``) is decided for the whole split:
a row with a ``transformation`` (a host augmentation in float,
``data/transforms.py``) or a video that is not mono int16 turns it off.

The loader reads whole batches through ``get_batch(epoch, indices)``,
each item bit for bit what ``__getitem__`` gives. Untransformed rows draw
their starts in one vectorised call (``fast_rng``); a transformed row draws
its start and then its transform from the item's own generator
(``sampling.item_rng``), so it keeps the per-item draw.

A chain item (``EpicKitchensGRU``) holds ``min(num_spectrograms,
MAX_NB_SPECTROGRAMS)`` windows of one clip each, read from one covering
region of the video: window ``i`` starts ``i * SAMPLING_RATE`` samples after
the action's start (the reference advances one second a window, not clip
minus overlap), and an action shorter than a clip gives its whole segment
to every window. Each window's ``n_valid`` counts the samples inside the
video, at least 1. Chain placement draws no random numbers, so
``get_batch`` reads item by item; the JAX package's vectorised chain path
(``_get_refs_batch_gru``) serves its device store, which is not ported. A
test split of chains has one view a row.

Every key of a record's label is kept as a table of the split's rows and
carried by regular and chain items alike: ``verb`` and ``noun``, and for the
PDDL records ``precs`` and ``posts``, (rows, P) float32 tables of their
rows' ``precs_vec``/``posts_vec`` in {-1, 0, 1}.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.logging import get_logger
from .build import register_dataset
from .records import (
    EpicKitchensAudioRecord,
    EpicKitchensAudioRecordGRU,
    EpicKitchensAudioRecordGRUwithPDDL,
    EpicKitchensAudioRecordWithPDDL,
)
from .sampling import get_start_end_idx, get_start_end_idx_batch, item_rng
from .transforms import get_transforms
from .vggsound import load_wav, read_annotations

logger = get_logger(__name__)

MODES = ("train", "val", "test", "train+val")


def audio_dir(path: str) -> str:
    """``path`` if it is a directory of wav files; raises otherwise."""
    if os.path.isdir(path):
        return path
    if path.endswith((".hdf5", ".h5")):
        raise ValueError(
            f"EPICKITCHENS.AUDIO_DATA_FILE = {path!r} is an HDF5 archive: the port reads a "
            "directory of per-video mono wav files, <video_id>.wav, and no HDF5 (see "
            "ROADMAP.md section 1 item 7, the HDF5 -> wav exporter)")
    raise FileNotFoundError(f"EPICKITCHENS.AUDIO_DATA_FILE = {path!r} is not a directory "
                            "of per-video wav files")


@register_dataset("EpicKitchens")
class EpicKitchens:
    record_type = EpicKitchensAudioRecord

    def __init__(self, cfg, mode: str):
        if mode not in MODES:
            raise ValueError(f"Split '{mode}' not supported for {type(self).__name__}")
        self.cfg = cfg
        self.mode = mode
        self._num_clips = self._test_views() if mode == "test" else 1
        self.clip_size = int(round(cfg.AUDIO_DATA.SAMPLING_RATE * cfg.AUDIO_DATA.CLIP_SECS))
        self.clip_samples = self.clip_size - 1
        self.int16 = bool(cfg.GPU.INT16_TRANSFER)
        self.transforms = get_transforms()
        self.audio_dir = audio_dir(cfg.EPICKITCHENS.AUDIO_DATA_FILE)
        self._epoch = 0
        self._video_lens: dict = {}
        self._construct_loader()
        if self.int16:
            self._probe_int16()

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _test_views(self) -> int:
        """Items a test row gives: ``TEST.NUM_ENSEMBLE_VIEWS``, one for chains
        (a GRU test set), as the JAX package decides it."""
        return 1 if "GRU" in self.cfg.TEST.DATASET else self.cfg.TEST.NUM_ENSEMBLE_VIEWS

    # -- record list -------------------------------------------------------
    def _annotation_files(self) -> list[str]:
        c = self.cfg.EPICKITCHENS
        names = {"train": [c.PROCESSED_TRAIN_LIST], "val": [c.PROCESSED_VAL_LIST],
                 "test": [c.PROCESSED_TEST_LIST],
                 "train+val": [c.PROCESSED_TRAIN_LIST, c.PROCESSED_VAL_LIST]}[self.mode]
        return [os.path.join(c.ANNOTATIONS_DIR, n) for n in names]

    def _construct_loader(self):
        """The rows' tables: video, first sample, sample count, labels,
        narration id and transformation of each annotation row; index ``i``
        is row ``i // _num_clips`` in view ``i % _num_clips``."""
        files = self._annotation_files()
        for f in files:
            if not os.path.exists(f):
                raise FileNotFoundError(f"{f} dir not found")
        records = self._records(files)
        if not records:
            raise ValueError(f"Failed to load EPIC-KITCHENS split {self.mode} from {files}")
        self._video = [r.untrimmed_video_name for r in records]
        self._start = np.asarray([r.start_audio_sample for r in records], np.int64)
        self._num = np.asarray([r.num_audio_samples for r in records], np.int64)
        labels = [r.label for r in records]
        self._labels = {k: np.asarray([lab[k] for lab in labels]) for k in labels[0]}
        self._narration = [r.metadata["narration_id"] for r in records]
        self._transformation = [r.transformation for r in records]
        self._record_tables(records)
        logger.info("Constructed %s %s (size %d) from %s", type(self).__name__, self.mode,
                    len(self), files)

    def _records(self, files: list[str]) -> list:
        """A record of each row of ``files`` (under ``EPICKITCHENS.SINGLE_BATCH``
        the first ``TRAIN.BATCH_SIZE`` rows of each)."""
        records = []
        for f in files:
            rows = read_annotations(f, index_key="narration_id")
            if self.cfg.EPICKITCHENS.SINGLE_BATCH:
                rows = rows[: self.cfg.TRAIN.BATCH_SIZE]
            records += [self.record_type(row, self.cfg) for row in rows]
        return records

    def _record_tables(self, records: list) -> None:
        """Tables a subclass keeps beside the rows' (none here)."""

    def _probe_int16(self):
        """Turns the int16 transfer off for the split where a row has a
        transformation (float augmentation leaves the 16-bit grid) or a
        video is not mono int16 PCM, so that every batch has one dtype."""
        if any(t != "none" for t in self._transformation):
            logger.warning("GPU.INT16_TRANSFER disabled for EpicKitchens %s: waveform "
                           "transformations present (float-domain augmentation leaves the "
                           "16-bit PCM grid)", self.mode)
            self.int16 = False
            return
        from scipy.io import wavfile

        for video in dict.fromkeys(self._video):
            try:
                _, data = wavfile.read(self._path(video), mmap=True)
            except (FileNotFoundError, ValueError):
                continue  # the item raises the real IO error
            if data.dtype != np.int16 or data.ndim != 1:
                logger.warning("GPU.INT16_TRANSFER disabled for EpicKitchens %s: %s is %s/%dD "
                               "(need mono int16 PCM split-wide)", self.mode, video,
                               data.dtype, data.ndim)
                self.int16 = False
                return

    # -- audio -------------------------------------------------------------
    def _path(self, video: str) -> str:
        return os.path.join(self.audio_dir, f"{video}.wav")

    def _video_len(self, video: str) -> int:
        """Samples in ``video`` (remembered: a chain reads it for every item)."""
        n = self._video_lens.get(video)
        if n is None:
            n = self._video_lens[video] = len(load_wav(self._path(video), keep_int16=True)[0])
        return n

    def _read_region(self, video: str, start: int, end: int) -> np.ndarray:
        """Samples ``[start, end)`` of ``video``, zeros outside the video:
        raw int16 under the int16 transfer, else float32."""
        samples, sr = load_wav(self._path(video), keep_int16=True)
        if sr != self.cfg.AUDIO_DATA.SAMPLING_RATE:
            raise ValueError(f"Audio sampling rate ({sr}) of {video} does not match target "
                             f"({self.cfg.AUDIO_DATA.SAMPLING_RATE})")
        a, b = max(0, start), min(len(samples), end)
        out = np.zeros(end - start, np.int16 if self.int16 else np.float32)
        if b > a:
            chunk = samples[a:b]
            if not self.int16 and chunk.dtype == np.int16:
                chunk = chunk.astype(np.float32) / 32768.0
            out[a - start : b - start] = chunk
        return out

    # -- items -------------------------------------------------------------
    def _views(self, indices: np.ndarray) -> np.ndarray:
        """Each item's view: -1 (a uniform draw) outside the test split."""
        if self.mode == "test":
            return indices % self._num_clips
        return np.full(len(indices), -1, np.int64)

    def _placement(self, index: int, rng) -> tuple[int, int]:
        """(first sample, valid samples) of item ``index``, its start drawn
        from ``rng``: the JAX package's ``_clip_for_record``."""
        row = index // self._num_clips
        start, num = int(self._start[row]), int(self._num[row])
        if num < self.clip_size:
            return start, max(0, num)  # stop <= start annotations give no samples
        start_idx, _ = get_start_end_idx(
            num, self.clip_size, int(self._views(np.asarray([index]))[0]),
            self.cfg.TEST.NUM_ENSEMBLE_VIEWS, start_sample=start, rng=rng,
        )
        return int(start_idx), self.clip_samples

    def _placements(self, epoch: int, indices: np.ndarray):
        """``_placement`` of every item in one call (the JAX package's
        ``get_refs_batch``), each start drawn by ``fast_rng`` as
        ``item_rng(RNG_SEED, epoch, index)`` would draw it."""
        rows = indices // self._num_clips
        start, num = self._start[rows], self._num[rows]
        n_valid = np.maximum(0, num)
        sampled = num >= self.clip_size
        if sampled.any():
            off, _ = get_start_end_idx_batch(
                num[sampled], self.clip_size, self._views(indices[sampled]),
                self.cfg.TEST.NUM_ENSEMBLE_VIEWS, self.cfg.RNG_SEED, epoch, indices[sampled],
            )
            # int(a + u), the sum rounded in float64 first, as the scalar path does
            start = start.copy()
            start[sampled] = np.floor(start[sampled].astype(np.float64) + off).astype(np.int64)
            n_valid[sampled] = self.clip_samples
        return start, n_valid

    def _item(self, index: int, start: int, n_valid: int, rng=None) -> dict:
        """The item of ``index`` whose clip starts at ``start``: ``n_valid``
        samples, transformed where its row says so (drawing from ``rng``),
        zero-padded to ``clip_samples``."""
        row = index // self._num_clips
        wave = np.zeros(self.clip_samples, np.int16 if self.int16 else np.float32)
        region = self._read_region(self._video[row], int(start), int(start) + int(n_valid))
        wave[: len(region)] = self._transform(row, region, rng)[: self.clip_samples]
        return {
            "waveform": wave,
            "n_valid": np.int32(n_valid),
            "label": {k: v[row] for k, v in self._labels.items()},
            "index": index,
            "metadata": {"narration_id": self._narration[row]},
        }

    def _transform(self, row: int, wave: np.ndarray, rng) -> np.ndarray:
        """``wave`` through row ``row``'s transformation (float32), drawing
        from ``rng``; as it is when the row has none."""
        name = self._transformation[row]
        if name != "none" and name in self.transforms:
            return np.asarray(self.transforms[name](wave, self.cfg.AUDIO_DATA.SAMPLING_RATE,
                                                    rng=rng), np.float32)
        return wave

    def __getitem__(self, index: int):
        """Item ``index`` at the epoch of ``set_epoch``, placed and
        transformed by its own ``item_rng``: the definition that
        ``get_batch`` replays."""
        rng = item_rng(self.cfg.RNG_SEED, self._epoch, index)
        return self._item(index, *self._placement(index, rng), rng)

    def get_batch(self, epoch: int, indices) -> list:
        """The items ``indices`` of ``epoch``, each bit for bit what
        ``__getitem__`` gives after ``set_epoch(epoch)``."""
        indices = np.asarray([int(i) for i in indices], np.int64)
        starts, n_valid = self._placements(epoch, indices)
        items = []
        for i, start, n in zip(indices.tolist(), starts, n_valid):
            if self._transformation[i // self._num_clips] != "none":
                rng = item_rng(self.cfg.RNG_SEED, epoch, i)
                items.append(self._item(i, *self._placement(i, rng), rng))
            else:
                items.append(self._item(i, start, n))
        return items

    def __len__(self):
        return len(self._video) * self._num_clips


@register_dataset("EpicKitchensGRU")
class EpicKitchensGRU(EpicKitchens):
    """One chain of windows an item: ``waveform`` (n_windows, clip_samples),
    ``n_valid`` (n_windows,), ``length``, ``noun_embedding`` (512,), labels,
    index and narration id."""

    record_type = EpicKitchensAudioRecordGRU

    def _record_tables(self, records: list) -> None:
        max_nb = self.cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS
        self._n_windows = np.asarray([min(r.num_spectrograms, max_nb) for r in records],
                                     np.int64)
        self._embedding = []
        for r in records:
            emb = r.noun_embedding
            self._embedding.append(emb.astype(np.float32) if emb.size
                                   else np.zeros(512, np.float32))

    def chain_windows(self, indices) -> np.ndarray:
        """The window counts of chains ``indices``, read from the table (no audio)."""
        return self._n_windows[np.asarray(indices, np.int64)]

    def _region(self, row: int) -> tuple[int, int]:
        """(first, end) sample of row ``row``'s covering region: the
        segment of an action shorter than a clip (empty for ``stop <=
        start``), else from the start to the end of its last window."""
        start, num = int(self._start[row]), int(self._num[row])
        if num < self.clip_size:
            return start, max(start, start + num)
        sr = self.cfg.AUDIO_DATA.SAMPLING_RATE
        return start, start + (int(self._n_windows[row]) - 1) * sr + self.clip_size

    def _chain(self, index: int, rng=None) -> dict:
        """The chain of ``index``; a transformed row draws from ``rng``, window by window."""
        row = index
        video, num = self._video[row], int(self._num[row])
        n_windows = int(self._n_windows[row])
        seg_start, region_end = self._region(row)
        region = self._read_region(video, seg_start, region_end)
        vid_len = self._video_len(video)
        sr = self.cfg.AUDIO_DATA.SAMPLING_RATE
        waves = np.zeros((n_windows, self.clip_samples), np.int16 if self.int16 else np.float32)
        n_valid = np.zeros((n_windows,), np.int32)
        for i in range(n_windows):
            if num < self.clip_size:  # every window is the whole segment
                chunk, start_i = region[: max(0, num)], seg_start
            else:
                off = i * sr
                chunk, start_i = region[off : off + self.clip_samples], seg_start + off
            chunk = self._transform(row, chunk, rng)[: self.clip_samples]
            waves[i, : len(chunk)] = chunk
            # Valid samples are those inside the video (the reference's slice
            # stops at its end); at least 1, so that the front end's edge
            # replication has a frame to copy.
            in_video = max(0, min(start_i + len(chunk), vid_len) - start_i)
            n_valid[i] = max(1, min(len(chunk), in_video))
        return {
            "waveform": waves,
            "n_valid": n_valid,
            "length": np.int32(n_windows),
            "label": {k: v[row] for k, v in self._labels.items()},
            "index": index,
            "metadata": {"narration_id": self._narration[row]},
            "noun_embedding": self._embedding[row],
        }

    def __getitem__(self, index: int):
        return self._chain(index, item_rng(self.cfg.RNG_SEED, self._epoch, index))

    def get_batch(self, epoch: int, indices) -> list:
        """The chains ``indices`` of ``epoch``, each bit for bit what
        ``__getitem__`` gives after ``set_epoch(epoch)``; only a transformed
        row makes its generator."""
        return [self._chain(i, item_rng(self.cfg.RNG_SEED, epoch, i)
                            if self._transformation[i] != "none" else None)
                for i in (int(i) for i in indices)]


@register_dataset("EpicKitchensWithPDDL")
class EpicKitchensWithPDDL(EpicKitchens):
    """``EpicKitchens`` whose labels add ``precs`` and ``posts`` (P,) float32."""

    record_type = EpicKitchensAudioRecordWithPDDL


@register_dataset("EpicKitchensGRUwithPDDL")
class EpicKitchensGRUwithPDDL(EpicKitchensGRU):
    """``EpicKitchensGRU`` whose labels add ``precs`` and ``posts`` (P,) float32."""

    record_type = EpicKitchensAudioRecordGRUwithPDDL
