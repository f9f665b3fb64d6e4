"""EPIC-KITCHENS-100 datasets from per-video wav files or an HDF5 archive:
one clip an item (``EpicKitchens``), or one chain of windows an item
(``EpicKitchensGRU``); with PDDL state labels, ``EpicKitchensWithPDDL``
and ``EpicKitchensGRUwithPDDL``.

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

The audio: ``EPICKITCHENS.AUDIO_DATA_FILE`` names either a directory of
mono wav files, ``<video_id>.wav`` (what ``asf_tpu/tools/extract_audio.py``
writes), or a file that starts with the HDF5 signature: the archive of one
dataset a video that ``tools/wav_to_hdf5.py`` writes and the JAX package
reads (``asf_tpu/data/epickitchens.py:147-286``), read here through the
port's own reader (``data/hdf5.py``, no h5py). A mono int16 wav file is
memory-mapped, and a read copies out the clip's pages only
(``vggsound.load_wav``); the archive is memory-mapped too, and a read
copies out the clip's bytes, or inflates the chunks it touches. Each
process parses an archive once (``audio_source``). With
``GPU.HOST_WAVEFORM_CACHE_MB`` above 0 each process that reads keeps a
byte-LRU of whole record segments (``data/cache.py``, as
``asf_tpu/data/epickitchens.py:86-107, 288-320`` does), keyed by the exact
(video, first, end) region: a clip is sliced out of its cached segment, and
a chain reads its covering region through it. A split whose unique segments
exceed the budget keeps none (an over-budget LRU would re-read whole
segments every epoch), with the JAX package's log line.

The int16 transfer (``GPU.INT16_TRANSFER``) is decided for the whole split:
a row with a ``transformation`` (a host augmentation in float,
``data/transforms.py``) turns it off, and so does a video that is not mono
int16 in a wav directory, or, in an archive, a video whose dataset is
neither int16 nor float32 on the 16-bit grid (its first 16 Ki samples and a
16 Ki chunk from its middle, or its whole remainder under three chunks,
``ArchiveAudio.int16_blocker``, as the JAX package's ``_probe_int16``
judges it; verdicts kept per archive file). Under the transfer an archive's
float samples are scaled by 32768, clipped and cast to int16; without it
its int16 samples are scaled by 1/32768.

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
``get_batch`` reads item by item. A test split of chains has one view a row.

The device store's protocol (``data/device_store.py``; the JAX package's
``:379-415, 546-709``), which reads no audio: ``device_store_table`` (each
unique segment and its length; None where a row has a transformation),
``read_segment``, ``ref_seg_keys``, ``ref_batch(epoch, indices)`` (each
item's segment, its clip's offset into it and ``n_valid``, with the batch's
labels, indices and narration ids; drawn as ``get_batch`` draws them) and
``get_ref(index)``, the per-item definition it is held to. A regular row's
segment is its action's samples; a chain's is its covering region, into
which each window is an offset, -1 for an empty chunk and for the bucket's
padding (``n_valid`` 1).

Every key of a record's label is kept as a table of the split's rows and
carried by regular and chain items alike: ``verb`` and ``noun``, and for the
PDDL records ``precs`` and ``posts``, (rows, P) float32 tables of their
rows' ``precs_vec``/``posts_vec`` in {-1, 0, 1}.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..utils.logging import get_logger
from . import hdf5
from .build import register_dataset
from .cache import ByteLRUCache
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


_GRID_PROBE = 16384  # samples an archive's int16 probe reads at a video's head and middle


def _padded(read, n: int, start: int, end: int, int16: bool) -> np.ndarray:
    """Samples ``[start, end)`` of a video of ``n`` samples, zeros outside
    it, as ``asf_tpu/data/epickitchens.py:_read_region`` gives them from
    ``read(a, b)``: with ``int16`` raw int16 (float samples scaled by 32768,
    clipped first), else float32 (int16 samples scaled by 1/32768)."""
    a, b = max(0, start), min(n, end)
    out = np.zeros(end - start, np.int16 if int16 else np.float32)
    if b > a:
        chunk = read(a, b)
        if int16 and chunk.dtype != np.int16:
            chunk = np.clip(chunk.astype(np.float32) * 32768.0, -32768.0,
                            32767.0).astype(np.int16)
        elif not int16 and chunk.dtype == np.int16:
            chunk = chunk.astype(np.float32) / 32768.0
        out[a - start : b - start] = chunk
    return out


class WavAudio:
    """A directory of mono ``<video_id>.wav`` files at ``sr`` Hz."""

    def __init__(self, path: str, sr: int):
        self.path, self.sr = path, sr

    def _file(self, video: str) -> str:
        return os.path.join(self.path, f"{video}.wav")

    def video_len(self, video: str) -> int:
        return len(load_wav(self._file(video), keep_int16=True)[0])

    def region(self, video: str, start: int, end: int, int16: bool) -> np.ndarray:
        samples, sr = load_wav(self._file(video), keep_int16=True)
        if sr != self.sr:
            raise ValueError(f"Audio sampling rate ({sr}) of {video} does not match target "
                             f"({self.sr})")
        return _padded(lambda a, b: samples[a:b], len(samples), start, end, int16)

    def int16_blocker(self, videos) -> str | None:
        """Why ``videos`` cannot take the int16 transfer: the first that is
        not mono int16 PCM; None where all are (a missing file is left to
        the item, which raises the real IO error)."""
        from scipy.io import wavfile

        for video in videos:
            try:
                _, data = wavfile.read(self._file(video), mmap=True)
            except (FileNotFoundError, ValueError):
                continue
            if data.dtype != np.int16 or data.ndim != 1:
                return f"{video} is {data.dtype}/{data.ndim}D (need mono int16 PCM split-wide)"
        return None


class ArchiveAudio:
    """An HDF5 archive of one dataset a video (``data/hdf5.py``), with the
    int16 probe's verdicts of its videos."""

    def __init__(self, path: str):
        self.archive = hdf5.Archive(path)
        self._verdicts: dict = {}  # video -> on the 16-bit grid
        self._lock = threading.Lock()

    def video_len(self, video: str) -> int:
        return self.archive.shape(video)[0]

    def region(self, video: str, start: int, end: int, int16: bool) -> np.ndarray:
        return _padded(lambda a, b: self.archive.read(video, a, b), self.video_len(video),
                       start, end, int16)

    def int16_blocker(self, videos) -> str | None:
        """Why ``videos`` cannot take the int16 transfer: the first whose
        dataset is neither int16 nor float32 on the 16-bit PCM grid (v *
        32768 integral in [-32768, 32767]) over its first ``_GRID_PROBE``
        samples and as many from its middle, or its whole remainder when it
        is under three times that long; None where all can. A video the
        archive lacks is left to the item."""
        for video in videos:
            if video not in self.archive:
                continue
            dtype = self.archive.dtype(video)
            if dtype == np.int16:
                continue
            with self._lock:
                ok = self._verdicts.get(video)
            if ok is None:
                n = self.video_len(video)
                mid = max(0, n // 2 - _GRID_PROBE // 2)
                ok = dtype == np.float32 and _on_grid(self.archive.read(video, 0, _GRID_PROBE))
                if ok:
                    ok = _on_grid(self.archive.read(video, _GRID_PROBE, n) if mid < _GRID_PROBE
                                  else self.archive.read(video, mid, mid + _GRID_PROBE))
                with self._lock:
                    self._verdicts[video] = ok
            if not ok:
                return f"{video} is {dtype} and not on the 16-bit PCM grid"
        return None


def _on_grid(samples: np.ndarray) -> bool:
    v = np.asarray(samples, np.float32) * 32768.0
    return bool(np.all(v == np.rint(v))
                and (v.size == 0 or (v.min() >= -32768.0 and v.max() <= 32767.0)))


# One ArchiveAudio a process for each archive file, keyed by (path, mtime,
# size): the splits of a run share its parse and its verdicts.
_ARCHIVES: dict = {}
_ARCHIVES_LOCK = threading.Lock()


def audio_source(path: str, sr: int):
    """The audio ``EPICKITCHENS.AUDIO_DATA_FILE`` names: ``WavAudio`` for a
    directory, ``ArchiveAudio`` for a file that starts with the HDF5
    signature; anything else raises."""
    if os.path.isdir(path):
        return WavAudio(path, sr)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"EPICKITCHENS.AUDIO_DATA_FILE = {path!r} is neither a "
                                "directory of per-video wav files nor an HDF5 archive")
    if not hdf5.is_hdf5(path):
        raise ValueError(f"EPICKITCHENS.AUDIO_DATA_FILE = {path!r} is a file without the HDF5 "
                         "signature: the port reads an HDF5 archive of one dataset a video, "
                         "or a directory of per-video wav files")
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    with _ARCHIVES_LOCK:
        source = _ARCHIVES.get(key)
        if source is None:
            source = _ARCHIVES[key] = ArchiveAudio(path)
    return source


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
        self.audio = audio_source(cfg.EPICKITCHENS.AUDIO_DATA_FILE,
                                  cfg.AUDIO_DATA.SAMPLING_RATE)
        self._epoch = 0
        self._video_lens: dict = {}
        self._seg_table = None
        self._construct_loader()
        if self.int16:
            self._probe_int16()
        self._seg_cache = self._segment_cache(int(cfg.GPU.HOST_WAVEFORM_CACHE_MB))

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
        transformation (float augmentation leaves the 16-bit grid) or the
        audio source finds a video that cannot take it
        (``int16_blocker``), so that every batch has one dtype."""
        if any(t != "none" for t in self._transformation):
            logger.warning("GPU.INT16_TRANSFER disabled for %s %s: waveform "
                           "transformations present (float-domain augmentation leaves the "
                           "16-bit PCM grid)", type(self).__name__, self.mode)
            self.int16 = False
            return
        reason = self.audio.int16_blocker(dict.fromkeys(self._video))
        if reason is not None:
            logger.warning("GPU.INT16_TRANSFER disabled for %s %s: %s", type(self).__name__,
                           self.mode, reason)
            self.int16 = False

    # -- audio -------------------------------------------------------------
    def _video_len(self, video: str) -> int:
        """Samples in ``video`` (remembered: a chain reads it for every item)."""
        n = self._video_lens.get(video)
        if n is None:
            n = self._video_lens[video] = self.audio.video_len(video)
        return n

    def _read_region(self, video: str, start: int, end: int) -> np.ndarray:
        """Samples ``[start, end)`` of ``video``, zeros outside the video:
        raw int16 under the int16 transfer, else float32 (``_padded``)."""
        return self.audio.region(video, start, end, self.int16)

    # -- segments: the host LRU and the device store ------------------------
    def _segment(self, row: int) -> tuple[int, int]:
        """(first, end) sample of row ``row``'s segment: its action's
        samples, none for ``stop <= start``."""
        start = int(self._start[row])
        return start, start + max(0, int(self._num[row]))

    def _segment_cache(self, cache_mb: int):
        """The LRU of ``cache_mb`` MB, or None: at 0, or where the split's
        unique segments exceed it."""
        if cache_mb <= 0:
            return None
        itemsize = 2 if self.int16 else 4
        segs = {(v, *self._segment(row)) for row, v in enumerate(self._video)}
        ws = sum(b - a for _v, a, b in segs) * itemsize
        if ws > cache_mb << 20:
            logger.info("Host waveform cache disabled for %s %s: segment working set %.0f MB > "
                        "GPU.HOST_WAVEFORM_CACHE_MB=%d (an over-budget LRU re-reads whole record "
                        "segments every epoch — worse than direct clip reads)",
                        type(self).__name__, self.mode, ws / 2**20, cache_mb)
            return None
        return ByteLRUCache(cache_mb << 20)

    def _cached_region(self, video: str, start: int, end: int) -> np.ndarray:
        """``_read_region`` through the LRU, keyed by the exact region; a
        read-only array."""
        if self._seg_cache is None:
            return self._read_region(video, start, end)
        key = (video, start, end)
        arr = self._seg_cache.get(key)
        if arr is None:
            arr = self._read_region(video, start, end)
            self._seg_cache.put(key, arr)
        return arr

    def _store_segment(self, row: int) -> tuple[int, int]:
        """(first, end) sample of the stored segment that holds row ``row``'s clips."""
        return self._segment(row)

    def _segment_table(self):
        """(each row's index into the unique stored segments, those segments
        as (video, first, end) in order, each row's segment's first sample)."""
        if self._seg_table is None:
            key_of, seg_of, first = {}, [], []
            for row, video in enumerate(self._video):
                a, b = self._store_segment(row)
                seg_of.append(key_of.setdefault((video, a, b), len(key_of)))
                first.append(a)
            self._seg_table = (np.asarray(seg_of, np.int64), list(key_of),
                               np.asarray(first, np.int64))
        return self._seg_table

    def device_store_table(self, budget_samples=None):
        """((video, first, end), samples) of each unique stored segment, or
        None where a row has a transformation (the store gathers raw samples)."""
        if any(t != "none" for t in self._transformation):
            return None
        return [(key, key[2] - key[1]) for key in self._segment_table()[1]]

    def read_segment(self, key) -> np.ndarray:
        video, a, b = key
        return self._read_region(video, a, b)

    def ref_seg_keys(self) -> list:
        """The stored segments in the order ``ref_batch``'s ``seg_idx`` indexes."""
        return self._segment_table()[1]

    def _ref_rest(self, indices: np.ndarray, rows: np.ndarray) -> dict:
        return {"labels": {k: v[rows] for k, v in self._labels.items()}, "index": indices,
                "metadata": {"narration_id": [self._narration[r] for r in rows]}}

    def ref_batch(self, epoch: int, indices) -> dict:
        """The refs of items ``indices`` of ``epoch``, with no audio read:
        ``seg_idx`` into ``ref_seg_keys()``, ``clip_off`` into it,
        ``n_valid``, labels, indices and narration ids; each clip placed as
        ``get_batch`` places it."""
        indices = np.asarray(indices, np.int64)
        rows = indices // self._num_clips
        seg_of, _keys, first = self._segment_table()
        start, n_valid = self._placements(epoch, indices)
        return {"seg_idx": seg_of[rows], "clip_off": start - first[rows],
                "n_valid": n_valid.astype(np.int32), **self._ref_rest(indices, rows)}

    def get_ref(self, index: int) -> dict:
        """Item ``index``'s ref at the epoch of ``set_epoch``: its segment's
        key, its clip's offset into it and ``n_valid``, placed by its own
        ``item_rng``, as ``__getitem__`` places it."""
        row = index // self._num_clips
        start, n_valid = self._placement(index, item_rng(self.cfg.RNG_SEED, self._epoch, index))
        a, b = self._store_segment(row)
        return {"seg_key": (self._video[row], a, b), "clip_off": start - a,
                "n_valid": np.int32(n_valid),
                "label": {k: v[row] for k, v in self._labels.items()}, "index": index,
                "metadata": {"narration_id": self._narration[row]}}

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
        start, n_valid = int(start), int(n_valid)
        wave = np.zeros(self.clip_samples, np.int16 if self.int16 else np.float32)
        if self._seg_cache is not None:  # the clip lies inside its record's segment
            first, end = self._segment(row)
            region = self._cached_region(self._video[row], first, end)
            region = region[start - first : start - first + n_valid]
        else:
            region = self._read_region(self._video[row], start, start + n_valid)
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

    def _segment(self, row: int) -> tuple[int, int]:
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
        seg_start, region_end = self._segment(row)
        region = self._cached_region(video, seg_start, region_end)
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

    def _row_video_lens(self) -> np.ndarray:
        lens = getattr(self, "_row_vid_lens", None)
        if lens is None:
            lens = self._row_vid_lens = np.asarray([self._video_len(v) for v in self._video],
                                                   np.int64)
        return lens

    def _windows(self, rows: np.ndarray, nb: int) -> tuple[np.ndarray, np.ndarray]:
        """(offsets, n_valid) (rows, nb) of the windows of chains ``rows``
        into their covering regions, as ``_chain`` places them; -1 and
        ``n_valid`` 1 for an empty chunk and for windows past the chain."""
        num, nw = self._num[rows][:, None], self._n_windows[rows][:, None]
        w = np.arange(nb, dtype=np.int64)[None, :]
        short = num < self.clip_size
        chunk = np.where(short, np.maximum(0, num), self.clip_samples)
        offs = np.where(short, 0, w * self.cfg.AUDIO_DATA.SAMPLING_RATE)
        start = self._start[rows][:, None] + offs
        in_video = np.maximum(0, np.minimum(start + chunk, self._row_video_lens()[rows][:, None])
                              - start)
        dead = (chunk == 0) | (w >= nw)
        n_valid = np.where(dead, 1, np.maximum(1, np.minimum(chunk, in_video)))
        return np.where(dead, -1, offs), n_valid.astype(np.int32)

    def ref_batch(self, epoch: int, indices) -> dict:
        """The refs of chains ``indices`` (no random draw): ``seg_idx``,
        ``window_offs`` and ``n_valid`` (B, MAX_NB_SPECTROGRAMS), ``lengths``,
        ``noun_embedding``, labels, indices and narration ids."""
        rows = np.asarray(indices, np.int64)
        offs, n_valid = self._windows(rows, int(self.cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS))
        return {"seg_idx": self._segment_table()[0][rows], "window_offs": offs,
                "n_valid": n_valid, "lengths": self._n_windows[rows].astype(np.int32),
                "noun_embedding": np.stack([self._embedding[r] for r in rows]),
                **self._ref_rest(rows, rows)}

    def get_ref(self, index: int) -> dict:
        """Chain ``index``'s ref: its covering region's key, each window's
        offset into it (-1 for an empty chunk) and ``n_valid``."""
        n = int(self._n_windows[index])
        offs, n_valid = self._windows(np.asarray([index]), n)
        a, b = self._segment(index)
        return {"seg_key": (self._video[index], a, b), "window_offs": offs[0],
                "n_valid": n_valid[0], "length": np.int32(n),
                "label": {k: v[index] for k, v in self._labels.items()}, "index": index,
                "metadata": {"narration_id": self._narration[index]},
                "noun_embedding": self._embedding[index]}

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
